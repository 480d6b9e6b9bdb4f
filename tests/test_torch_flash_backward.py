"""The port's attention backward (`voicebox_tpu_torch.ops.flash_attention`)
against the JAX package, on the CPU in float32.

`reference_attention_backward`, the plain version of K2 + K3, is held
against the Pallas backward kernels (interpret mode) on rows with at least
one real key, and against autograd of the port's `reference_attention` on
every row, a fully-masked batch element included: there the JAX kernels
give NaN, and the plain softmax gives dq = dk = 0 and dv = sum(dO) / kv.
The autograd Function around the kernels is exercised here with its three
launches swapped for their plain versions; K1, K2 and K3 themselves run
only on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebox_tpu.ops.flash_attention import _flash_backward, _flash_forward
from voicebox_tpu_torch.ops import flash_attention as fa
from voicebox_tpu_torch.ops.flash_attention import (
    attention_delta,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    reference_attention,
    reference_attention_backward,
)

ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, b, h, n, kv, d, empty_batch=None):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, n, d).astype(np.float32)
    k = rs.randn(b, h, kv, d).astype(np.float32)
    v = rs.randn(b, h, kv, d).astype(np.float32)
    do = rs.randn(b, h, n, d).astype(np.float32)
    mask = rs.rand(b, kv) < 0.8  # as tests/test_ops.py::TestFlashKernelInterpret
    mask[:, :4] = True
    if empty_batch is not None:
        mask[empty_batch] = False
    return q, k, v, do, mask


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("n,kv,d", [
    (200, 200, 64),   # ragged against the 128 blocks
    (200, 200, 128),
    (70, 130, 64),    # n != kv
])
def test_plain_backward_matches_pallas_interpret(n, kv, d):
    q, k, v, do, mask = _inputs(0, 2, 2, n, kv, d)
    scale = d ** -0.5
    jq, jk, jv, jdo, jmask = (jnp.asarray(a) for a in (q, k, v, do, mask))
    out, lse = _flash_forward(jq, jk, jv, jmask, scale, 128, 128, return_lse=True,
                              interpret=True)
    ref = _flash_backward(jq, jk, jv, jmask, out, lse, jdo, scale, 128, 128,
                          interpret=True)
    got = reference_attention_backward(
        *_t(q, k, v, mask, np.asarray(out), np.asarray(lse), do), scale=scale
    )
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0, err_msg=name)


def _autograd(q, k, v, mask, do, scale):
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = reference_attention(q, k, v, mask, scale)
    out.backward(do)
    return q.grad, k.grad, v.grad


@pytest.mark.parametrize("scale", [None, 10.0])
def test_plain_backward_matches_autograd_every_row(scale):
    # batch element 1 has every key masked: its rows are fully masked
    q, k, v, do, mask = _t(*_inputs(1, 3, 2, 40, 56, 16, empty_batch=1))
    if scale is not None:  # qk-normed operands, as the denoiser calls attention
        q, k = (t / t.norm(dim=-1, keepdim=True) * 4 ** 0.5 for t in (q, k))
    out, lse = reference_attention(q, k, v, mask, scale, return_lse=True)
    got = reference_attention_backward(q, k, v, mask, out, lse, do, scale)
    ref = _autograd(q, k, v, mask, do, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-5, msg=name)
    dq, dk, dv = got
    assert torch.count_nonzero(dq[1]) == 0 and torch.count_nonzero(dk[1]) == 0
    torch.testing.assert_close(dv[1], do[1].sum(dim=1, keepdim=True).expand_as(dv[1]) / 56,
                               atol=1e-5, rtol=1e-5)


def test_jax_flash_backward_is_not_finite_on_fully_masked_rows():
    """The divergence the port does not follow (ROADMAP Queue 3): the JAX
    Pallas backward computes exp(s - lse) * keep, and on a fully-masked row
    (lse = -2.38e38) exp overflows to inf and inf * 0 gives NaN."""
    q, k, v, do, mask = _inputs(2, 2, 2, 200, 200, 64, empty_batch=1)
    scale = 64 ** -0.5
    jq, jk, jv, jdo, jmask = (jnp.asarray(a) for a in (q, k, v, do, mask))
    out, lse = _flash_forward(jq, jk, jv, jmask, scale, 128, 128, return_lse=True,
                              interpret=True)
    dq, dk, dv = (np.asarray(g) for g in _flash_backward(
        jq, jk, jv, jmask, out, lse, jdo, scale, 128, 128, interpret=True))
    assert not np.isfinite(dq[1]).all() and not np.isfinite(dv[1]).all()
    got = reference_attention_backward(
        *_t(q, k, v, mask, np.asarray(out), np.asarray(lse), do), scale=scale
    )
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for a, b in zip(got, (dq, dk, dv)):  # the other batch element agrees
        np.testing.assert_allclose(a[0].numpy(), b[0], atol=ATOL, rtol=0)


def test_cpu_wrappers_take_the_plain_path_without_launching():
    q, k, v, do, mask = _t(*_inputs(3, 2, 2, 33, 40, 64, empty_batch=0))
    out, lse = reference_attention(q, k, v, mask, return_lse=True)
    delta = attention_delta(do, out)
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    dq = flash_attention_bwd_dq(q, k, v, mask, do, lse, delta, 0.125)
    dk, dv = flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta, 0.125)
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == before
    ref = reference_attention_backward(q, k, v, mask, out, lse, do, 0.125)
    for a, b in zip((dq, dk, dv), ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_autograd_function_wires_k1_k2_k3(monkeypatch):
    """The Function's forward saves out and lse and its backward runs delta
    -> K2 -> K3 on them; here K1 is swapped for its plain version, and K2
    and K3 take theirs because the tensors lie on the CPU."""
    calls = []

    def plain_k1(q, k, v, mask, scale):
        calls.append("k1")
        return reference_attention(q, k, v, mask, scale, return_lse=True)

    monkeypatch.setattr(fa, "_launch_k1", plain_k1)
    q, k, v, do, mask = _t(*_inputs(4, 2, 2, 24, 30, 64, empty_batch=1))
    q, k = (t / t.norm(dim=-1, keepdim=True) * 2.0 for t in (q, k))  # logits up to 40
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = fa._FlashAttention.apply(*leaves, mask, 10.0)
    assert calls == ["k1"] and not lse.requires_grad
    out.backward(do)
    ref = _autograd(q, k, v, mask, do, 10.0)
    # gradients reach ~50 at scale 10: atol 1e-4 is 2e-6 of that
    for name, a, b in zip(("dq", "dk", "dv"), (t.grad for t in leaves), ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5, msg=name)


def test_cpu_autograd_runs_through_the_plain_forward():
    q, k, v, do, mask = _t(*_inputs(5, 1, 2, 16, 16, 64))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention(*leaves, mask).backward(do)
    for a, b in zip((t.grad for t in leaves), _autograd(q, k, v, mask, do, None)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_backward_wrappers_raise_off_the_card():
    q = torch.empty(1, 1, 8, 64, device="meta")
    lse = torch.empty(1, 1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_dq(q, q, q, None, q, lse, lse, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_dkv(q, q, q, None, q, lse, lse, 1.0)
