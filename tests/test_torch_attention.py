"""The port's attention (`voicebox_tpu_torch.ops.flash_attention`,
`models.attention`) against the JAX package, on the CPU in float32.

The plain version is held against the Pallas kernel (interpret mode) on rows
with at least one real key, and against the JAX `reference_attention` on
every row, a fully-masked one included. K1 itself runs only on the card:
`tests/test_torch_cuda.py` and `chip_smoke.py` hold it against the plain
version there.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebox_tpu.models.attention import Attention as JaxAttention
from voicebox_tpu.models.primitives import rotary_frequencies
from voicebox_tpu.ops.flash_attention import _flash_forward
from voicebox_tpu.ops.flash_attention import reference_attention as jax_reference_attention
from voicebox_tpu_torch.models.attention import Attention
from voicebox_tpu_torch.ops import flash_attention as fa
from voicebox_tpu_torch.ops.flash_attention import (
    HEAD_DIMS,
    MASK_FILL,
    flash_attention,
    k1_block_q,
    reference_attention,
)
from voicebox_tpu_torch.utils.convert import attention_state_dict

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


def _inputs(seed, b, h, n, kv, d, masked_frac=0.3, empty_batch=None):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, n, d).astype(np.float32)
    k = rs.randn(b, h, kv, d).astype(np.float32)
    v = rs.randn(b, h, kv, d).astype(np.float32)
    mask = rs.rand(b, kv) >= masked_frac
    mask[:, 0] = True  # at least one real key per row
    if empty_batch is not None:
        mask[empty_batch] = False
    return q, k, v, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n,kv,d,scale", [
    (200, 200, 32, None),   # ragged against the 128 blocks
    (70, 130, 16, 10.0),    # n != kv, the qk-norm scale
    (128, 256, 64, None),   # block multiples
])
def test_plain_matches_pallas_kernel_interpret(n, kv, d, scale):
    q, k, v, mask = _inputs(0, 2, 2, n, kv, d)
    s = d ** -0.5 if scale is None else scale
    out_j, lse_j = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), s,
        block_q=128, block_k=128, return_lse=True, interpret=True,
    )
    out_t, lse_t = reference_attention(*_t(q, k, v, mask), scale=scale, return_lse=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL, rtol=1e-5)
    assert lse_t.shape == (2, 2, 1, n)


@pytest.mark.parametrize("scale", [None, 10.0])
def test_plain_matches_jax_reference_every_row(scale):
    # batch element 1 has every key masked: its rows are fully masked
    q, k, v, mask = _inputs(1, 3, 2, 40, 56, 16, empty_batch=1)
    ref = jax_reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), scale
    )
    out, lse = flash_attention(*_t(q, k, v, mask), scale=scale, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    # the fully-masked rows are mean(V) over the real keys, lse = fill + log(kv)
    np.testing.assert_allclose(
        out[1].numpy(), np.broadcast_to(v[1].mean(axis=1, keepdims=True), out[1].shape),
        atol=1e-5,
    )
    np.testing.assert_allclose(lse[1].numpy(), MASK_FILL + np.log(56.0), rtol=1e-6)


def _jax_attention_case(qk_norm, seed=3):
    dim, h, d, b, n = 32, 2, 16, 2, 24
    rs = np.random.RandomState(seed)
    mod = JaxAttention(dim=dim, dim_head=d, heads=h, qk_norm=qk_norm)
    x = rs.randn(b, n, dim).astype(np.float32)
    mask = rs.rand(b, n) > 0.25
    mask[:, 0] = True
    rotary = rotary_frequencies(jnp.arange(n) - 3, d)
    params = mod.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    # perturb every leaf so that identity-initialised gains cannot hide a bug
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * rs.randn(*np.shape(p)).astype(np.float32), params
    )
    out = mod.apply({"params": params}, jnp.asarray(x), mask=jnp.asarray(mask),
                    rotary_emb=rotary)
    return params, x, mask, np.asarray(rotary), np.asarray(out), (dim, h, d)


@pytest.mark.parametrize("qk_norm", [True, False])
def test_attention_module_matches_jax(qk_norm):
    params, x, mask, rotary, ref, (dim, h, d) = _jax_attention_case(qk_norm)
    port = Attention(dim, dim_head=d, heads=h, qk_norm=qk_norm)
    port.load_state_dict(attention_state_dict(params), strict=True)
    with torch.no_grad():
        out = port(*_t(x, mask), rotary_emb=torch.from_numpy(rotary))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_path_without_launching():
    q, k, v, mask = _t(*_inputs(4, 1, 2, 33, 33, 64))
    before = flash_attention.launches
    out = flash_attention(q, k, v, mask)
    assert flash_attention.launches == before
    torch.testing.assert_close(out, reference_attention(q, k, v, mask), rtol=0, atol=0)


def test_other_devices_raise():
    q = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no attention path"):
        flash_attention(q, q, q)


H100_SMS = 132


@pytest.mark.parametrize("b,h,n,d,dtype,rows", [
    (2, 4, 272, 128, torch.bfloat16, 64),    # the engine's batch 1: 24 blocks of 128 rows
    (2, 4, 766, 128, torch.bfloat16, 64),    # serving: 48 blocks of 128 rows
    (4, 4, 528, 128, torch.bfloat16, 128),   # the engine's batch 2: 80 blocks of 128 rows
    (8, 4, 768, 128, torch.bfloat16, 128),   # training: 192
    (8, 4, 1040, 128, torch.bfloat16, 128),  # the engine's batch 4: 288
    (2, 16, 1040, 64, torch.bfloat16, 64),   # the reference's 16 x 64 heads
    (8, 4, 600, 128, torch.bfloat16, 128),   # the masked-tile check: 160
    (1, 4, 4100, 128, torch.bfloat16, 128),  # the long-kv check: 132
    (1, 4, 40, 64, torch.bfloat16, 64),      # n under one tile
    (3, 1, 1, 128, torch.bfloat16, 64),      # one query row
    (1, 8, 32, 64, torch.float32, 16),       # the duration predictor, batch 1 to 4
    (2, 8, 64, 64, torch.float32, 16),
    (4, 8, 128, 64, torch.float32, 16),
    (2, 4, 766, 128, torch.float32, 16),     # fp32 slices of larger grids
    (8, 16, 1040, 64, torch.float32, 16),
    (4, 4, 123, 32, torch.float32, 16),      # the quality canaries' narrow heads
    (4, 4, 7, 16, torch.float32, 16),
    (8, 2, 768, 256, torch.bfloat16, 128),   # 2 x 256 heads, training: 96 blocks of 128 rows
    (2, 2, 766, 256, torch.bfloat16, 64),    # 2 x 256 heads, serving: 24 blocks of 128 rows
    (8, 2, 128, 256, torch.float32, 16),     # the duration predictor at 2 x 256 heads
    (8, 2, 768, 512, torch.bfloat16, 64),    # 2 x 512 heads: the chunked kernel's one height
    (2, 2, 766, 512, torch.bfloat16, 64),
    (2, 1, 128, 512, torch.float32, 16),     # the small fp32 denoiser at 1 x 512 heads
])
def test_k1_tile_height_at_the_paths_shapes(b, h, n, d, dtype, rows):
    assert k1_block_q(b, h, n, d, dtype, H100_SMS) == rows


def _entry_head_dims(source: str) -> dict:
    """{dtype: head dims} the C entry points of `csrc/<source>` launch: a
    `head_dim == D` branch without a dtype serves both, one with `dtype ==
    0` (float32) or 1 (bfloat16) that dtype alone."""
    src = (pathlib.Path(fa.__file__).parents[1] / "csrc" / source).read_text()
    body = src[src.index('extern "C"'):]
    found = {torch.float32: set(), torch.bfloat16: set()}
    for d, dtype in re.findall(r"head_dim == (\d+)(?: && dtype == (\d))?", body):
        for t, code in ((torch.float32, "0"), (torch.bfloat16, "1")):
            if dtype in ("", code):
                found[t].add(int(d))
    return {t: tuple(sorted(v)) for t, v in found.items()}


@pytest.mark.parametrize("source", ["flash_attention_fwd.cu", "flash_attention_bwd.cu"])
def test_head_dims_follow_the_per_dtype_rule(source):
    """fp32 K1, K2 and K3 take head dims 16, 32, 64, 128 and 256, bf16 64,
    128 and 256: the wrappers' rule (`HEAD_DIMS`) is what the C entry points
    launch."""
    assert HEAD_DIMS == {torch.float32: (16, 32, 64, 128, 256),
                         torch.bfloat16: (64, 128, 256)}
    assert _entry_head_dims(source) == HEAD_DIMS


def _plain_kernels(monkeypatch):
    """The kernels' plain versions in the kernels' places, each call's head
    dim and scale recorded: the padded route then runs on the CPU."""
    calls = []

    def k1(q, k, v, mask, scale, block_q=None):
        calls.append(("k1", q.shape[-1], k.shape[-1], v.shape[-1], scale))
        return reference_attention(q, k, v, mask, scale, return_lse=True)

    def k2(q, k, v, mask, do, lse, delta, scale):
        calls.append(("k2", q.shape[-1], do.shape[-1], scale))
        return fa._plain_backward(q, k, v, mask, lse, do, delta, scale)[0]

    def k3(q, k, v, mask, do, lse, delta, scale):
        calls.append(("k3", q.shape[-1], do.shape[-1], scale))
        return fa._plain_backward(q, k, v, mask, lse, do, delta, scale)[1:]

    for name, fn in (("_k1_kernel", k1), ("_k2_kernel", k2), ("_k3_kernel", k3)):
        monkeypatch.setattr(fa, name, fn)
    return calls


@pytest.mark.parametrize("d,dtype,width", [
    (16, torch.bfloat16, 64), (32, torch.bfloat16, 64), (48, torch.bfloat16, 64),
    (8, torch.float32, 16), (24, torch.float32, 32),
    (192, torch.bfloat16, 256), (256, torch.bfloat16, 256),
    (192, torch.float32, 256), (256, torch.float32, 256),
    # past 256: the next multiple of 64, the chunked kernels' widths (a
    # padded width under ~384 columns: past that the CPU's BLAS sums the
    # stand-in's logits in blocks that the zero columns move, so padded and
    # unpadded plain products differ in rounding order, not in the wrapper)
    (300, torch.bfloat16, 320), (576, torch.bfloat16, 576),
    (300, torch.float32, 320), (1024, torch.float32, 1024),
])
def test_padded_head_dims_equal_the_plain_version_exactly(monkeypatch, d, dtype, width):
    """Head dims the kernels are not built for are zero-padded to the next
    width they are (`kernel_head_dim`) and sliced back: with the plain
    version standing in for each kernel, out, lse, dq, dk and dv equal the
    plain version at the true d bit for bit, masked, ragged and with a
    fully-masked row, the scale taken from the true d."""
    calls = _plain_kernels(monkeypatch)
    q, k, v, mask = _inputs(11 + d, 3, 2, 37, 29, d, empty_batch=2)
    do = np.random.RandomState(d).randn(*q.shape).astype(np.float32)
    q, k, v, do = (torch.from_numpy(t).to(dtype) for t in (q, k, v, do))
    mask = torch.from_numpy(mask)
    assert fa.kernel_head_dim(d, dtype) == width
    out, lse = fa._launch_k1(q, k, v, mask, None)
    ref, ref_lse = reference_attention(q, k, v, mask, return_lse=True)
    delta = fa.attention_delta(do, out)
    dq = fa._k2(q, k, v, mask, do, lse, delta, None)
    dk, dv = fa._k3(q, k, v, mask, do, lse, delta, None)
    want = fa._plain_backward(q, k, v, mask, ref_lse, do, fa.attention_delta(do, ref), None)
    for name, got, ref_ in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, dq, dk, dv),
                               (ref, ref_lse, *want)):
        assert got.shape == ref_.shape and got.dtype == ref_.dtype, name
        assert got.is_contiguous(), name
        assert torch.equal(got, ref_), name
    assert calls == [("k1", width, width, width, d ** -0.5), ("k2", width, width, d ** -0.5),
                     ("k3", width, width, d ** -0.5)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_dims_past_128_are_refused(monkeypatch, dtype):
    """No head dim is refused any more: past the widest built width (256)
    every wrapper pads to the next multiple of 64 and launches the chunked
    kernels there, at the true d's scale; the operand check takes the
    built widths and the multiples of 64 past 256, and no other width."""
    calls = _plain_kernels(monkeypatch)
    q = torch.zeros(1, 1, 4, 257, dtype=dtype)
    lse = torch.zeros(1, 1, 1, 4)
    out, lse = fa._launch_k1(q, q, q, None, None)
    assert out.shape == q.shape
    fa._k2(q, q, q, None, q, lse, lse.reshape(1, 1, 4), None)
    fa._k3(q, q, q, None, q, lse, lse.reshape(1, 1, 4), None)
    assert calls == [("k1", 320, 320, 320, 257 ** -0.5), ("k2", 320, 320, 257 ** -0.5),
                     ("k3", 320, 320, 257 ** -0.5)]
    assert [fa._launches_at(d, dtype) for d in (256, 257, 300, 320, 384, 576, 1024)] == [
        True, False, False, True, True, True, True]
    assert [fa.kernel_head_dim(d, dtype) for d in (1, 64, 65, 128, 129, 256)] == (
        [64, 64, 128, 128, 256, 256] if dtype == torch.bfloat16
        else [16, 64, 128, 128, 256, 256])
