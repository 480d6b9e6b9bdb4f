"""Head dims past 128 in the port, against the JAX package, on the CPU.

* `kernel_head_dim` pads a head dim in (128, 256] to 256, the width K1, K2
  and K3 are built for, and one past 256 to the next multiple of 64, the
  widths the chunked kernels take;
* the plain forward and backward (`reference_attention`,
  `reference_attention_backward`), which the kernels are held to on the
  card, match the JAX Pallas kernels `_flash_forward` / `_flash_backward` in
  interpret mode at d = 256, at ragged n and kv, and at d = 320, 512 and
  1024, with and without a mask;
* the port's `Transformer` and `VoiceBox` at `dim_head=256` and 512 (depth
  2, tiny widths) match the JAX modules through `utils/convert.py`: the
  forward within atol 2e-4, and every parameter's gradient of one fixed
  loss (the mean of the output weighted by fixed normals) with a cosine
  above 0.999 and within atol 2e-3.

The kernels themselves run only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`); on CPU tensors the wrappers take the plain versions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_transformer import _perturbed, _xla_inv_freq
from voicebox_tpu import VoiceBox as JaxVoiceBox
from voicebox_tpu.models.transformer import Transformer as JaxTransformer
from voicebox_tpu.ops.flash_attention import _flash_backward, _flash_forward
from voicebox_tpu_torch import VoiceBox
from voicebox_tpu_torch.models.transformer import Transformer
from voicebox_tpu_torch.ops import flash_attention as fa
from voicebox_tpu_torch.ops.flash_attention import (
    reference_attention,
    reference_attention_backward,
)
from voicebox_tpu_torch.utils.convert import transformer_state_dict, voicebox_state_dict

ATOL = 2e-4  # forward, as every port-vs-JAX comparison on the CPU
GRAD_ATOL, GRAD_COS = 2e-3, 0.999
D = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [129, 192, 256])
def test_kernel_head_dim_pads_wide_heads_to_256(d, dtype):
    assert fa.kernel_head_dim(d, dtype) == 256


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_head_dim_refuses_past_256(dtype):
    """Past 256 nothing is refused any more: a head dim launches the chunked
    kernels at the next multiple of 64 (itself if it is one)."""
    assert [fa.kernel_head_dim(d, dtype) for d in (257, 300, 320, 512, 513, 576, 1000, 1024)] == [
        320, 320, 320, 512, 576, 576, 1024, 1024]
    assert fa.WIDE_STEP == 64


def _attention_inputs(seed, b, h, n, kv, masked, d=D):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, n, d).astype(np.float32)
    k = rs.randn(b, h, kv, d).astype(np.float32)
    v = rs.randn(b, h, kv, d).astype(np.float32)
    do = rs.randn(b, h, n, d).astype(np.float32)
    mask = rs.rand(b, kv) < 0.8 if masked else np.ones((b, kv), bool)
    mask[:, :4] = True  # at least one real key per row: the Pallas kernels' domain
    return q, k, v, do, mask


# ragged n and kv against the Pallas kernels' 128-row blocks, n != kv, at
# d = 256; the widths past 256 at one shape (interpret mode costs seconds a
# width)
SHAPES = [pytest.param(D, n, kv, id=f"{n}-{kv}") for n, kv in ((40, 40), (70, 130), (131, 57))]
SHAPES += [pytest.param(d, 40, 40, id=f"d{d}-40-40") for d in (320, 512, 1024)]


@functools.lru_cache(maxsize=None)
def _pallas(d, n, kv, masked):
    q, k, v, do, mask = _attention_inputs(n + kv + d, 1, 2, n, kv, masked, d)
    scale = d ** -0.5
    jq, jk, jv, jdo, jmask = (jnp.asarray(a) for a in (q, k, v, do, mask))
    out, lse = _flash_forward(jq, jk, jv, jmask, scale, 128, 128, return_lse=True,
                              interpret=True)
    grads = _flash_backward(jq, jk, jv, jmask, out, lse, jdo, scale, 128, 128, interpret=True)
    return (q, k, v, do, mask), np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("d,n,kv", SHAPES)
def test_plain_forward_matches_pallas_interpret_at_d256(d, n, kv, masked):
    """At d = 256 and, where the id names it, past 256."""
    (q, k, v, _, mask), out_j, lse_j, _ = _pallas(d, n, kv, masked)
    out, lse = reference_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                                   return_lse=True)
    np.testing.assert_allclose(out.numpy(), out_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("d,n,kv", SHAPES)
def test_plain_backward_matches_pallas_interpret_at_d256(d, n, kv, masked):
    """At d = 256 and, where the id names it, past 256."""
    (q, k, v, do, mask), out_j, lse_j, grads_j = _pallas(d, n, kv, masked)
    got = reference_attention_backward(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, mask, out_j, lse_j, do)),
        scale=d ** -0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, grads_j):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0, err_msg=name)


def _grads_agree(port_module, jax_grads_sd):
    """Every parameter's gradient in the port against the JAX one converted
    to the port's layout: cosine > GRAD_COS and |difference| <= GRAD_ATOL."""
    params = dict(port_module.named_parameters())
    assert set(params) <= set(jax_grads_sd)
    for name, p in params.items():
        a, b = p.grad.double().flatten(), jax_grads_sd[name].double().flatten()
        cos = (a @ b).item() / max(a.norm().item() * b.norm().item(), 1e-30)
        diff = (a - b).abs().max().item()
        assert diff <= GRAD_ATOL, (name, diff)
        assert cos > GRAD_COS or b.norm().item() < 1e-6, (name, cos)


def test_transformer_at_dim_head_256_matches_jax():
    _transformer_matches_jax(D)


def test_transformer_at_dim_head_512_matches_jax():
    """The chunked kernels' width on the card: two 256-column chunks."""
    _transformer_matches_jax(512)


def _transformer_matches_jax(dim_head):
    dim, depth, h, n_reg, cond_dim, n = 32, 2, 2, 2, 24, 20
    rs = np.random.RandomState(21)
    x = rs.randn(2, n, dim).astype(np.float32)
    mask = rs.rand(2, n) > 0.3
    mask[:, 0] = True
    cond = rs.randn(2, cond_dim).astype(np.float32)
    w = rs.randn(2, n, dim).astype(np.float32) / (2 * n * dim)  # the loss: mean(out * w)
    kw = dict(dim=dim, depth=depth, dim_head=dim_head, heads=h, num_register_tokens=n_reg,
              adaptive_rmsnorm=True, adaptive_rmsnorm_cond_dim_in=cond_dim, attn_qk_norm=True)
    mod = JaxTransformer(**kw)
    jx, jmask, jcond = jnp.asarray(x), jnp.asarray(mask), jnp.asarray(cond)
    params = mod.init(jax.random.PRNGKey(0), jx, mask=jmask, adaptive_rmsnorm_cond=jcond)["params"]
    params = _perturbed(params, rs)

    def loss(p):
        out = mod.apply({"params": p}, jx, mask=jmask, adaptive_rmsnorm_cond=jcond)
        return (out * w).sum(), out

    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(params)
    port = Transformer(**kw)
    port.load_state_dict(_xla_inv_freq(transformer_state_dict(params)), strict=True)
    out = port(torch.from_numpy(x), mask=torch.from_numpy(mask),
               adaptive_rmsnorm_cond=torch.from_numpy(cond))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    _grads_agree(port, transformer_state_dict(jax.tree.map(np.asarray, grads),
                                              dim_head=dim_head))


def test_voicebox_at_dim_head_256_matches_jax():
    _voicebox_matches_jax(D)


def test_voicebox_at_dim_head_512_matches_jax():
    _voicebox_matches_jax(512)


def _voicebox_matches_jax(dim_head):
    b, n, d_in, n_tokens = 2, 20, 16, 30
    kw = dict(dim_in=d_in, num_cond_tokens=n_tokens, dim_cond_emb=16, dim=32, depth=2,
              dim_head=dim_head, heads=2, num_register_tokens=2, attn_qk_norm=True)
    jvb = JaxVoiceBox(**kw)
    rs = np.random.RandomState(22)
    params = jax.jit(functools.partial(jvb.init, cond_drop_prob=0.0))(
        {"params": jax.random.PRNGKey(22)}, jnp.zeros((b, n, d_in)), times=jnp.zeros((b,)),
        cond=jnp.zeros((b, n, d_in)), cond_token_ids=jnp.zeros((b, n), jnp.int32),
    )["params"]
    params = _perturbed(params, rs)
    x, cond = (rs.randn(b, n, d_in).astype(np.float32) for _ in range(2))
    times = rs.rand(b).astype(np.float32)
    ids = rs.randint(0, n_tokens, (b, n)).astype(np.int32)
    cond_mask = rs.rand(b, n) < 0.5
    w = rs.randn(b, n, d_in).astype(np.float32) / (b * n * d_in)  # the loss: mean(out * w)
    inputs = dict(times=times, cond=cond, cond_token_ids=ids, cond_mask=cond_mask)

    def loss(p):
        out = jvb.apply({"params": p}, jnp.asarray(x), cond_drop_prob=0.0, train=False,
                        **{k: jnp.asarray(v) for k, v in inputs.items()})
        return (out * w).sum(), out

    # eager, as `_xla_inv_freq`'s table is: under jit XLA folds the rotary
    # table into other values, which moves the registers' angles
    (_, ref), grads = jax.value_and_grad(loss, has_aux=True)(params)
    port = VoiceBox(**kw)
    port.load_state_dict(_xla_inv_freq(voicebox_state_dict(params), "transformer."),
                         strict=True)
    out = port(torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in inputs.items()})
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    _grads_agree(port, voicebox_state_dict(jax.tree.map(np.asarray, grads),
                                           dim_head=dim_head))
