"""The two configurations the port now runs on the card, on the CPU
against the JAX package: the 100 s long-context step (seq 7504 frames + 16
registers, dim 512, batch 1) and the JAX package's default `VoiceBox()`
(dim 1024, depth 24, 16 x 64 heads).

* Past 4096 tokens, where the JAX package's `attend` would hand a TPU call
  to its Pallas kernels (on the CPU it stays on XLA's einsum): a tiny
  VoiceBox at 4222 frames + 2 registers against JAX, forward at atol 2e-4,
  every gradient leaf at cosine > 0.999 (XLA's rotary table).
* The bucket the trainers' loaders pick for a 7504-frame item: the port's
  `_bucket_target` and `AlignedPairedDataLoader` against the JAX package's
  on the default grid (256, registers 16: 7664 frames, 7680 tokens), the
  flagship's 128 and a grid of 16, which keeps 7504 (7520 tokens).
* K1's tile height at the new paths' shapes on an H100's 132 SMs.
* The default's 16-head split at a narrow width (dim 128, 16 x 8 heads)
  converted by `voicebox_state_dict` against JAX's forward; and the JAX
  package's default `VoiceBox()` converted on shapes alone (zero-stride
  arrays, meta tensors) onto the port's default keys and shapes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_transformer import _perturbed, _xla_inv_freq
from voicebox_tpu import VoiceBox as JaxVoiceBox
from voicebox_tpu.training import data as jax_data
from voicebox_tpu.utils.port_weights import load_voicebox_torch
from voicebox_tpu_torch import VoiceBox
from voicebox_tpu_torch.ops.flash_attention import k1_block_q
from voicebox_tpu_torch.training import data as port_data
from voicebox_tpu_torch.utils import convert
from voicebox_tpu_torch.utils.convert import voicebox_state_dict

ATOL = 2e-4
H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return (a @ b) / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30)


def _params(jvb, config, seed):
    """A JAX parameter tree: the port's initialisation under `seed` read into
    the JAX layout by the JAX package's `load_voicebox_torch` (its template
    from `eval_shape`, no compile), every leaf perturbed."""
    d_in = config["dim_in"]
    template = jax.eval_shape(functools.partial(jvb.init, cond_drop_prob=0.0),
                              {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8, d_in)),
                              times=jnp.zeros((1,)), cond=jnp.zeros((1, 8, d_in)),
                              cond_token_ids=jnp.zeros((1, 8), jnp.int32))["params"]
    torch.manual_seed(seed)
    params = load_voicebox_torch(VoiceBox(**config).state_dict(), template)
    return _perturbed(params, np.random.RandomState(seed))


def _inputs(b, n, d_in, seed, n_tokens=20):
    rs = np.random.RandomState(seed)
    return dict(
        cond=rs.randn(b, n, d_in).astype(np.float32),
        times=rs.rand(b).astype(np.float32),
        cond_token_ids=rs.randint(0, n_tokens, (b, n)).astype(np.int32),
        cond_mask=rs.rand(b, n) < 0.6,
    ), rs.randn(b, n, d_in).astype(np.float32)


# ---------------------------------------------------------------------------
# past 4096 tokens

LONG = dict(num_cond_tokens=20, dim_cond_emb=8, dim=16, depth=2, dim_head=8, heads=1,
            num_register_tokens=2, attn_qk_norm=True, dim_in=4)
LONG_FRAMES = 4222  # + 2 registers = 4224 = 33 x 128: past 4096, no lane padding in JAX


def test_voicebox_past_4096_tokens_matches_jax():
    jvb = JaxVoiceBox(**LONG)
    params = _params(jvb, LONG, seed=3)
    kw, x = _inputs(1, LONG_FRAMES, LONG["dim_in"], seed=4)
    kw["self_attn_mask"] = np.arange(LONG_FRAMES)[None] < LONG_FRAMES - 100  # a padded tail
    w = np.random.RandomState(5).randn(1, LONG_FRAMES, LONG["dim_in"]).astype(np.float32)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}

    def jax_fn(params):
        out = jvb.apply({"params": params}, jnp.asarray(x), cond_drop_prob=0.0, train=False,
                        **jkw)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(jax_fn, has_aux=True))(params)
    port = VoiceBox(**LONG)
    port.load_state_dict(_xla_inv_freq(voicebox_state_dict(params), "transformer."))
    out = port(_t(x), **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    (out * _t(w)).sum().backward()
    want = voicebox_state_dict(jax.tree.map(np.asarray, ref_grads))
    for name, param in port.named_parameters():
        if param.grad is not None:
            assert _cosine(param.grad.numpy(), want[name].numpy()) > 0.999, name


# ---------------------------------------------------------------------------
# buckets

@pytest.mark.parametrize("frames", [7504, 7500, 752])
@pytest.mark.parametrize("multiple", [256, 128, 16])
def test_bucket_of_a_long_item_matches_jax(frames, multiple):
    """The trainers' grid: `bucket_offset` = the 16 registers, align 128."""
    want = jax_data._bucket_target(frames, multiple, 16, 128)
    assert port_data._bucket_target(frames, multiple, 16, 128) == want
    item = (np.zeros((frames, 2), np.float32), np.zeros(frames, np.int32))
    kw = dict(bucket_multiple=multiple, bucket_offset=16, align_multiple=128, shuffle=False)
    (xs, mask), (ids, _) = next(iter(port_data.AlignedPairedDataLoader([item], 1, **kw)))
    (jxs, jmask), (jids, _) = next(iter(jax_data.AlignedPairedDataLoader([item], 1, **kw)))
    assert xs.shape == jxs.shape == (1, want, 2) and ids.shape == jids.shape
    np.testing.assert_array_equal(mask, jmask)
    if frames == 7504:  # the default grid pads 100 s to 7664 frames, 16 keeps it
        assert want == {256: 7664, 128: 7536, 16: 7504}[multiple]


# ---------------------------------------------------------------------------
# K1's tile height at the new shapes

@pytest.mark.parametrize("b, h, n, d, rows", [
    (1, 4, 7520, 128, 128),  # the 100 s step: 59 row tiles x 4 heads = 236 blocks
    (2, 4, 7516, 128, 128),  # a 100 s request, CFG doubled
    (8, 16, 768, 64, 64),    # the default VoiceBox in training (d = 64: one warpgroup)
    (2, 16, 766, 64, 64),    # its 10 s request
    (8, 8, 768, 128, 128),   # the default at dim1024_remat's 8 x 128 heads
])
def test_k1_tile_height_at_the_new_shapes(b, h, n, d, rows):
    assert k1_block_q(b, h, n, d, torch.bfloat16, H100_SMS) == rows


# ---------------------------------------------------------------------------
# the default VoiceBox

NARROW16 = dict(num_cond_tokens=20, dim_cond_emb=32, dim=128, depth=2, dim_head=8, heads=16,
                num_register_tokens=4, attn_qk_norm=True, dim_in=8)


def test_sixteen_head_split_at_a_narrow_width_matches_jax():
    """The default's 16-head split (dim 128, 16 x 8 heads): converted by
    `voicebox_state_dict`, loaded strictly, the forward against JAX's."""
    b, n = 2, 124  # + 4 registers = 128 tokens
    jvb = JaxVoiceBox(**NARROW16)
    params = _params(jvb, NARROW16, seed=6)
    kw, x = _inputs(b, n, NARROW16["dim_in"], seed=7)
    ref = jax.jit(functools.partial(jvb.apply, cond_drop_prob=0.0, train=False))(
        {"params": params}, jnp.asarray(x), **{k: jnp.asarray(v) for k, v in kw.items()})
    port = VoiceBox(**NARROW16)
    port.load_state_dict(_xla_inv_freq(voicebox_state_dict(params), "transformer."),
                         strict=True)
    assert port.transformer.layers[0][3].heads == 16
    with torch.no_grad():
        out = port(_t(x), **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_default_voicebox_converts_onto_the_ports_default_keys_and_shapes(monkeypatch):
    """The JAX package's `VoiceBox()` defaults (dim 1024, depth 24, 16 x 64
    heads, 1024-wide cond embedding, 16 registers, qk-norm) with 500 cond
    tokens and 128 latent channels: 711.1 M parameters in both packages."""
    kw = dict(num_cond_tokens=500, dim_in=128)
    jvb = JaxVoiceBox(**kw)
    shapes = jax.eval_shape(functools.partial(jvb.init, cond_drop_prob=0.0),
                            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8, 128)),
                            times=jnp.zeros((1,)), cond=jnp.zeros((1, 8, 128)),
                            cond_token_ids=jnp.zeros((1, 8), jnp.int32))["params"]
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    views = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    monkeypatch.setattr(convert, "_t",
                        lambda a: torch.empty(np.shape(a), dtype=torch.float32, device="meta"))
    sd = voicebox_state_dict(views)
    with torch.device("meta"):
        port = VoiceBox(**kw)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()}
    n_port = sum(p.numel() for p in port.parameters())
    assert n_port == n_jax == 711_101_920
    attn = port.transformer.layers[0][3]
    assert (attn.heads, attn.dim_head, port.transformer.depth) == (16, 64, 24)
    assert attn.scores_dtype is None  # opt-in, as in JAX
