"""The port's primitives and `Transformer` against the JAX package, on the
CPU in float32 (atol 2e-4), through parameters converted by
`voicebox_tpu_torch.utils.convert` or mapped here key by key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebox_tpu.models import primitives as jp
from voicebox_tpu.models.transformer import Transformer as JaxTransformer
from voicebox_tpu_torch.models import primitives as tp
from voicebox_tpu_torch.models.transformer import Transformer
from voicebox_tpu_torch.utils.convert import transformer_state_dict

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


def _perturbed(params, rs, scale=0.1):
    """numpy copy of a flax tree with noise on every leaf (identity inits
    such as zero adaptive-norm projections must not hide a bug). qk-norm
    gains are halved: with unit gains the logits reach 10 * dim_head and the
    softmax is so peaked that float32 rounding, not the port, sets the error."""

    def leaf(path, p):
        p = np.asarray(p, np.float32)
        if any(getattr(k, "key", None) in ("q_norm", "k_norm") for k in path):
            p = 0.5 * p
        return p + scale * rs.randn(*p.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _xla_inv_freq(state, prefix=""):
    """Put the JAX package's own rotary inverse frequencies into a converted
    state dict. The exporter's buffer comes from numpy's pow, which differs
    from XLA's by one ulp in a few entries; at the registers' position
    -10000 that moves the angle by up to 2.4e-4 rad, which alone would use
    the tolerance up."""
    key = f"{prefix}rotary_emb.inv_freq"
    d = 2 * state[key].shape[0]
    table = np.asarray(jp.rotary_frequencies(jnp.ones((1,), jnp.int32), d))[0, : d // 2]
    return {**state, key: torch.from_numpy(np.array(table))}


def _apply(mod, params, *args, **kwargs):
    return np.asarray(mod.apply({"params": params}, *args, **kwargs))


def _torch(module, state, *args, **kwargs):
    module.load_state_dict(state, strict=True)
    with torch.no_grad():
        return module(*args, **kwargs).numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("with_mask", [True, False])
def test_conv_position_embed(with_mask):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 40, 16).astype(np.float32)
    mask = rs.rand(2, 40) > 0.3 if with_mask else None
    mod = jp.ConvPositionEmbed(dim=16, kernel_size=31)
    params = _perturbed(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rs)
    ref = _apply(mod, params, jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask))
    kernel = params["dw_conv1d"]["kernel"]  # (k, 1, dim) -> (dim, 1, k)
    state = {"dw_conv1d.0.weight": _t(kernel.transpose(2, 1, 0)),
             "dw_conv1d.0.bias": _t(params["dw_conv1d"]["bias"])}
    out = _torch(tp.ConvPositionEmbed(16, kernel_size=31), state, _t(x),
                 mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    if with_mask:
        assert (out[~mask] == 0).all()


def test_rms_norm():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 9, 24).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row stays finite
    gamma = 1 + 0.1 * rs.randn(24).astype(np.float32)
    ref = _apply(jp.RMSNorm(24), {"gamma": gamma}, jnp.asarray(x))
    out = _torch(tp.RMSNorm(24), {"gamma": _t(gamma)}, _t(x))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert np.isfinite(out).all()


def test_adaptive_rms_norm():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 9, 24).astype(np.float32)
    cond = rs.randn(2, 40).astype(np.float32)
    mod = jp.AdaptiveRMSNorm(24, cond_dim=40)
    params = _perturbed(
        mod.init(jax.random.PRNGKey(0), jnp.asarray(x), cond=jnp.asarray(cond))["params"], rs
    )
    ref = _apply(mod, params, jnp.asarray(x), cond=jnp.asarray(cond))
    state = {f"{n}.{w}": _t(params[n]["kernel"].T if w == "weight" else params[n]["bias"])
             for n in ("to_gamma", "to_beta") for w in ("weight", "bias")}
    out = _torch(tp.AdaptiveRMSNorm(24, cond_dim=40), state, _t(x), cond=_t(cond))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_multihead_rms_norm():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, 7, 16).astype(np.float32)
    gamma = 1 + 0.1 * rs.randn(3, 1, 16).astype(np.float32)
    ref = _apply(jp.MultiheadRMSNorm(16, 3), {"gamma": gamma}, jnp.asarray(x))
    out = _torch(tp.MultiheadRMSNorm(16, 3), {"gamma": _t(gamma)}, _t(x))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_geglu():
    x = np.random.RandomState(4).randn(2, 5, 24).astype(np.float32)
    ref = np.asarray(jp.GEGLU().apply({}, jnp.asarray(x)))
    np.testing.assert_allclose(tp.GEGLU()(_t(x)).numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("width,pitch", [(53, 16), (1365, 16), (24, 16), (53, 8)])
def test_geglu_pitched_rows(width, pitch):
    """With a row pitch and no gradient to record, GEGLU writes into rows
    padded to a multiple of the pitch: the same values as the JAX module and
    as the contiguous product, at a row stride TMA can address."""
    x = np.random.RandomState(width).randn(2, 5, 2 * width).astype(np.float32)
    ref = np.asarray(jp.GEGLU().apply({}, jnp.asarray(x)))
    out = tp.GEGLU(row_pitch=pitch)(_t(x))
    assert out.shape == (2, 5, width) and out.stride() == (5 * out.stride(1), -(-width // pitch)
                                                           * pitch, 1)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(out, tp.GEGLU()(_t(x)), rtol=0, atol=0)
    # where autograd records the product it stays contiguous, and differentiable
    xg = _t(x).requires_grad_(True)
    out = tp.GEGLU(row_pitch=pitch)(xg)
    assert out.is_contiguous()
    out.sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()


@pytest.mark.parametrize("mult", [4.0, 2.0])
def test_feed_forward_pitched_matches_jax(mult):
    """The feed-forward of a w8a16 copy (its GEGLU at a row pitch of 16)
    against the JAX module, at a width whose inner dim is off 16."""
    rs = np.random.RandomState(6)
    x = rs.randn(2, 5, 20).astype(np.float32)
    mod = jp.FeedForward(20, mult=mult)
    params = _perturbed(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rs)
    ref = _apply(mod, params, jnp.asarray(x))
    state = {}
    for name, idx in (("proj_in", 0), ("proj_out", 3)):
        state[f"{idx}.weight"] = _t(params[name]["kernel"].T)
        state[f"{idx}.bias"] = _t(params[name]["bias"])
    ff = tp.FeedForward(20, mult=mult)
    assert ff[3].in_features % 16
    ff[1].row_pitch = 16
    out = _torch(ff, state, _t(x))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mult", [4.0, 2.0])
def test_feed_forward(mult):
    rs = np.random.RandomState(5)
    x = rs.randn(2, 5, 24).astype(np.float32)
    mod = jp.FeedForward(24, mult=mult)
    params = _perturbed(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rs)
    ref = _apply(mod, params, jnp.asarray(x))
    state = {}
    for name, idx in (("proj_in", 0), ("proj_out", 3)):
        state[f"{idx}.weight"] = _t(params[name]["kernel"].T)
        state[f"{idx}.bias"] = _t(params[name]["bias"])
    out = _torch(tp.FeedForward(24, mult=mult), state, _t(x))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_rotary():
    rs = np.random.RandomState(6)
    positions = np.concatenate([np.full(3, -10000), np.arange(20)]).astype(np.int32)
    t = rs.randn(2, 2, 23, 16).astype(np.float32)
    freqs_j = jp.rotary_frequencies(jnp.asarray(positions), 16)
    freqs_t = tp.RotaryEmbedding(16)(torch.from_numpy(positions))
    np.testing.assert_allclose(freqs_t.numpy(), np.asarray(freqs_j), rtol=1e-6)
    ref = np.asarray(jp.apply_rotary_pos_emb(freqs_j, jnp.asarray(t)))
    out = tp.apply_rotary_pos_emb(freqs_t, _t(t)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_learned_sinusoidal_pos_emb():
    rs = np.random.RandomState(7)
    t = rs.rand(3).astype(np.float32)
    weights = rs.randn(8).astype(np.float32)
    ref = _apply(jp.LearnedSinusoidalPosEmb(16), {"weights": weights}, jnp.asarray(t))
    out = _torch(tp.LearnedSinusoidalPosEmb(16), {"weights": _t(weights)}, _t(t))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("with_mask", [True, False])
def test_transformer_matches_jax(skip, with_mask):
    dim, depth, h, d, n_reg, cond_dim = 32, 4, 2, 16, 2, 24
    rs = np.random.RandomState(8)
    x = rs.randn(2, 20, dim).astype(np.float32)
    mask = rs.rand(2, 20) > 0.3 if with_mask else None
    cond = rs.randn(2, cond_dim).astype(np.float32)
    kw = dict(dim=dim, depth=depth, dim_head=d, heads=h, num_register_tokens=n_reg,
              adaptive_rmsnorm=True, adaptive_rmsnorm_cond_dim_in=cond_dim,
              use_unet_skip_connection=skip, attn_qk_norm=True)
    mod = JaxTransformer(**kw)
    jmask = None if mask is None else jnp.asarray(mask)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), mask=jmask,
                      adaptive_rmsnorm_cond=jnp.asarray(cond))["params"]
    params = _perturbed(params, rs)
    assert ("skip_combiner_3" in params) == skip
    ref = _apply(mod, params, jnp.asarray(x), mask=jmask,
                 adaptive_rmsnorm_cond=jnp.asarray(cond))
    out = _torch(Transformer(**kw), _xla_inv_freq(transformer_state_dict(params)), _t(x),
                 mask=None if mask is None else _t(mask),
                 adaptive_rmsnorm_cond=_t(cond))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_transformer_keys_are_the_reference_layout():
    port = Transformer(dim=32, depth=2, dim_head=16, heads=2, num_register_tokens=2,
                       adaptive_rmsnorm=True, adaptive_rmsnorm_cond_dim_in=24,
                       attn_qk_norm=True)
    keys = set(port.state_dict())
    assert {"register_tokens", "rotary_emb.inv_freq", "final_norm.gamma",
            "layers.0.2.to_gamma.weight", "layers.1.3.q_norm.gamma",
            "layers.1.3.to_qkv.weight", "layers.0.5.0.bias", "layers.1.5.3.weight"} <= keys
    assert not any(k.startswith(("layers.0.0.", "layers.0.1.")) for k in keys)
