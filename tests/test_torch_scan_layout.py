"""JAX checkpoints in the `scan_layers=True` layout, and the transformer's
`rotary_theta` and `skip_connect_scale`, against the JAX package on the CPU
in float32 (atol 2e-4).

The JAX package stores a scanned backbone as two stacks, `layers_front`
and `layers_back`, each leaf on a leading depth / 2 axis.
`voicebox_tpu_torch.utils.convert` maps them onto the port's one layout,
`layers.{i}`: front row j is layer j, back row j layer depth / 2 + j with
its skip combiner.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_transformer import ATOL, _perturbed, _t
from voicebox_tpu.models import primitives as jp
from voicebox_tpu.models.transformer import Transformer as JaxTransformer
from voicebox_tpu.models.voicebox import VoiceBox as JaxVoiceBox
from voicebox_tpu_torch.models.transformer import Transformer
from voicebox_tpu_torch.models.voicebox import VoiceBox
from voicebox_tpu_torch.utils.convert import (transformer_state_dict, unrolled_layout,
                                              voicebox_state_dict)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DIM, COND = 32, 24
TR = dict(dim=DIM, depth=4, dim_head=16, heads=2, num_register_tokens=2, adaptive_rmsnorm=True,
          adaptive_rmsnorm_cond_dim_in=COND, attn_qk_norm=True)


def _inputs(seed, b=2, n=20):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, n, DIM).astype(np.float32)
    mask = rs.rand(b, n) > 0.3
    mask[:, :2] = True
    cond = rs.randn(b, COND).astype(np.float32)
    return rs, x, mask, cond


def _jit_table(state, theta=50000.0, prefix=""):
    """The rotary inverse frequencies at `theta` that XLA folds under jit,
    into a converted state dict. The JAX side runs jitted here, and the
    folded pow is one ulp off the eager one (`_xla_inv_freq`'s) in places,
    which the registers' position -10000 turns into ~6e-5 of the angle."""
    key = f"{prefix}rotary_emb.inv_freq"
    d = 2 * state[key].shape[0]
    table = np.asarray(jax.jit(lambda: jp.rotary_frequencies(
        jnp.ones((1,), jnp.int32), d, theta))())[0, : d // 2]
    return {**state, key: torch.from_numpy(np.array(table))}


def _match(jax_kw, port_kw, seed, theta=50000.0):
    rs, x, mask, cond = _inputs(seed)
    mod = JaxTransformer(**jax_kw)
    args = (jnp.asarray(x),)
    kw = dict(mask=jnp.asarray(mask), adaptive_rmsnorm_cond=jnp.asarray(cond))
    params = _perturbed(jax.jit(mod.init)(jax.random.PRNGKey(seed), *args, **kw)["params"], rs)
    ref = np.asarray(jax.jit(mod.apply)({"params": params}, *args, **kw))
    state = transformer_state_dict(params, theta=theta)
    # the converted buffer is the one the port builds at that theta (numpy's
    # pow and torch's differ by an ulp in places)
    torch.testing.assert_close(state["rotary_emb.inv_freq"],
                               Transformer(**port_kw).rotary_emb.inv_freq, rtol=1e-6, atol=0)
    port = Transformer(**port_kw)
    port.load_state_dict(_jit_table(state, theta), strict=True)
    with torch.no_grad():
        out = port(_t(x), mask=_t(mask), adaptive_rmsnorm_cond=_t(cond)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    return params


@pytest.mark.parametrize("skip", [True, False])
def test_scan_layout_transformer_converts_and_matches_jax(skip):
    kw = dict(TR, use_unet_skip_connection=skip, use_gateloop_layers=True)
    params = _match(dict(kw, scan_layers=True), kw, seed=3)
    assert "layers_front" in params and ("skip_combiner" in params["layers_back"]) == skip
    flat = unrolled_layout(params)
    assert sorted(k for k in flat if k.startswith("block_")) == [f"block_{i}" for i in range(4)]
    assert sorted(k for k in flat if k.startswith("skip_")) == (
        ["skip_combiner_2", "skip_combiner_3"] if skip else [])


def test_scan_and_unrolled_trees_convert_to_the_same_state():
    """The scan tree's rows, stacked back, are the unrolled tree's blocks:
    the unrolled JAX module applied to the unstacked tree gives the scanned
    module's output (to XLA's rounding: the two programs fuse apart), and
    both trees convert to the same state dict, bit for bit."""
    rs, x, mask, cond = _inputs(4)
    kw = dict(TR, use_unet_skip_connection=True)
    scan = JaxTransformer(**kw, scan_layers=True)
    args = dict(mask=jnp.asarray(mask), adaptive_rmsnorm_cond=jnp.asarray(cond))
    params = _perturbed(jax.jit(scan.init)(jax.random.PRNGKey(4), jnp.asarray(x), **args)["params"],
                        rs)
    flat = jax.tree.map(jnp.asarray, unrolled_layout(params))
    a = jax.jit(scan.apply)({"params": params}, jnp.asarray(x), **args)
    b = jax.jit(JaxTransformer(**kw).apply)({"params": flat}, jnp.asarray(x), **args)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=0)
    ours, theirs = transformer_state_dict(params), transformer_state_dict(flat)
    assert list(ours) == list(theirs)
    for key, value in theirs.items():
        torch.testing.assert_close(ours[key], value, rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("theta,scale", [(10000.0, 0.5), (10000.0, None), (50000.0, 0.5)])
def test_rotary_theta_and_skip_connect_scale_match_jax(theta, scale):
    kw = dict(TR, use_unet_skip_connection=True, rotary_theta=theta, skip_connect_scale=scale)
    _match(kw, kw, seed=5, theta=theta)


def test_skip_connect_scale_defaults_to_the_inverse_square_root_of_two():
    assert Transformer(**TR).skip_connect_scale == 2 ** -0.5
    assert Transformer(**TR, skip_connect_scale=0.5).skip_connect_scale == 0.5


VB = dict(num_cond_tokens=20, dim_cond_emb=16, dim=DIM, depth=4, dim_head=16, heads=2,
          num_register_tokens=2, attn_qk_norm=True, dim_in=12)
B, N = 2, 24


@functools.cache
def _scan_voicebox():
    jvb = JaxVoiceBox(**VB, scan_layers=True)
    rs = np.random.RandomState(6)
    params = jax.jit(functools.partial(jvb.init, cond_drop_prob=0.0))(
        {"params": jax.random.PRNGKey(6)}, jnp.zeros((B, N, 12)), times=jnp.zeros((B,)),
        cond=jnp.zeros((B, N, 12)), cond_token_ids=jnp.zeros((B, N), jnp.int32))["params"]
    return jvb, _perturbed(params, rs)


def test_scan_layout_voicebox_converts_and_matches_jax():
    jvb, params = _scan_voicebox()
    assert "layers_front" in params["transformer"]
    rs = np.random.RandomState(7)
    x, cond = (rs.randn(B, N, 12).astype(np.float32) for _ in range(2))
    times = rs.rand(B).astype(np.float32)
    ids = rs.randint(0, 20, (B, N)).astype(np.int32)
    cond_mask = rs.rand(B, N) < 0.5
    kw = dict(cond=cond, cond_mask=cond_mask, cond_token_ids=ids)
    apply = jax.jit(functools.partial(jvb.apply, cond_drop_prob=0.0, train=False))
    ref = apply({"params": params}, jnp.asarray(x), times=jnp.asarray(times),
                **{k: jnp.asarray(v) for k, v in kw.items()})
    port = VoiceBox(**VB)
    port.load_state_dict(_jit_table(voicebox_state_dict(params), prefix="transformer."),
                         strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(x), times=torch.from_numpy(times),
                   **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
