"""The port's `VoiceBox` against the JAX package, on the CPU in float32.

* `utils.convert.voicebox_state_dict` equals the JAX package's exporter
  `export_voicebox_torch` key for key and value for value, and the port
  loads it with `strict=True`;
* the forward and `forward_with_cond_scale` (CFG 1.3) match the JAX module
  through converted parameters (atol 2e-4);
* as a third check, the port matches the independent torch restatement of
  the reference forward in `tests/test_port_voicebox.py`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_port_voicebox import (
    DIM, DIM_COND, DIM_HEAD, DIM_IN, DEPTH, HEADS, N_COND_TOKENS, N_REG,
    _reference_state_dict, _torch_forward,
)
from test_torch_transformer import _perturbed, _xla_inv_freq
from voicebox_tpu import VoiceBox as JaxVoiceBox
from voicebox_tpu.utils.port_weights import export_voicebox_torch
from voicebox_tpu_torch import VoiceBox
from voicebox_tpu_torch.utils.convert import rotary_inv_freq, voicebox_state_dict

ATOL = 2e-4
B, N = 2, 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _LatentCodec:
    """Stands in for an attached codec: VoiceBox reads only its width."""

    latent_dim = 16


CONFIG = dict(num_cond_tokens=N_COND_TOKENS, dim_cond_emb=DIM_COND, dim=DIM, depth=DEPTH,
              dim_head=DIM_HEAD, heads=HEADS, num_register_tokens=N_REG, attn_qk_norm=True)


@functools.cache
def _models(with_codec=False, seed=0, text=True):
    kw = dict(CONFIG, audio_enc_dec=_LatentCodec()) if with_codec else dict(CONFIG, dim_in=DIM_IN)
    if not text:
        kw.update(condition_on_text=False, num_cond_tokens=None)
    jvb, port = JaxVoiceBox(**kw), VoiceBox(**kw)
    d_in = port.latent_dim
    rs = np.random.RandomState(seed)
    ids = {"cond_token_ids": jnp.zeros((B, N), jnp.int32)} if text else {}
    params = jax.jit(functools.partial(jvb.init, cond_drop_prob=0.0))(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((B, N, d_in)), times=jnp.zeros((B,)),
        cond=jnp.zeros((B, N, d_in)), **ids,
    )["params"]
    return jvb, port, _perturbed(params, rs), d_in


def _inputs(d_in, seed=1, n_ids=N):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, N, d_in).astype(np.float32)
    cond = rs.randn(B, N, d_in).astype(np.float32)
    times = rs.rand(B).astype(np.float32)
    ids = rs.randint(0, N_COND_TOKENS, (B, n_ids)).astype(np.int32)
    ids[0, :3] = -1  # pad ids map to the null row
    cond_mask = rs.rand(B, N) < 0.5
    return x, cond, times, ids, cond_mask


@pytest.mark.parametrize("with_codec", [False, True])
def test_convert_equals_exporter_and_loads_strict(with_codec):
    _, port, params, _ = _models(with_codec)
    ours = voicebox_state_dict(params)
    theirs = export_voicebox_torch(params)
    assert list(ours) == list(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
        assert ours[key].dtype == torch.float32
    assert ("proj_in.weight" in ours) == with_codec
    port.load_state_dict(ours, strict=True)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in theirs.items()}, strict=True)


@pytest.mark.parametrize("case", ["drop_mask", "ids_at_lower_rate", "scalar_time", "no_text"])
def test_forward_matches_jax(case):
    jvb, port, params, d_in = _models(with_codec=case == "drop_mask", text=case != "no_text")
    x, cond, times, ids, cond_mask = _inputs(d_in, n_ids=12 if case == "ids_at_lower_rate" else N)
    kw = dict(cond_mask=cond_mask, cond_token_ids=ids, cond=cond)
    if case == "no_text":
        del kw["cond_token_ids"]
    if case == "drop_mask":
        kw["cond_drop_mask"] = np.array([False, True])
    if case == "ids_at_lower_rate":
        attn = np.ones((B, 12), bool)
        attn[1, 9:] = False
        kw["self_attn_mask"] = attn
    t = np.float32(0.3) if case == "scalar_time" else times
    apply = jax.jit(functools.partial(jvb.apply, cond_drop_prob=0.0, train=False))
    ref = apply({"params": params}, jnp.asarray(x), times=jnp.asarray(t),
                **{k: jnp.asarray(v) for k, v in kw.items()})
    port.load_state_dict(_xla_inv_freq(voicebox_state_dict(params), "transformer."))
    with torch.no_grad():
        out = port(torch.from_numpy(x), times=torch.tensor(t),
                   **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("cond_scale", [1.3, 1.0])
def test_forward_with_cond_scale_matches_jax(cond_scale):
    jvb, port, params, d_in = _models()
    x, cond, times, ids, cond_mask = _inputs(d_in, seed=2)
    kw = dict(cond=cond, cond_token_ids=ids, cond_mask=cond_mask)
    guided = jax.jit(functools.partial(jvb.forward_with_cond_scale, cond_scale=cond_scale,
                                       train=False))
    ref = guided(params, jnp.asarray(x), times=jnp.asarray(times),
                 **{k: jnp.asarray(v) for k, v in kw.items()})
    port.load_state_dict(_xla_inv_freq(voicebox_state_dict(params), "transformer."))
    with torch.no_grad():
        out = port.forward_with_cond_scale(
            torch.from_numpy(x), times=torch.from_numpy(times), cond_scale=cond_scale,
            **{k: torch.from_numpy(v) for k, v in kw.items()},
        )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_matches_independent_torch_restatement():
    sd = _reference_state_dict()
    for i in range(DEPTH):  # halved qk gains, as in test_torch_transformer._perturbed
        for key in ("q_norm", "k_norm"):
            sd[f"transformer.layers.{i}.3.{key}.gamma"] *= 0.5
    sd["transformer.rotary_emb.inv_freq"] = torch.from_numpy(rotary_inv_freq(DIM_HEAD))
    port = VoiceBox(dim_in=DIM_IN, **CONFIG)
    port.load_state_dict(sd, strict=True)
    rs = np.random.RandomState(7)
    x, cond = (torch.from_numpy(rs.randn(B, N, DIM_IN).astype(np.float32)) for _ in range(2))
    times = torch.from_numpy(rs.rand(B).astype(np.float32))
    ids = torch.from_numpy(rs.randint(0, N_COND_TOKENS, (B, N)).astype(np.int64))
    cond_mask = torch.from_numpy(rs.rand(B, N) < 0.5)
    with torch.no_grad():
        out = port(x, times=times, cond=cond, cond_token_ids=ids, cond_mask=cond_mask)
    ref = _torch_forward(sd, x, times, cond, ids, cond_mask)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=1e-3)


def test_null_cond_is_a_zero_buffer_and_ids_below_zero_are_null():
    _, port, params, d_in = _models()
    port.load_state_dict(voicebox_state_dict(params))
    assert not any(name == "null_cond" for name, _ in port.named_parameters())
    assert torch.count_nonzero(port.null_cond) == 0
    x, cond, times, ids, cond_mask = (torch.from_numpy(a) for a in _inputs(d_in, seed=3))
    null_ids = ids.masked_fill(ids < 0, N_COND_TOKENS)
    with torch.no_grad():
        a = port(x, times=times, cond=cond, cond_token_ids=ids, cond_mask=cond_mask)
        b = port(x, times=times, cond=cond, cond_token_ids=null_ids, cond_mask=cond_mask)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
