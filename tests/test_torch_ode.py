"""The Tsit5 solvers and the sampler's remaining options against the JAX
package, on the CPU in float32:

* fixed-grid Tsit5 (`odeint(method="tsit5")`) and adaptive Tsit5
  (`odeint_tsit5_adaptive`) against `voicebox_tpu/ops/ode.py` on an ODE
  with a closed form (atol 1e-6 between the two, and both near the exact
  solution); the adaptive solver takes as many steps as JAX's, rejected
  steps included, at a tolerance where some are rejected and at a step
  budget that forces acceptance;
* the tiny sampler through fixed-grid Tsit5 and through `use_torchode=True`
  against the JAX sampler on the same weights and noise (latents atol
  2e-4, the serving slice's tolerance) and the same adaptive step count;
* `duration_seconds` / `batch_size` without text conditioning against the
  JAX sampler (atol 2e-4), and `duration_seconds` cutting a given cond.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_codec import LATENT, _jax_codec, _port_codec
from test_torch_sample import CFG, CONFIG, STEPS, _jax_run, _port_cfm
from test_torch_transformer import _perturbed, _xla_inv_freq
from voicebox_tpu import VoiceBox as JaxVoiceBox
from voicebox_tpu.models.cfm import ConditionalFlowMatcherWrapper as JaxCFM
from voicebox_tpu.ops.ode import odeint as jax_odeint
from voicebox_tpu.ops.ode import odeint_tsit5_adaptive as jax_tsit5_adaptive
from voicebox_tpu_torch import ConditionalFlowMatcherWrapper, VoiceBox
from voicebox_tpu_torch.ops.ode import odeint_tsit5, odeint_tsit5_adaptive
from voicebox_tpu_torch.utils.convert import voicebox_state_dict

LAMBDA = -2.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _exact(y0, t):
    """dy/dt = lambda y + cos(t): y = (y0 + l / (1 + l^2)) e^(lt) + (l cos t - sin t)
    ... solved for y(0) = y0 (a particular solution plus the homogeneous)."""
    lam = LAMBDA
    part = lambda s: (np.sin(s) - lam * np.cos(s)) / (1 + lam ** 2)
    return (y0 - part(0.0)) * np.exp(lam * t) + part(t)


def _f_jax(t, y):
    return LAMBDA * y + jnp.cos(t)


def _f_torch(t, y):
    return LAMBDA * y + torch.cos(t)


def test_fixed_grid_tsit5_matches_jax_and_the_closed_form():
    y0 = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    times = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    ref, traj_ref = jax_odeint(_f_jax, jnp.asarray(y0), jnp.asarray(times), method="tsit5")
    out, traj = odeint_tsit5(_f_torch, torch.from_numpy(y0), torch.from_numpy(times))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    # |y| up to 2: seven stages' rounding in another order, 4 ulps
    np.testing.assert_allclose(traj.numpy(), np.asarray(traj_ref), atol=4e-6, rtol=0)
    # fifth order over h = 0.25: within 1e-5 of the exact solution
    np.testing.assert_allclose(out.numpy(), _exact(y0, 1.0), atol=1e-5, rtol=0)


@pytest.mark.parametrize("atol,max_steps", [(1e-7, 256), (1e-9, 4)])
def test_adaptive_tsit5_matches_jax_steps_and_values(atol, max_steps):
    """atol 1e-7 from h0 0.05: some steps are rejected; a budget of 4 steps
    at 1e-9 forces steps at the floor to be accepted."""
    y0 = np.random.RandomState(2).randn(3, 5).astype(np.float32)
    kw = dict(atol=atol, rtol=atol, max_steps=max_steps)
    ref, n_ref = jax_tsit5_adaptive(_f_jax, jnp.asarray(y0), 0.0, 1.0, **kw)
    out, n = odeint_tsit5_adaptive(_f_torch, torch.from_numpy(y0), 0.0, 1.0, **kw)
    assert n == int(n_ref), (n, int(n_ref))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    # the integration reaches t1 whatever the budget
    np.testing.assert_allclose(out.numpy(), _exact(y0, 1.0), atol=1e-4 if max_steps < 10
                               else 1e-6, rtol=0)


@pytest.mark.parametrize("method", ["tsit5", "tsit5_adaptive"])
def test_sampler_tsit5_matches_jax(method):
    params, (cond, ids, y0), _, _ = _jax_run()
    tol = 1e-4
    jcfm = JaxCFM(JaxVoiceBox(audio_enc_dec=_jax_codec(), **CONFIG), ode_atol=tol,
                  ode_rtol=tol, use_torchode=method == "tsit5_adaptive",
                  torchdiffeq_ode_method="tsit5" if method == "tsit5" else None)
    assert jcfm.ode_method == method
    sampler = jcfm._build_sampler(STEPS, True, True, False, False, method)
    ref = np.asarray(sampler(params, jnp.asarray(y0), jnp.asarray(cond), jnp.asarray(ids),
                             None, None, jnp.float32(CFG)))
    cfm = _port_cfm(params)
    port = ConditionalFlowMatcherWrapper(
        cfm.voicebox, ode_atol=tol, ode_rtol=tol, use_torchode=method == "tsit5_adaptive",
        torchdiffeq_ode_method="tsit5" if method == "tsit5" else None, device="cpu")
    assert port.ode_method == method
    latents = port.sample(cond=torch.from_numpy(cond), semantic_token_ids=torch.from_numpy(ids),
                          steps=STEPS, cond_scale=CFG, noise=torch.from_numpy(y0),
                          decode_to_audio=False)
    np.testing.assert_allclose(latents.numpy(), ref, atol=2e-4, rtol=0)
    if method == "tsit5_adaptive":
        # the JAX sampler drops the count: its solver on the same field gives it
        def field(t, x):
            return jcfm.voicebox.apply(
                {"params": params}, jnp.concatenate([x, x]), times=jnp.broadcast_to(t, (4,)),
                cond=jnp.concatenate([jnp.asarray(cond)] * 2),
                cond_token_ids=jnp.concatenate([jnp.asarray(ids)] * 2), cond_drop_prob=0.0,
                cond_drop_mask=jnp.arange(4) >= 2)

        def guided(t, x):
            out = field(t, x)
            return out[2:] + (out[:2] - out[2:]) * CFG

        _, n_ref = jax.jit(lambda y: jax_tsit5_adaptive(guided, y, 0.0, 1.0, atol=tol,
                                                        rtol=tol))(jnp.asarray(y0))
        assert port.ode_steps_taken == int(n_ref) > 1


@functools.cache
def _no_text_models():
    kw = dict(CONFIG, condition_on_text=False, num_cond_tokens=None)
    jcfm = JaxCFM(JaxVoiceBox(audio_enc_dec=_jax_codec(), **kw))
    params = _perturbed(jcfm.init_params(jax.random.PRNGKey(3), seq_len=16, batch=2),
                        np.random.RandomState(4))
    # qk gains halved, as the serving slice's test does: a peaked softmax
    # turns the solvers' rounding into 1e-4 of latents
    for i in range(CONFIG["depth"]):
        attn = params["transformer"][f"block_{i}"]["attn"]
        for key in ("q_norm", "k_norm"):
            attn[key]["gamma"] = 0.5 * attn[key]["gamma"]
    vb = VoiceBox(audio_enc_dec=_port_codec(_jax_codec()), **kw)
    vb.load_state_dict(_xla_inv_freq(voicebox_state_dict(params), "transformer."), strict=True)
    return jcfm, params, ConditionalFlowMatcherWrapper(vb, device="cpu")


def test_duration_seconds_without_text_matches_jax():
    jcfm, params, cfm = _no_text_models()
    seconds, batch = 0.02, 3
    frames = cfm.codec.frames_for_seconds(seconds)
    assert frames == _jax_codec().frames_for_seconds(seconds) and frames > 2
    rng = jax.random.PRNGKey(7)
    ref = np.asarray(jcfm.sample(duration_seconds=seconds, batch_size=batch, steps=STEPS,
                                 decode_to_audio=False, rng=rng, params=params))
    # the JAX sampler's y0: a standard normal of the zero cond's shape
    y0 = np.asarray(jax.random.normal(rng, (batch, frames, LATENT)))
    out, lengths = cfm.sample(duration_seconds=seconds, batch_size=batch, steps=STEPS,
                              decode_to_audio=False, noise=torch.from_numpy(y0),
                              return_lengths=True)
    assert out.shape == ref.shape == (batch, frames, LATENT)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=0)
    assert lengths.tolist() == [frames] * batch


def test_duration_seconds_cuts_a_given_cond():
    jcfm, params, cfm = _no_text_models()
    frames = cfm.codec.frames_for_seconds(0.02)
    cond = np.random.RandomState(5).randn(2, frames + 5, LATENT).astype(np.float32)
    rng = jax.random.PRNGKey(8)
    ref = np.asarray(jcfm.sample(cond=jnp.asarray(cond), duration_seconds=0.02, steps=STEPS,
                                 decode_to_audio=False, rng=rng, params=params))
    y0 = np.asarray(jax.random.normal(rng, (2, frames, LATENT)))
    out = cfm.sample(cond=torch.from_numpy(cond), duration_seconds=0.02, steps=STEPS,
                     decode_to_audio=False, noise=torch.from_numpy(y0))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=0)
