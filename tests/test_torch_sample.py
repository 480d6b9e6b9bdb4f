"""The serving slice end to end: the port's `ConditionalFlowMatcherWrapper.sample`
against the JAX package's compiled sampler (`_build_sampler`), on the CPU in
float32, from the same weights, conditioning and noise y0.

Latents must agree at atol 2e-4. Audio is not compared code for code: RVQ
assignment is an argmin, so a 1e-6 latent difference can flip a code near a
tie. So at least 99% of the codes must be equal end to end, and the audio is
compared as the port's decode of the JAX latents against the JAX program's
audio. Also here: the ODE solvers, interpolation, and an import of the whole
port with jax blocked.
"""

import functools
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_codec import LATENT, _audio_close, _jax_codec, _port_codec
from test_torch_transformer import _perturbed, _xla_inv_freq
from voicebox_tpu import VoiceBox as JaxVoiceBox
from voicebox_tpu.models.cfm import ConditionalFlowMatcherWrapper as JaxCFM
from voicebox_tpu.ops.interp import curtail_or_pad as jax_curtail_or_pad
from voicebox_tpu.ops.interp import interpolate_1d as jax_interpolate_1d
from voicebox_tpu.ops.ode import odeint as jax_odeint
from voicebox_tpu_torch import ConditionalFlowMatcherWrapper, VoiceBox
from voicebox_tpu_torch.ops.interp import curtail_or_pad, interpolate_1d
from voicebox_tpu_torch.ops.ode import odeint
from voicebox_tpu_torch.utils.convert import voicebox_state_dict

REPO = pathlib.Path(__file__).resolve().parents[1]
B, N, N_COND, STEPS, CFG = 2, 24, 50, 3, 1.3
CONFIG = dict(num_cond_tokens=N_COND, dim_cond_emb=32, dim=64, depth=2, dim_head=16,
              heads=2, num_register_tokens=2, attn_qk_norm=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _jax_run():
    """JAX params and the JAX sampler's latents and fused audio."""
    jcodec = _jax_codec()
    jcfm = JaxCFM(JaxVoiceBox(audio_enc_dec=jcodec, **CONFIG))
    params = _perturbed(jcfm.init_params(jax.random.PRNGKey(0), seq_len=N, batch=B),
                        np.random.RandomState(9))
    # qk gains near 0.25 (logits up to ~15): four guided evaluations compound
    # a peaked softmax's rounding; at gains near 0.5 a 1e-6 change of y0
    # already moves the latents by 1e-4 (measured on the CPU)
    for i in range(CONFIG["depth"]):
        attn = params["transformer"][f"block_{i}"]["attn"]
        for key in ("q_norm", "k_norm"):
            attn[key]["gamma"] = 0.5 * attn[key]["gamma"]
    rs = np.random.RandomState(10)
    cond = rs.randn(B, N, LATENT).astype(np.float32)
    ids = rs.randint(0, N_COND, (B, N)).astype(np.int32)
    y0 = rs.randn(B, N, LATENT).astype(np.float32)
    args = (params, jnp.asarray(y0), jnp.asarray(cond), jnp.asarray(ids), None, None,
            jnp.float32(CFG))
    latents = jcfm._build_sampler(STEPS, True, True, False, False, "midpoint")(*args)
    audio = jcfm._build_sampler(STEPS, True, True, False, False, "midpoint",
                                fuse_decode=True)(*args, jcodec.decode_fn()[1])
    return params, (cond, ids, y0), np.asarray(latents), np.asarray(audio)


def _port_cfm(params):
    vb = VoiceBox(audio_enc_dec=_port_codec(_jax_codec()), **CONFIG)
    vb.load_state_dict(_xla_inv_freq(voicebox_state_dict(params), "transformer."), strict=True)
    return ConditionalFlowMatcherWrapper(vb, device="cpu")


def test_latents_match_jax_sampler():
    params, (cond, ids, y0), latents_j, _ = _jax_run()
    cfm = _port_cfm(params)
    latents, frames = cfm.sample(
        cond=torch.from_numpy(cond), semantic_token_ids=torch.from_numpy(ids), steps=STEPS,
        cond_scale=CFG, noise=torch.from_numpy(y0), decode_to_audio=False,
        return_lengths=True,
    )
    np.testing.assert_allclose(latents.numpy(), latents_j, atol=2e-4, rtol=0)
    assert frames.tolist() == [N] * B


def test_audio_matches_jax_sampler():
    params, (cond, ids, y0), latents_j, audio_j = _jax_run()
    cfm = _port_cfm(params)
    audio, lengths = cfm.sample(
        cond=torch.from_numpy(cond), semantic_token_ids=torch.from_numpy(ids), steps=STEPS,
        cond_scale=CFG, noise=torch.from_numpy(y0), return_lengths=True,
    )
    assert audio.shape == audio_j.shape == (B, 1, N * cfm.codec.downsample_factor)
    assert lengths.tolist() == [N * cfm.codec.downsample_factor] * B
    latents = cfm.sample(cond=torch.from_numpy(cond), semantic_token_ids=torch.from_numpy(ids),
                         steps=STEPS, cond_scale=CFG, noise=torch.from_numpy(y0),
                         decode_to_audio=False)
    codes = cfm.codec.decode_to_codes(latents)
    codes_j = cfm.codec.decode_to_codes(torch.from_numpy(latents_j))
    assert (codes == codes_j).float().mean().item() >= 0.99
    _audio_close(cfm.codec.decode(torch.from_numpy(latents_j)).numpy(), audio_j)


def test_cond_mask_matches_jax_sampler():
    """Speech editing: a mask that keeps part of each row's cond (False)
    and generates the rest goes through both CFG halves, as in the JAX
    sampler built with has_cond_mask=True."""
    params, (cond, ids, y0), latents_free, _ = _jax_run()
    cond_mask = np.zeros((B, N), bool)
    cond_mask[0, 6:18] = True
    cond_mask[1, :10] = True
    jcfm = JaxCFM(JaxVoiceBox(audio_enc_dec=_jax_codec(), **CONFIG))
    ref = jcfm._build_sampler(STEPS, True, True, False, True, "midpoint")(
        params, jnp.asarray(y0), jnp.asarray(cond), jnp.asarray(ids), jnp.asarray(cond_mask),
        None, jnp.float32(CFG))
    latents = _port_cfm(params).sample(
        cond=torch.from_numpy(cond), semantic_token_ids=torch.from_numpy(ids),
        cond_mask=torch.from_numpy(cond_mask), steps=STEPS, cond_scale=CFG,
        noise=torch.from_numpy(y0), decode_to_audio=False)
    np.testing.assert_allclose(latents.numpy(), np.asarray(ref), atol=2e-4, rtol=0)
    assert np.abs(np.asarray(ref) - latents_free).max() > 1e-2  # the mask matters


def test_decode_to_codes_returns_the_codecs_codes():
    params, (cond, ids, y0), _, _ = _jax_run()
    cfm = _port_cfm(params)
    kw = dict(cond=torch.from_numpy(cond), semantic_token_ids=torch.from_numpy(ids),
              steps=STEPS, cond_scale=CFG, noise=torch.from_numpy(y0))
    latents = cfm.sample(decode_to_audio=False, **kw)
    codes, frames = cfm.sample(decode_to_codes=True, return_lengths=True, **kw)
    assert codes.dtype == torch.long and codes.shape[0] == B and codes.shape[-1] == N
    assert torch.equal(codes, cfm.codec.decode_to_codes(latents))
    assert frames.tolist() == [N] * B  # frames, not audio samples


def test_generator_noise_is_reproducible_and_cond_is_padded():
    params, (cond, ids, _), _, _ = _jax_run()
    cfm = _port_cfm(params)
    kw = dict(cond=torch.from_numpy(cond[:, :10]), semantic_token_ids=torch.from_numpy(ids),
              decode_to_audio=False)
    a = cfm.sample(generator=torch.Generator().manual_seed(3), **kw)
    b = cfm.sample(generator=torch.Generator().manual_seed(3), **kw)
    assert a.shape == (B, N, LATENT)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kwargs", [{"texts": ["hello"]}, {"phoneme_ids": [[1, 2]]},
                                    {"cond": np.zeros((1, 320), np.float32)}])
def test_unported_branches_raise(kwargs):
    """Texts and phonemes without a predictor or a TextToSemantic raise. A
    raw-audio cond no longer does (the SEANet encoder is ported): it samples
    as its encoded latents do. A TextToSemantic is accepted now (the
    semantic stack is ported); beside a DurationPredictor it raises."""
    cfm = _port_cfm(_jax_run()[0])
    if "cond" in kwargs:
        wave = torch.from_numpy(
            (0.3 * np.random.RandomState(12).randn(1, 320)).astype(np.float32))
        kw = dict(semantic_token_ids=torch.zeros(1, 4, dtype=torch.long), decode_to_audio=False)
        out = cfm.sample(cond=wave, generator=torch.Generator().manual_seed(4), **kw)
        ref = cfm.sample(cond=cfm.codec.encode(wave), generator=torch.Generator().manual_seed(4),
                         **kw)
        assert out.shape == (1, 4, LATENT)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    else:
        with pytest.raises(NotImplementedError):
            cfm.sample(**kwargs)
    with pytest.raises(ValueError, match="not both"):
        ConditionalFlowMatcherWrapper(cfm.voicebox, text_to_semantic=object(),
                                      duration_predictor=object(), device="cpu")


@pytest.mark.parametrize("method", ["midpoint", "euler", "rk4"])
def test_odeint_matches_jax(method):
    y0 = np.random.RandomState(11).randn(3, 4).astype(np.float32)
    times = np.linspace(0.0, 1.0, 5, dtype=np.float32)

    def f_j(t, y):
        return -y * t + jnp.sin(3 * t) * y ** 2

    def f_t(t, y):
        return -y * t + torch.sin(3 * t) * y ** 2

    ref, traj_ref = jax_odeint(f_j, jnp.asarray(y0), jnp.asarray(times), method=method)
    out, traj = odeint(f_t, torch.from_numpy(y0), torch.from_numpy(times), method=method)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(traj.numpy(), np.asarray(traj_ref), atol=1e-6)
    with pytest.raises(ValueError):
        odeint(f_t, torch.from_numpy(y0), torch.from_numpy(times), method="dopri5")


@pytest.mark.parametrize("shape,length", [((2, 3, 12), 30), ((2, 3, 30), 12), ((2, 12), 12),
                                          ((2, 9), 20)])
def test_interpolate_1d_matches_jax(shape, length):
    x = np.random.RandomState(12).randn(*shape).astype(np.float32)
    ref = jax_interpolate_1d(jnp.asarray(x), length)
    np.testing.assert_allclose(interpolate_1d(torch.from_numpy(x), length).numpy(),
                               np.asarray(ref), atol=1e-5)
    mask = x > 0
    np.testing.assert_array_equal(interpolate_1d(torch.from_numpy(mask), length).numpy(),
                                  np.asarray(jax_interpolate_1d(jnp.asarray(mask), length)))


@pytest.mark.parametrize("length", [5, 8, 11])
def test_curtail_or_pad_matches_jax(length):
    x = np.random.RandomState(13).randn(2, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(curtail_or_pad(torch.from_numpy(x), length).numpy(),
                                  np.asarray(jax_curtail_or_pad(jnp.asarray(x), length)))


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'voicebox_tpu', 'triton'):\n"
        "    sys.modules[name] = None\n"
        "import voicebox_tpu_torch\n"
        "for m in pkgutil.walk_packages(voicebox_tpu_torch.__path__, 'voicebox_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('ok', len(voicebox_tpu_torch.__all__))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # HubertWithKmeans, TextToSemantic and TextToSemanticTrainer joined
    assert proc.stdout.strip() == "ok 16"
