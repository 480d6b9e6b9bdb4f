"""The TextToSemantic branch of the port's sampler and semantic-mode
`TTSEngine` against the JAX package's, on the CPU in float32: the tiny
seq2seq of `test_torch_text_to_semantic.py` in front of a tiny denoiser
(dim 64, depth 2, 2 x 16 heads, qk gains halved) over its 30 semantic ids,
weights carried by `utils/convert.py`, noise y0 the JAX sampler's own draw.

* `sample(text_token_ids=)`: the generated ids' mask is the denoiser's
  attention mask; latents at atol 2e-4 and lengths equal, plain and
  speculative decode;
* with a codec and a wav2vec attached, `cond` follows the ids at the
  wav2vec / codec rate ratio, and the lengths too;
* the loss takes ids from raw audio through the wav2vec;
* `TTSEngine` in semantic mode: `synthesize` outputs and lengths against
  the JAX engine's, `warmup`, `DynamicBatcher.submit`, a long text and a
  clone served.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_hubert as th
import test_torch_text_to_semantic as tt
from test_torch_codec import LATENT, _jax_codec, _port_codec
from test_torch_transformer import _perturbed, _xla_inv_freq
from voicebox_tpu import VoiceBox as JaxVoiceBox
from voicebox_tpu.models.cfm import ConditionalFlowMatcherWrapper as JaxCFM
from voicebox_tpu.serving import TTSEngine as JaxEngine
from voicebox_tpu_torch import ConditionalFlowMatcherWrapper, DynamicBatcher, TTSEngine, VoiceBox
from voicebox_tpu_torch.models import cfm as cfm_module
from voicebox_tpu_torch.models.hubert import HubertWithKmeans
from voicebox_tpu_torch.ops.stft import resample
from voicebox_tpu_torch.utils.convert import voicebox_state_dict

ATOL = 2e-4
N_IDS, STEPS, CFG_SCALE = 24, 3, 1.3
CONFIG = dict(num_cond_tokens=tt.CFG["num_semantic_token_ids"], dim_cond_emb=32, dim=64,
              depth=2, dim_head=16, heads=2, num_register_tokens=2, attn_qk_norm=True)
# what sample() reads of a wav2vec: its rates (HuBERT itself is held in
# test_torch_hubert.py); the port's moves with its model, so it is a Module
WAV2VEC_RATES = types.SimpleNamespace(target_sample_hz=16000, downsample_factor=320)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Rates(torch.nn.Module):
    target_sample_hz, downsample_factor = 16000, 320


@functools.cache
def _denoiser_params(codec: bool):
    jvb = JaxVoiceBox(audio_enc_dec=_jax_codec() if codec else None,
                      dim_in=None if codec else LATENT, **CONFIG)
    params = JaxCFM(jvb).init_params(jax.random.PRNGKey(0), seq_len=N_IDS, batch=2)
    params = _perturbed(params, np.random.RandomState(9))
    for i in range(CONFIG["depth"]):
        attn = params["transformer"][f"block_{i}"]["attn"]
        for key in ("q_norm", "k_norm"):
            attn[key]["gamma"] = 0.5 * attn[key]["gamma"]
    return params


def _jax_cfm(codec: bool = False, wav2vec: bool = False):
    jt, _ = tt._models()
    jt.wav2vec = WAV2VEC_RATES if wav2vec else None
    jvb = JaxVoiceBox(audio_enc_dec=_jax_codec() if codec else None,
                      dim_in=None if codec else LATENT, **CONFIG)
    return JaxCFM(jvb, text_to_semantic=jt,
                  params=jax.tree.map(jnp.asarray, _denoiser_params(codec)))


def _port_cfm(codec: bool = False, wav2vec=None):
    t2s = tt._port()
    t2s.__dict__["wav2vec"] = wav2vec
    vb = VoiceBox(audio_enc_dec=_port_codec(_jax_codec()) if codec else None,
                  dim_in=None if codec else LATENT, **CONFIG)
    vb.load_state_dict(_xla_inv_freq(voicebox_state_dict(_denoiser_params(codec)),
                                     "transformer."), strict=True)
    return ConditionalFlowMatcherWrapper(vb, text_to_semantic=t2s, device="cpu")


def _y0(rng, shape):
    return np.array(jax.random.normal(rng, shape, dtype=jnp.float32))


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_sample_from_text_ids_matches_jax(spec):
    jcfm, cfm = _jax_cfm(), _port_cfm()
    txt = tt._text()
    rng = jax.random.PRNGKey(4)
    kw = dict(max_semantic_token_ids=N_IDS, spec_decode=spec, steps=STEPS,
              cond_scale=CFG_SCALE, decode_to_audio=False, return_lengths=True)
    ref, ref_len = jcfm.sample(text_token_ids=jnp.asarray(txt), rng=rng, **kw)
    out, lens = cfm.sample(text_token_ids=torch.from_numpy(txt),
                           noise=torch.from_numpy(_y0(rng, (4, N_IDS, LATENT))), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_len))
    assert 0 < lens.min() < N_IDS == lens.max()  # the mask ends rows early


def test_rate_algebra_with_codec_wav2vec_and_cond():
    jcfm = _jax_cfm(codec=True, wav2vec=True)
    cfm = _port_cfm(codec=True, wav2vec=_Rates())
    txt = tt._text()[:2]
    n_ids = 64
    rs = np.random.RandomState(5)
    cond = rs.randn(2, 3, LATENT).astype(np.float32)
    rng = jax.random.PRNGKey(6)
    ratio = cfm.frames_per_semantic_token()
    frames = int(np.ceil(n_ids * 50 / (cfm.codec.sampling_rate / cfm.codec.downsample_factor)))
    assert ratio == jcfm.frames_per_semantic_token() and frames == int(np.ceil(n_ids * ratio))
    kw = dict(max_semantic_token_ids=n_ids, steps=STEPS, cond_scale=CFG_SCALE,
              decode_to_audio=False, return_lengths=True)
    ref, ref_len = jcfm.sample(text_token_ids=jnp.asarray(txt), cond=jnp.asarray(cond),
                               rng=rng, **kw)
    out, lens = cfm.sample(text_token_ids=torch.from_numpy(txt), cond=torch.from_numpy(cond),
                           noise=torch.from_numpy(_y0(rng, (2, frames, LATENT))), **kw)
    assert out.shape == tuple(ref.shape) == (2, frames, LATENT)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_len))


def test_loss_takes_ids_from_raw_audio_through_wav2vec():
    torch.manual_seed(0)
    hubert = HubertWithKmeans(**th.CFG)
    cfm = _port_cfm(codec=True, wav2vec=hubert)
    wave = np.random.RandomState(7).randn(2, 4800).astype(np.float32)
    sr = cfm.codec.sampling_rate
    ids = cfm._wav2vec_ids(torch.from_numpy(wave), sr)
    ref = hubert(resample(torch.from_numpy(wave), sr, 16000))
    assert torch.equal(ids, ref) and ids.shape == (2, hubert.num_frames(3200))
    derived = cfm(torch.from_numpy(wave), generator=torch.Generator().manual_seed(0))
    given = cfm(torch.from_numpy(wave), semantic_token_ids=ids,
                generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(derived) and torch.equal(derived, given)


ENGINE = dict(text_buckets=(8, 16), batch_buckets=(1, 2), max_semantic_token_ids=N_IDS,
              steps=STEPS, cond_scale=CFG_SCALE, decode_to_audio=False)
TEXTS = ["hello there", "a second one"]


def test_engine_semantic_mode_matches_jax(monkeypatch):
    jcfm, cfm = _jax_cfm(), _port_cfm()
    jengine, engine = JaxEngine(jcfm, **ENGINE), TTSEngine(cfm, **ENGINE)
    assert jengine.mode == engine.mode == "semantic"
    # the JAX engine's one bucket group draws y0 from its wrapper's first key
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    y0 = torch.from_numpy(_y0(sub, (2, N_IDS, LATENT)))
    monkeypatch.setattr(cfm_module, "normal", lambda shape, *a: y0.reshape(shape))
    ref, ref_len = jengine.synthesize(TEXTS, return_lengths=True)
    out, lens = engine.synthesize(TEXTS, return_lengths=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_len))
    clips = engine.synthesize(TEXTS, trim=True)
    assert [c.shape[0] for c in clips] == lens.tolist()


def test_engine_warmup_and_batcher():
    cfm = _port_cfm()
    engine = TTSEngine(cfm, **ENGINE)
    assert engine.warmup() > 0 and engine._warm
    with DynamicBatcher(engine, max_wait_ms=50.0) as batcher:
        futures = [batcher.submit(t) for t in TEXTS + ["x"]]
        clips = [f.result(timeout=120) for f in futures]
    assert all(c.shape[-1] == LATENT and 0 < c.shape[0] <= N_IDS for c in clips)
    # over the largest text bucket: long-form, 3 segments of up to N_IDS ids
    long_clip = engine.synthesize(["a" * 40], trim=True)[0]
    assert long_clip.shape[1] == LATENT and long_clip.shape[0] >= 3
    clone = engine.clone("hi", torch.zeros(1, 8, LATENT), prompt_ids=np.zeros((1, 8), np.int64))
    assert clone.shape[0] == 1 and clone.shape[2] == LATENT and clone.shape[1] >= 1
    with pytest.raises(ValueError, match="prompt_ids"):  # semantic mode needs the ids
        engine.clone("hi", torch.zeros(1, 8, LATENT))
