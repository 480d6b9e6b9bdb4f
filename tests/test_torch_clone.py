"""The port's voice cloning (`TTSEngine.clone`, `clone_stream`,
`DynamicBatcher.submit_clone`) against the JAX engine, on the CPU in
float32, from the same weights and the noise the JAX engine drew.

* `_duration_prompt_ids`: the prompt's ids equal, summing to exactly its
  frames;
* `_prepare_prompt` on a raw prompt through the tiny EncodecVoco of
  `test_torch_codec.py`, zero-padded onto `prompt_seconds_buckets`:
  latents at atol 2e-4, ids equal;
* `clone` on a latent prompt with `prompt_text` (duration mode) and with
  `prompt_ids` (semantic mode): latents at atol 2e-4, shapes equal; on the
  semantic engines also `_long_frame_ids` of an over-bucket text (the
  seq2seq's ids per segment group), ids and exact frames equal;
* `clone_stream`'s chunks concatenate to `clone`; `submit_clone` resolves
  to the engine's clone under the same generator;
* the errors JAX also raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_semantic_sample as tss
from test_torch_codec import LATENT as CODEC_LATENT
from test_torch_codec import _jax_codec, _port_codec
from test_torch_duration import DP_CONFIG
from test_torch_long_form import LONG_ENGINE, LONG_TEXT, _inject, _recorded_jax_noise
from test_torch_serving import ENGINE, LATENT, VB_CONFIG, _engines
from test_torch_transformer import _perturbed, _xla_inv_freq
from voicebox_tpu import ConditionalFlowMatcherWrapper as JaxCFM
from voicebox_tpu import VoiceBox as JaxVoiceBox
from voicebox_tpu.models.duration import DurationPredictor as JaxDP
from voicebox_tpu.serving import TTSEngine as JaxEngine
from voicebox_tpu.utils.tokenizer import GraphemeTokenizer as JaxGraphemes
from voicebox_tpu_torch import (ConditionalFlowMatcherWrapper, DurationPredictor,
                                DynamicBatcher, TTSEngine, VoiceBox)
from voicebox_tpu_torch.ops.masks import split_generator
from voicebox_tpu_torch.utils.convert import duration_predictor_state_dict
from voicebox_tpu_torch.utils.tokenizer import GraphemeTokenizer

ATOL = 2e-4
PROMPT_TEXT = "hello you"
PROMPT_BUCKETS = (0.01, 0.02)  # 240 and 480 samples at 24 kHz


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prompt(seed, frames=6, width=LATENT):
    return np.random.RandomState(seed).randn(1, frames, width).astype(np.float32)


@pytest.mark.parametrize("frames", [7, 23, 40])
def test_duration_prompt_ids_match_jax_and_sum_to_the_prompt(frames):
    jeng, eng = _engines(**LONG_ENGINE)
    prompt = _prompt(frames, frames)
    ref = np.asarray(jeng._duration_prompt_ids(jnp.asarray(prompt), PROMPT_TEXT))
    got = eng._duration_prompt_ids(torch.from_numpy(prompt), PROMPT_TEXT)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (1, frames)
    ids = eng._tokenizer().texts_to_tensor_ids([PROMPT_TEXT])[0]
    assert set(got[0].tolist()) <= set(ids[ids >= 0].tolist())


@functools.cache
def _raw_prompt_engines():
    """JAX and port engines whose VoiceBox and predictor carry the tiny
    EncodecVoco (latents of width 16): the predictor's weights shared, the
    denoiser's unused (only the prompt's preparation runs)."""
    jtok = JaxGraphemes()
    jc = _jax_codec()
    jdp = JaxDP(audio_enc_dec=jc, tokenizer=jtok, **DP_CONFIG)
    dparams = _perturbed(jdp.init_params(jax.random.PRNGKey(0), seq_len=16, n_phonemes=8),
                         np.random.RandomState(1))
    dparams["to_pred"]["bias"] = dparams["to_pred"]["bias"] + 2.0
    jdp.params = dparams
    vb_kw = {k: v for k, v in VB_CONFIG.items() if k != "dim_in"}
    jcfm = JaxCFM(JaxVoiceBox(audio_enc_dec=jc, num_cond_tokens=jtok.vocab_size, **vb_kw),
                  duration_predictor=jdp, params={})
    codec = _port_codec(jc)
    dp = DurationPredictor(audio_enc_dec=codec, tokenizer=GraphemeTokenizer(), **DP_CONFIG)
    dp.net.load_state_dict(_xla_inv_freq(duration_predictor_state_dict(
        jax.tree.map(np.asarray, dparams)), "transformer."), strict=True)
    cfm = ConditionalFlowMatcherWrapper(
        VoiceBox(audio_enc_dec=codec, num_cond_tokens=jtok.vocab_size, **vb_kw),
        duration_predictor=dp, device="cpu").eval()
    kw = dict(ENGINE, prompt_seconds_buckets=PROMPT_BUCKETS, **LONG_ENGINE)
    return JaxEngine(jcfm, **kw), TTSEngine(cfm, **kw)


@pytest.mark.parametrize("samples", [300, 240, 100])
def test_prepare_raw_prompt_matches_jax(samples):
    jeng, eng = _raw_prompt_engines()
    wave = 0.3 * np.random.RandomState(samples).randn(1, samples).astype(np.float32)
    lat_j, ids_j = jeng._prepare_prompt(wave, None, PROMPT_TEXT)
    lat, ids = eng._prepare_prompt(torch.from_numpy(wave), None, PROMPT_TEXT)
    hop = eng.wrapper.codec.downsample_factor
    assert lat.shape == lat_j.shape == (1, -(-samples // hop), CODEC_LATENT)
    np.testing.assert_allclose(lat.numpy(), np.asarray(lat_j), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(ids, np.asarray(ids_j))
    assert ids.shape == (1, lat.shape[1])
    given = np.zeros((1, 3), np.int64)  # explicit ids are kept as given
    np.testing.assert_array_equal(eng._prepare_prompt(torch.from_numpy(wave), given)[1], given)


def test_clone_with_prompt_text_matches_jax(monkeypatch):
    jeng, eng = _engines(**LONG_ENGINE)
    prompt = _prompt(1)
    with _recorded_jax_noise(monkeypatch, LATENT) as drawn:
        ref = jeng.clone("hey there, how are you", jnp.asarray(prompt), prompt_text=PROMPT_TEXT,
                         rng=jax.random.PRNGKey(2))
    _inject(monkeypatch, drawn)
    out = eng.clone("hey there, how are you", torch.from_numpy(prompt), prompt_text=PROMPT_TEXT)
    assert tuple(out.shape) == tuple(ref.shape) and out.shape[1] > 16  # over 2 windows
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_clone_with_prompt_ids_in_semantic_mode_matches_jax(monkeypatch):
    # the plain decode: its ids are those of the speculative one, which
    # `test_torch_semantic_sample.py` holds, and it compiles far less JAX
    kw = {**tss.ENGINE, **LONG_ENGINE, "spec_decode": False}
    jeng, eng = JaxEngine(tss._jax_cfm(), **kw), TTSEngine(tss._port_cfm(), **kw)
    # the over-bucket text's ids: 3 segments of the largest bucket, 2 groups
    row = np.asarray(eng._tokenizer().texts_to_tensor_ids([LONG_TEXT]))
    row = row[:, : int((row[0] >= 0).sum())]
    ids_j, exact_j = jeng._long_frame_ids(row)
    ids, exact = eng._long_frame_ids(row)
    np.testing.assert_array_equal(ids, np.asarray(ids_j))
    assert exact == exact_j == ids.shape[1] and eng._long_ratio() == 1.0
    prompt = _prompt(3, frames=5, width=tss.LATENT)
    prompt_ids = np.random.RandomState(4).randint(0, tss.CONFIG["num_cond_tokens"], (1, 5))
    with _recorded_jax_noise(monkeypatch, tss.LATENT) as drawn:
        ref = jeng.clone("hello there", jnp.asarray(prompt), prompt_ids=prompt_ids,
                         rng=jax.random.PRNGKey(5))
    _inject(monkeypatch, drawn)
    out = eng.clone("hello there", torch.from_numpy(prompt), prompt_ids=prompt_ids)
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_clone_stream_concatenates_to_clone():
    _, eng = _engines(**LONG_ENGINE)
    prompt = torch.from_numpy(_prompt(6))
    kw = dict(prompt_text=PROMPT_TEXT)
    chunks = list(eng.clone_stream("a clone in chunks, window by window", prompt,
                                   generator=torch.Generator().manual_seed(7), **kw))
    whole = eng.clone("a clone in chunks, window by window", prompt,
                      generator=torch.Generator().manual_seed(7), **kw)
    assert len(chunks) >= 2 and torch.equal(torch.cat(chunks, dim=1), whole)


def test_submit_clone_resolves_to_the_engines_clone():
    _, eng = _engines(**LONG_ENGINE)
    prompt = torch.from_numpy(_prompt(8))
    with DynamicBatcher(eng, max_wait_ms=10.0, seed=9) as batcher:
        clip = batcher.submit_clone("hey there", prompt, prompt_text=PROMPT_TEXT).result(120)
        short = batcher.submit("yo").result(120)  # a synthesis beside it still runs
    gen = split_generator(torch.Generator().manual_seed(9), "cpu")
    assert torch.equal(clip, eng.clone("hey there", prompt, prompt_text=PROMPT_TEXT,
                                       generator=gen))
    assert short.shape[1] == LATENT and batcher.stats["requests"] == 2


def test_clone_errors_match_jax():
    jeng, eng = _engines(**LONG_ENGINE)
    prompt = _prompt(10)
    cases = [  # (call on an engine and its prompt array type, match)
        (lambda e, a: e.clone("hi", a(prompt)), "prompt_ids"),  # latent, no ids or text
        (lambda e, a: e.clone("hi", a(np.zeros((1, 300), np.float32)), prompt_ids=[[0]]),
         "audio_enc_dec"),  # raw audio without a codec
        (lambda e, a: e.clone("hi", a(_prompt(11, frames=16)), prompt_text=PROMPT_TEXT),
         "long_window_frames"),  # a prompt of a whole window
    ]
    for call, match in cases:
        with pytest.raises(AssertionError):
            call(jeng, jnp.asarray)
        with pytest.raises(ValueError, match=match):
            call(eng, torch.from_numpy)
    _, off = _engines(enable_long_form=False)
    with pytest.raises(ValueError, match="enable_long_form"):
        off.clone("hi", torch.from_numpy(prompt), prompt_text=PROMPT_TEXT)
    jraw, raw = _raw_prompt_engines()
    too_long = np.zeros((1, 481), np.float32)  # past the largest bucket, 480 samples
    with pytest.raises(AssertionError):
        jraw._prepare_prompt(too_long, None, PROMPT_TEXT)
    with pytest.raises(ValueError, match="largest prompt bucket"):
        raw._prepare_prompt(torch.from_numpy(too_long), None, PROMPT_TEXT)
    with pytest.raises(ValueError, match="prompt_text"):  # duration mode, raw, no transcript
        raw._prepare_prompt(torch.zeros(1, 100), None)
