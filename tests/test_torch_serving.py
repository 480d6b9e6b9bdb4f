"""The port's duration-mode serving (`voicebox_tpu_torch/serving.py`,
`ConditionalFlowMatcherWrapper.sample` with a duration predictor) against
the JAX package's, on the CPU in float32, from the same weights.

* `TTSEngine`: bucket choice, frame horizon (an up-re-bucket, and the
  warning past the largest bucket), `return_lengths` and `trim` lengths,
  all exact against the JAX engine (the noise differs: JAX keys and torch
  generators draw different numbers);
* `cfm.sample(phoneme_ids=..., noise=...)` latents against the JAX sampler
  at atol 2e-4, from the JAX predictor's aligned ids and the same y0, and
  its lengths exact;
* `DynamicBatcher`: two concurrent submits coalesce into one engine call;
* what raised before long-form serving and cloning were ported now runs,
  and the settings JAX refuses raise ValueError.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_duration import DP_CONFIG
from test_torch_transformer import _perturbed, _xla_inv_freq
from voicebox_tpu import ConditionalFlowMatcherWrapper as JaxCFM
from voicebox_tpu import VoiceBox as JaxVoiceBox
from voicebox_tpu.models.duration import DurationPredictor as JaxDP
from voicebox_tpu.serving import TTSEngine as JaxEngine
from voicebox_tpu.utils.tokenizer import GraphemeTokenizer as JaxGraphemes
from voicebox_tpu_torch import (
    ConditionalFlowMatcherWrapper,
    DurationPredictor,
    DynamicBatcher,
    TTSEngine,
    VoiceBox,
    kernels,
)
from voicebox_tpu_torch.utils.convert import duration_predictor_state_dict, voicebox_state_dict
from voicebox_tpu_torch.utils.tokenizer import GraphemeTokenizer

ATOL = 2e-4
LATENT = 32
VB_CONFIG = dict(dim_in=LATENT, dim=32, depth=2, dim_head=8, heads=4, dim_cond_emb=32,
                 num_register_tokens=2, condition_on_text=True, attn_qk_norm=True)
ENGINE = dict(text_buckets=(8, 16), batch_buckets=(1, 2), steps=2, decode_to_audio=False,
              frames_per_token=4)


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
def _wrappers():
    """The JAX wrapper (perturbed weights, qk gains ~0.25, durations of a
    few frames) and the port's wrapper on the same weights."""
    jtok = JaxGraphemes()
    jdp = JaxDP(tokenizer=jtok, **{k: v for k, v in DP_CONFIG.items()})
    dparams = _perturbed(jdp.init_params(jax.random.PRNGKey(0), seq_len=16, n_phonemes=8),
                         np.random.RandomState(1))
    dparams["to_pred"]["bias"] = dparams["to_pred"]["bias"] + 2.0
    jdp.params = dparams
    jvb = JaxVoiceBox(num_cond_tokens=jtok.vocab_size, **VB_CONFIG)
    jcfm = JaxCFM(jvb, duration_predictor=jdp)
    params = _perturbed(jcfm.init_params(jax.random.PRNGKey(2), seq_len=12, batch=1),
                        np.random.RandomState(3))
    for i in range(VB_CONFIG["depth"]):
        attn = params["transformer"][f"block_{i}"]["attn"]
        for key in ("q_norm", "k_norm"):
            attn[key]["gamma"] = 0.5 * attn[key]["gamma"]
    jcfm.params = params

    dp = DurationPredictor(tokenizer=GraphemeTokenizer(), **DP_CONFIG)
    dp.net.load_state_dict(_xla_inv_freq(duration_predictor_state_dict(
        jax.tree.map(np.asarray, dparams)), "transformer."), strict=True)
    vb = VoiceBox(num_cond_tokens=jtok.vocab_size, **VB_CONFIG)
    vb.load_state_dict(_xla_inv_freq(voicebox_state_dict(jax.tree.map(np.asarray, params)),
                                     "transformer."), strict=True)
    cfm = ConditionalFlowMatcherWrapper(vb, duration_predictor=dp, device="cpu").eval()
    return jcfm, cfm


def _engines(**kw):
    """The JAX and the port engine on `_wrappers()`, long-form windows of 8
    frames overlapping by 2 unless `kw` sets them."""
    jcfm, cfm = _wrappers()
    kw = {"long_window_frames": 8, "long_overlap_frames": 2, **kw}
    return JaxEngine(jcfm, **ENGINE, **kw), TTSEngine(cfm, **ENGINE, **kw)


TEXTS = ["hey", "hello you", "a longer one", "x"]


def test_predicted_durations_match_jax():
    jeng, eng = _engines()
    for texts, batch, length in ((TEXTS[:2], 2, 16), (TEXTS[3:], 1, 8)):
        ids = eng._pad_ids(eng._tokenizer().texts_to_tensor_ids(texts), batch, length)
        got = eng._predict_durations(ids)
        np.testing.assert_array_equal(got, jeng._predict_durations(ids))
        assert (got[ids < 0] == 0).all() and (got[ids >= 0] >= 1).all()


@pytest.mark.parametrize("texts", [TEXTS[:1], TEXTS[:2], TEXTS[1:3], TEXTS])
def test_engine_buckets_horizons_and_lengths_match_jax(texts):
    jeng, eng = _engines()
    out_j, len_j = jeng.synthesize(texts, rng=jax.random.PRNGKey(4), return_lengths=True)
    out, lens = eng.synthesize(texts, generator=torch.Generator().manual_seed(4),
                               return_lengths=True)
    assert tuple(out.shape) == tuple(out_j.shape)  # batch and frame-horizon buckets
    assert lens.dtype == torch.int32
    np.testing.assert_array_equal(lens.numpy(), np.asarray(len_j))
    clips_j = jeng.synthesize(texts, rng=jax.random.PRNGKey(5), trim=True)
    clips = eng.synthesize(texts, generator=torch.Generator().manual_seed(5), trim=True)
    assert [tuple(c.shape) for c in clips] == [tuple(c.shape) for c in clips_j]
    assert all(bool(torch.isfinite(c).all()) for c in clips)


def test_overflow_rebuckets_up_and_warns_past_the_largest_bucket():
    jeng, eng = _engines(frame_buckets=(32, 64))
    for e in (jeng, eng):  # 3 phonemes x 12 frames = 36 > the default horizon 32
        e._predict_durations = lambda ids, cond=None: np.where(ids >= 0, 12, 0)
    clips = eng.synthesize(["hey"], trim=True)
    assert [tuple(c.shape) for c in clips] == [tuple(c.shape) for c in
                                               jeng.synthesize(["hey"], trim=True)]
    assert clips[0].shape[0] == 36
    for e in (jeng, eng):  # 3 x 30 = 90 > the largest bucket 64
        e._predict_durations = lambda ids, cond=None: np.where(ids >= 0, 30, 0)
    with pytest.warns(UserWarning, match="largest frame bucket"):
        out_j, len_j = jeng.synthesize(["hey"], return_lengths=True)
    with pytest.warns(UserWarning, match="largest frame bucket"):
        out, lens = eng.synthesize(["hey"], return_lengths=True)
    assert lens.tolist() == np.asarray(len_j).tolist() == [64]
    assert tuple(out.shape) == tuple(out_j.shape) == (1, 64, LATENT)


def test_sample_from_phonemes_matches_jax_sampler():
    jcfm, cfm = _wrappers()
    eng = TTSEngine(cfm, **ENGINE)
    ids = eng._pad_ids(eng._tokenizer().texts_to_tensor_ids(["hey you", "ok"]), 2, 8)
    frames = 32
    _, aligned = jcfm.duration_predictor.forward_with_cond_scale(
        cond=None, phoneme_ids=jnp.asarray(ids), return_aligned_phoneme_ids=True,
        total_length=frames)
    y0 = np.random.RandomState(6).randn(2, frames, LATENT).astype(np.float32)
    sampler = jcfm._build_sampler(2, True, True, False, False, "midpoint")
    ref = sampler(jcfm.params, jnp.asarray(y0), jnp.zeros((2, frames, LATENT)), aligned,
                  None, None, jnp.float32(1.3))
    _, len_j = jcfm.sample(phoneme_ids=jnp.asarray(ids), frame_length=frames, steps=2,
                           cond_scale=1.3, return_lengths=True)
    got, lens = cfm.sample(phoneme_ids=ids, frame_length=frames, steps=2, cond_scale=1.3,
                           noise=torch.from_numpy(y0), return_lengths=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(len_j))
    # texts go through the predictor's tokenizer; a horizon that cuts warns
    _, by_text = cfm.sample(texts=["hey you", "ok"], frame_length=frames, steps=2,
                            return_lengths=True)
    assert by_text.tolist() == lens.tolist()
    with pytest.warns(UserWarning, match="truncated"):
        cfm.sample(phoneme_ids=ids, frame_length=2, steps=2)
    with pytest.raises(ValueError, match="duration_seconds needs"):
        cfm.sample(phoneme_ids=ids, duration_seconds=1.0, steps=2)


def test_generator_makes_synthesis_reproducible():
    _, eng = _engines()
    a = eng.synthesize(TEXTS, generator=torch.Generator().manual_seed(7))
    b = eng.synthesize(TEXTS, generator=torch.Generator().manual_seed(7))
    c = eng.synthesize(TEXTS, generator=torch.Generator().manual_seed(8))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    # the same text in two groups (beyond the largest batch bucket) draws
    # its own noise in each
    d = eng.synthesize(["hey", "yo", "hey"], generator=torch.Generator().manual_seed(7))
    assert not torch.equal(d[0], d[2])


def test_warmup_runs_every_bucket_and_stream_yields_the_trimmed_clip():
    _, eng = _engines(warm_overflow_buckets=True, frame_buckets=(32, 64, 128))
    seen = []
    sample = eng.wrapper.sample

    def spy(**kw):
        seen.append(tuple(kw["semantic_token_ids"].shape))
        return sample(**kw)

    eng.wrapper.sample = spy
    try:
        assert eng.warmup() > 0
    finally:
        del eng.wrapper.sample
    # (batch, frame horizon): every (batch, text) bucket, the overflow-only
    # 128, then the long-form stream's two windows of 8 frames
    assert seen == [(1, 32), (1, 64), (2, 32), (2, 64), (1, 128), (2, 128), (1, 8), (1, 8)]
    chunks = list(eng.synthesize_stream("hey", generator=torch.Generator().manual_seed(1)))
    clip = eng.synthesize(["hey"], generator=torch.Generator().manual_seed(1), trim=True)[0]
    assert len(chunks) == 1
    torch.testing.assert_close(chunks[0], clip)


def test_dynamic_batcher_coalesces_concurrent_submits():
    _, eng = _engines()
    calls = []
    synthesize = eng.synthesize

    def counted(texts, **kw):
        calls.append(list(texts))
        return synthesize(texts, **kw)

    eng.synthesize = counted
    batcher = DynamicBatcher(eng, max_wait_ms=200.0, autostart=False)
    futures = []
    threads = [threading.Thread(target=lambda t=t: futures.append(batcher.submit(t)))
               for t in ("hey", "yo")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(futures) == 2
    with batcher:  # starts the worker; leaving it drains and stops it
        clips = [f.result(timeout=60) for f in futures]
    assert len(calls) == 1 and sorted(calls[0]) == ["hey", "yo"]
    assert batcher.stats == {"requests": 2, "batches": 1, "occupancy_sum": 2}
    assert batcher.mean_occupancy == 2.0
    assert all(c.dim() == 2 and c.shape[1] == LATENT for c in clips)
    assert not batcher._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit("late")


def test_what_is_not_ported_raises():
    """What raised NotImplementedError before long-form serving and cloning
    were ported now runs; what JAX refuses raises ValueError."""
    jcfm, cfm = _wrappers()
    _, eng = _engines()
    long_text = "a" * 20  # over the largest text bucket, 16
    clips = eng.synthesize([long_text], trim=True)
    assert clips[0].shape[0] == eng._long_frame_ids(
        eng._tokenizer().texts_to_tensor_ids([long_text])[:, :20])[1]
    assert torch.cat(list(eng.synthesize_stream(long_text)), dim=1).shape == clips[0][None].shape
    with pytest.raises(ValueError, match="long-form serving is disabled"):
        TTSEngine(cfm, enable_long_form=False, **ENGINE).synthesize([long_text])
    prompt = np.zeros((1, 4, LATENT), np.float32)
    ids = np.zeros((1, 4), np.int64)
    assert eng.clone("hi", prompt, prompt_ids=ids).shape[2] == LATENT
    assert len(list(eng.clone_stream("hi", prompt, prompt_ids=ids))) >= 1
    with DynamicBatcher(eng) as batcher:
        assert batcher.submit_clone("hi", prompt, prompt_ids=ids).result(60).shape[2] == LATENT
    with pytest.raises(ValueError, match="prompt_ids"):  # a latent prompt without ids
        eng.clone("hi", prompt)
    engine = TTSEngine(cfm, prompt_seconds_buckets=(2.0, 1.0), **ENGINE)
    assert engine.prompt_seconds_buckets == (1.0, 2.0)
    with pytest.raises(ValueError, match="audio_enc_dec"):  # raw audio, no codec
        engine.clone("hi", np.zeros((1, 100), np.float32), prompt_ids=ids)
    TTSEngine(cfm, compilation_cache_dir=str(kernels.BUILD_DIR), **ENGINE)
    plain = ConditionalFlowMatcherWrapper(cfm.voicebox, device="cpu")
    with pytest.raises(ValueError, match="DurationPredictor"):
        TTSEngine(plain)
    with pytest.raises(ValueError, match="not both"):  # semantic mode is ported now
        ConditionalFlowMatcherWrapper(cfm.voicebox, text_to_semantic=object(),
                                      duration_predictor=object(), device="cpu")


@pytest.mark.parametrize("setting", [
    dict(max_semantic_token_ids=512), dict(spec_decode=False),
    dict(long_window_frames=256), dict(long_overlap_frames=64),
])
def test_unported_engine_settings_raise(setting):
    """Every engine setting is kept, none stored and ignored: semantic
    mode's for its decode (a duration-mode engine, as the JAX package's,
    does not read them), long-form sampling's for its windows (an overlap
    that is not under the window raises ValueError, as JAX asserts)."""
    _, cfm = _wrappers()
    engine = TTSEngine(cfm, **ENGINE, **setting)
    assert all(getattr(engine, k) == v for k, v in setting.items())
    if "long" in str(setting):
        with pytest.raises(ValueError, match="long_overlap_frames"):
            TTSEngine(cfm, **ENGINE, **{**setting, "long_overlap_frames": 256,
                                        "long_window_frames": 256})
