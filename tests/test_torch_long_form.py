"""The port's long-form windowed sampling and over-bucket serving against the
JAX package, on the CPU in float32, from the same weights and noise.

* `sample_long(decode_to_audio=False)` over 3 windows with a padded tail,
  with and without a latent prompt: latents at atol 2e-4, each window's
  y0 the JAX chain's (`rng, sub = split(rng)`, then `normal(sub, ...)`);
* `sample_long_stream`'s latent chunks: their lengths, and together
  `sample_long`'s latents under the same generator; its decoded chunks cut
  as JAX's `_stream_decode` cuts them, and together the one-shot decode of
  the same latents;
* the argument errors, raised when the stream is made;
* `TTSEngine`: `_segment_groups`, `_long_frame_ids` in duration mode (with
  and without a prompt's cond; semantic mode's is in `test_torch_clone.py`
  beside the semantic clone, on the same engines), `_drive_long`'s
  horizon, skip and budget, `synthesize` of short and over-bucket texts
  together and `synthesize_stream`, against the JAX engine with the noise
  it drew; `DynamicBatcher.submit` of an over-bucket text.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_semantic_sample as tss
from test_torch_codec import LATENT as CODEC_LATENT
from test_torch_codec import CODEBOOK, N_FILTERS, Q, RATIOS, VOCOS
from test_torch_serving import LATENT, _engines, _wrappers
from voicebox_tpu.models.cfm import ConditionalFlowMatcherWrapper as JaxCFM
from voicebox_tpu_torch import (ConditionalFlowMatcherWrapper, DynamicBatcher, EncodecVoco,
                                VoiceBox, Vocos)
from voicebox_tpu_torch.models.encodec import ResidualVQ
from voicebox_tpu_torch.models import cfm as cfm_module
from voicebox_tpu_torch.ops.masks import split_generator

ATOL = 2e-4
STEPS, CFG_SCALE = 2, 1.3
WINDOW, OVERLAP, TOTAL = 16, 4, 37  # 3 windows over 40 frames, the last 3 padding
LONG = dict(window_frames=WINDOW, overlap_frames=OVERLAP, steps=STEPS, cond_scale=CFG_SCALE)
LONG_ENGINE = dict(long_window_frames=WINDOW, long_overlap_frames=OVERLAP)
LONG_TEXT = "a text of forty one characters, no less."  # 40 graphemes: 3 segments of 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chain_noise(rng, windows: int, shape) -> list:
    """The y0 of each window of the JAX loop: split once per window."""
    out = []
    for _ in range(windows):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.normal(sub, shape, dtype=jnp.float32)))
    return out


def _inject(monkeypatch, noises: list) -> list:
    """Feed `noises` to the port's sampler in order; returns what is left."""
    left = list(noises)

    def draw(shape, *_, **__):
        y0 = left.pop(0)
        assert tuple(y0.shape) == tuple(shape), (y0.shape, shape)
        return torch.from_numpy(y0.copy())

    monkeypatch.setattr(cfm_module, "normal", draw)
    return left


@contextlib.contextmanager
def _recorded_jax_noise(monkeypatch, width: int):
    """Record every y0 the JAX sampler draws ((b, n, width) normals), in
    order."""
    drawn, normal = [], jax.random.normal

    def spy(key, shape=(), dtype=jnp.float32):
        out = normal(key, shape, dtype)
        if len(shape) == 3 and shape[-1] == width and not isinstance(out, jax.core.Tracer):
            drawn.append(np.array(out))
        return out

    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal", spy)
        yield drawn


def _ids(seed, b=2, n=13):
    return np.random.RandomState(seed).randint(0, 30, (b, n)).astype(np.int32)


@pytest.mark.parametrize("with_prompt", [False, True], ids=["no_prompt", "latent_prompt"])
def test_sample_long_matches_jax(monkeypatch, with_prompt):
    jcfm, cfm = _wrappers()
    ids = _ids(0)
    prompt = (np.random.RandomState(1).randn(2, 5, LATENT).astype(np.float32)
              if with_prompt else None)
    rng = jax.random.PRNGKey(2)
    ref = jcfm.sample_long(semantic_token_ids=jnp.asarray(ids), total_frames=TOTAL,
                           prompt=None if prompt is None else jnp.asarray(prompt),
                           decode_to_audio=False, rng=rng, **LONG)
    left = _inject(monkeypatch, _chain_noise(rng, 3, (2, WINDOW, LATENT)))
    out = cfm.sample_long(semantic_token_ids=torch.from_numpy(ids), total_frames=TOTAL,
                          prompt=None if prompt is None else torch.from_numpy(prompt),
                          decode_to_audio=False, **LONG)
    assert not left and tuple(out.shape) == tuple(ref.shape) == (2, TOTAL, LATENT)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    if with_prompt:  # the prompt's span is kept as given
        np.testing.assert_array_equal(out[:, :5].numpy(), prompt)


def test_stream_chunks_concatenate_to_sample_long():
    jcfm, cfm = _wrappers()
    ids = _ids(3)
    kw = dict(semantic_token_ids=torch.from_numpy(ids), total_frames=TOTAL,
              decode_to_audio=False, **LONG)
    chunks = list(cfm.sample_long_stream(generator=torch.Generator().manual_seed(4), **kw))
    whole = cfm.sample_long(generator=torch.Generator().manual_seed(4), **kw)
    ref_lens = [c.shape[1] for c in jcfm.sample_long_stream(
        semantic_token_ids=jnp.asarray(ids), total_frames=TOTAL, decode_to_audio=False,
        rng=jax.random.PRNGKey(0), **LONG)]
    assert [c.shape[1] for c in chunks] == ref_lens == [16, 12, 9]
    assert torch.equal(torch.cat(chunks, dim=1), whole)
    other = cfm.sample_long(generator=torch.Generator().manual_seed(5), **kw)
    assert not torch.equal(other, whole)


def _codec_wrapper():
    """A port wrapper with the tiny EncodecVoco of `test_torch_codec.py`
    attached, at seeded random weights: the stream's decode is held to the
    one-shot decode of the same latents (the latents are held to JAX above,
    the codec in `test_torch_codec.py`)."""
    torch.manual_seed(0)
    codec = EncodecVoco(quantizer=ResidualVQ(Q, CODEBOOK, CODEC_LATENT), vocos=Vocos(**VOCOS),
                        ratios=RATIOS, n_filters=N_FILTERS)
    vb = VoiceBox(audio_enc_dec=codec, dim_in=None, **tss.CONFIG)
    return ConditionalFlowMatcherWrapper(vb, device="cpu").eval()


def test_streamed_audio_is_the_one_shot_decode_in_jaxs_chunks():
    cfm = _codec_wrapper()
    ids = torch.from_numpy(
        np.random.RandomState(6).randint(0, tss.CONFIG["num_cond_tokens"], (1, TOTAL)))
    latents = cfm.sample_long(semantic_token_ids=ids, decode_to_audio=False,
                              generator=torch.Generator().manual_seed(7), **LONG)
    one_shot = cfm.codec.decode(latents)
    hop = cfm.codec.downsample_factor
    # the drains as JAX's own `_stream_decode` cuts the same latent chunks
    # (over a codec that only counts): all but the ctx (= overlap) frames a
    # drain holds, the last drain the rest
    counting = type("Counting", (), {"downsample_factor": hop,
                                     "decode": staticmethod(lambda x: jnp.zeros(
                                         (x.shape[0], 1, x.shape[1] * hop)))})
    chunks = [latents[:, :16].numpy(), latents[:, 16:28].numpy(), latents[:, 28:].numpy()]
    want = [c.shape[-1] for c in JaxCFM._stream_decode(iter(chunks), counting, True, OVERLAP)]
    streamed = list(cfm.sample_long_stream(semantic_token_ids=ids,
                                           generator=torch.Generator().manual_seed(7), **LONG))
    assert [c.shape[-1] for c in streamed] == want == [12 * hop, 12 * hop, 9 * hop, 4 * hop]
    # with a context and guard (12 frames) that cover the tiny vocoder's
    # receptive field (embed k7 + 2 ConvNeXt k7: 9 frames, the iSTFT's n_fft
    # 64 at hop 16: 2 more) the stream is the one-shot decode; the default 4
    # (the overlap) does not cover it. The flagship's (27 + 2 frames) is
    # under its 128.
    streamed = torch.cat(list(cfm.sample_long_stream(
        semantic_token_ids=ids, decode_ctx_frames=12,
        generator=torch.Generator().manual_seed(7), **LONG)), dim=-1)
    assert streamed.shape == one_shot.shape == (1, 1, TOTAL * hop)
    gap = (streamed - one_shot).abs().max().item()
    assert gap <= 1e-5 * one_shot.abs().max().item(), gap


@pytest.mark.parametrize("kw,match", [
    (dict(window_frames=8, overlap_frames=8), "overlap_frames"),
    (dict(window_frames=8, overlap_frames=0), "overlap_frames"),
    (dict(total_frames=7, window_frames=8, overlap_frames=2), "total_frames 7 < window"),
    (dict(total_frames=20, window_frames=8, overlap_frames=2, decode_ctx_frames=-1),
     "decode_ctx_frames"),
])
def test_long_argument_errors_match_jax(kw, match):
    jcfm, cfm = _wrappers()
    ids = _ids(8, b=1, n=10)
    if "decode_ctx_frames" not in kw:
        with pytest.raises(AssertionError):
            jcfm.sample_long_stream(semantic_token_ids=jnp.asarray(ids), **kw)
        with pytest.raises(ValueError, match=match):
            cfm.sample_long(semantic_token_ids=torch.from_numpy(ids), **kw)
    with pytest.raises(ValueError, match=match):  # at the call, before any window
        cfm.sample_long_stream(semantic_token_ids=torch.from_numpy(ids), **kw)


def test_prompt_longer_than_a_window_raises():
    jcfm, cfm = _wrappers()
    ids, prompt = _ids(9, b=1, n=10), np.zeros((1, WINDOW, LATENT), np.float32)
    with pytest.raises(AssertionError, match="longer than a window"):
        jcfm.sample_long(semantic_token_ids=jnp.asarray(ids), total_frames=20,
                         prompt=jnp.asarray(prompt), **LONG)
    with pytest.raises(ValueError, match="longer than a window"):
        cfm.sample_long(semantic_token_ids=torch.from_numpy(ids), total_frames=20,
                        prompt=torch.from_numpy(prompt), **LONG)


def test_segment_groups_and_duration_frame_ids_match_jax():
    jeng, eng = _engines(**LONG_ENGINE)
    row = np.asarray(eng._tokenizer().texts_to_tensor_ids([LONG_TEXT + " and more"]))
    row = row[:, : int((row[0] >= 0).sum())]
    n_j, groups_j = jeng._segment_groups(row)
    n, groups = eng._segment_groups(row)
    assert n == n_j == 4
    assert [sel for sel, _ in groups] == [sel for sel, _ in groups_j] == [[0, 1], [2], [3]]
    for (_, got), (_, want) in zip(groups, groups_j):
        np.testing.assert_array_equal(got, want)
    cond = np.random.RandomState(10).randn(1, 6, LATENT).astype(np.float32)
    for c in (None, cond):
        ids_j, exact_j = jeng._long_frame_ids(row, cond=None if c is None else jnp.asarray(c))
        ids, exact = eng._long_frame_ids(row, cond=None if c is None else torch.from_numpy(c))
        np.testing.assert_array_equal(ids, np.asarray(ids_j))
        assert exact == exact_j == ids.shape[1]


def _spy_stream(monkeypatch, wrapper) -> list:
    """Record the total_frames and ids each sample_long_stream call gets."""
    calls, stream = [], type(wrapper).sample_long_stream

    def spy(self, **kw):
        calls.append((kw["total_frames"], np.asarray(kw["semantic_token_ids"])))
        return stream(self, **kw)

    monkeypatch.setattr(type(wrapper), "sample_long_stream", spy)
    return calls


@pytest.mark.parametrize("exact,skip", [(37, 0), (16, 0), (17, 5), (40, 3)])
def test_drive_long_horizon_skip_and_budget_match_jax(monkeypatch, exact, skip):
    jeng, eng = _engines(**LONG_ENGINE)
    cond_ids = _ids(11, b=1, n=exact)
    prompt = np.random.RandomState(12).randn(1, skip, LATENT).astype(np.float32)
    rng = jax.random.PRNGKey(13)
    calls_j = _spy_stream(monkeypatch, jeng.wrapper)
    calls = _spy_stream(monkeypatch, eng.wrapper)
    kw = dict(skip_frames=skip)
    ref = [np.asarray(c) for c in jeng._drive_long(
        cond_ids, exact, rng=rng, prompt=jnp.asarray(prompt) if skip else None, **kw)]
    windows = 1 + -(-max(calls_j[0][0] - WINDOW, 0) // (WINDOW - OVERLAP))
    _inject(monkeypatch, _chain_noise(rng, windows, (1, WINDOW, LATENT)))
    got = list(eng._drive_long(cond_ids, exact, prompt=torch.from_numpy(prompt) if skip else None,
                               **kw))
    (total_j, ids_j), (total, ids) = calls_j[0], calls[0]
    assert total == total_j and (total - WINDOW) % (WINDOW - OVERLAP) == 0 and total >= exact
    np.testing.assert_array_equal(ids, ids_j)  # padded with the last id to the grid
    assert [c.shape[1] for c in got] == [c.shape[1] for c in ref]
    assert sum(c.shape[1] for c in got) == exact - skip
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), np.concatenate(ref, axis=1),
                               atol=ATOL, rtol=0)


def test_synthesize_short_and_long_texts_match_jax(monkeypatch):
    jeng, eng = _engines(**LONG_ENGINE)
    texts = ["hey", LONG_TEXT, "hello you"]
    with _recorded_jax_noise(monkeypatch, LATENT) as drawn:
        ref, ref_lens = jeng.synthesize(texts, rng=jax.random.PRNGKey(14), return_lengths=True)
    _inject(monkeypatch, drawn)
    out, lens = eng.synthesize(texts, return_lengths=True)
    assert tuple(out.shape) == tuple(ref.shape) and lens.dtype == torch.int32
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert int(lens[1]) > eng.frame_buckets[-1] // 2  # the long row spans its windows
    # the stream of the long text, concatenated, is its synthesized clip
    _inject(monkeypatch, drawn[1:])
    streamed = torch.cat(list(eng.synthesize_stream(LONG_TEXT)), dim=1)
    np.testing.assert_array_equal(streamed.numpy(), out[1:2, : int(lens[1])].numpy())


def test_batcher_serves_an_over_bucket_text_as_the_engine_does():
    _, eng = _engines(**LONG_ENGINE)
    with DynamicBatcher(eng, max_wait_ms=10.0, seed=3) as batcher:
        clip = batcher.submit(LONG_TEXT).result(timeout=120)
    gen = split_generator(torch.Generator().manual_seed(3), "cpu")
    direct = eng.synthesize([LONG_TEXT], generator=gen, trim=True)[0]
    assert torch.equal(clip, direct) and clip.shape[1] == LATENT
    assert batcher.stats["requests"] == batcher.stats["batches"] == 1
