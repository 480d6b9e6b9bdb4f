"""The port's trained-weight canaries (`voicebox_tpu_torch/canaries/`)
against the JAX package's `benchmarks/` scripts, on the CPU in float32:

* the corpus (`NOTE_FREQS`, `TEXTS`, `NOTE_S`, `synth` at 24 and 16 kHz),
  the generalization split (`make_corpus`) and `spec_decode_trained`'s
  `make_data`: equal to the JAX scripts' arrays bit for bit;
* `log_mel_latents` at atol 1e-2 dB (the tolerance tests/test_torch_stft.py
  holds `amplitude_to_db` to) on every bin within 80 dB of the corpus's
  peak (48% of them). The melodies leave the bands above their third
  harmonic silent: bins 80-137 dB under the peak hold the transforms' fp32
  rounding (the JAX STFT is a DFT matmul, the port's an FFT; they read
  1.8 dB apart at -90 dB), and are held to being that quiet on both sides;
  `stretch_ids` equal; `mel_msd` at rtol 1e-5 (the port sums in float64,
  the JAX script in float32);
* `sample_from_text`'s glue (greedy ids to eos -> the valid prefix
  stretched to the frame rate -> `sample(cond=zeros, ids_at_frame_rate=
  True)`) on tiny JAX-initialised weights carried by `utils/convert.py`, with
  the JAX script's own draws of y0 fed through `noise=`: latents at the
  done bar's atol 2e-4 times the latents' peak (16 midpoint steps of a
  field whose output reaches a few units);
* the canaries run on the CPU at a few steps with `device="cpu"`, raise
  without a card by default, and the untrained anchor is a fresh model
  that leaves the trained one as it is.

The semantic canary at tests/test_e2e_quality.py's shortened budget (250 +
600 steps) takes ~50 s of CFM steps alone on this CPU, past this file's
60 s: its gates run at the full budget on the card (`chip_smoke.py` phase 19).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_semantic_sample as ts
import test_torch_text_to_semantic as tt
from voicebox_tpu import VoiceBox as JaxVoiceBox
from voicebox_tpu.models.cfm import ConditionalFlowMatcherWrapper as JaxCFM
from voicebox_tpu.models.text_to_semantic import TextToSemantic as JaxT2S
from voicebox_tpu.utils.tokenizer import GraphemeTokenizer as JaxGraphemeTokenizer
from voicebox_tpu_torch import ConditionalFlowMatcherWrapper, TextToSemantic, VoiceBox
from voicebox_tpu_torch.canaries import e2e_generalization_canary as gen
from voicebox_tpu_torch.canaries import e2e_quality_canary as canary
from voicebox_tpu_torch.canaries import e2e_quality_canary_duration as dur
from voicebox_tpu_torch.canaries import spec_decode_trained as spec
from voicebox_tpu_torch.utils.convert import voicebox_state_dict
from voicebox_tpu_torch.utils.tokenizer import GraphemeTokenizer

from benchmarks import e2e_generalization_canary as jgen
from benchmarks import e2e_quality_canary as jcanary
from benchmarks import spec_decode_trained as jspec

DB_ATOL = 1e-2
RESOLVED_DB = 80.0  # bins this far under the peak are the transforms' rounding
GLUE_ATOL = 2e-4
GLUE_FRAMES, GLUE_STEPS = 20, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's tensors are past torch's grain for one thread (HuBERT's
    convolutions over 0.8 s waves, the canary denoiser at 4 x 123 tokens):
    beside other test workers on the same cores, torch's intra-op threads
    oversubscribe them (28 s alone, 214 s beside five workers), so the file
    runs on one thread and gives the count back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_corpus_is_the_jax_scripts():
    assert canary.NOTE_FREQS == jcanary.NOTE_FREQS
    assert canary.TEXTS == jcanary.TEXTS and canary.NOTE_S == jcanary.NOTE_S
    for t in canary.TEXTS:
        for sr in (24000, 16000):
            a, b = canary.synth(t, sr), jcanary.synth(t, sr)
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    for n_train, n_held in ((24, 8), (16, 4)):
        assert gen.make_corpus(n_train, n_held, 0) == jgen.make_corpus(n_train, n_held, 0)
    text, sem = spec.make_data(GraphemeTokenizer())
    jtext, jsem = jspec.make_data(JaxGraphemeTokenizer())
    assert np.array_equal(text, np.asarray(jtext)) and text.dtype == np.asarray(jtext).dtype
    assert np.array_equal(sem, np.asarray(jsem)) and sem.dtype == np.int32


def test_log_mel_latents_stretch_and_msd_match_jax():
    wav = np.stack([canary.synth(t, 24000) for t in canary.TEXTS])
    ref = np.array(jcanary.log_mel_latents(wav))
    out = canary.log_mel_latents(torch.from_numpy(wav)).numpy()
    assert out.shape == ref.shape == (4, 121, 40)
    resolved = ref >= ref.max() - RESOLVED_DB
    assert resolved.mean() > 0.45
    np.testing.assert_allclose(out[resolved], ref[resolved], atol=DB_ATOL, rtol=0)
    assert (out[~resolved] < ref.max() - RESOLVED_DB + DB_ATOL).all()

    ids = np.random.RandomState(0).randint(0, 12, (3, 39))
    for n in (121, 39, 17, 200):
        want = jcanary.stretch_ids(ids, n)
        assert np.array_equal(canary.stretch_ids(ids, n), want)
        assert np.array_equal(canary.stretch_ids(torch.from_numpy(ids), n).numpy(), want)

    rs = np.random.RandomState(1)
    a = (30 * rs.randn(4, 121, 40)).astype(np.float32)
    b = (30 * rs.randn(4, 118, 40)).astype(np.float32)  # truncated to the common frames
    for x, y in ((a, b), (ref, np.roll(ref, 1, axis=0))):
        want = jcanary.mel_msd(jnp.asarray(x), jnp.asarray(y))
        assert canary.mel_msd(torch.from_numpy(x), torch.from_numpy(y)) == pytest.approx(
            want, rel=1e-5)
    assert canary.cross_utterance(torch.from_numpy(ref)) == pytest.approx(
        jcanary.mel_msd(jnp.asarray(ref), jnp.asarray(np.roll(ref, 1, axis=0))), rel=1e-5)


@functools.cache
def _glue_pipes():
    """The tiny seq2seq of test_torch_text_to_semantic.py (its eos column
    doubled once more, so that the four texts end at different lengths)
    with a grapheme tokenizer, in front of the tiny
    denoiser of test_torch_semantic_sample.py, in both packages."""
    params = copy.deepcopy(tt._models()[1])
    params["to_logits"]["kernel"][:, tt.EOS] *= 2.0  # the texts end at 9, 31 and 48 ids
    jt = JaxT2S(**tt.CFG, tokenizer=JaxGraphemeTokenizer())
    jt.params = jax.tree.map(jnp.asarray, params)
    jvb = JaxVoiceBox(dim_in=ts.LATENT, **ts.CONFIG)
    jcfm = JaxCFM(jvb, text_to_semantic=jt,
                  params=jax.tree.map(jnp.asarray, ts._denoiser_params(False)))
    t2s = TextToSemantic(**tt.CFG, tokenizer=GraphemeTokenizer(), device="cpu")
    t2s.load_state_dict(tt.port_state(params), strict=True)
    vb = VoiceBox(dim_in=ts.LATENT, **ts.CONFIG)
    vb.load_state_dict(ts._xla_inv_freq(voicebox_state_dict(ts._denoiser_params(False)),
                                        "transformer."), strict=True)
    cfm = ConditionalFlowMatcherWrapper(vb, text_to_semantic=t2s, device="cpu")
    geometry = {"n_frames": GLUE_FRAMES, "n_mels": ts.LATENT}
    return ({"cfm": jcfm, "tts": jt, **geometry},
            {"cfm": cfm, "tts": t2s, "device": torch.device("cpu"), **geometry})


def test_sample_from_text_glue_matches_jax():
    jpipe, pipe = _glue_pipes()
    rng = jax.random.PRNGKey(42)
    ref = np.asarray(jcanary.sample_from_text(jpipe, steps=GLUE_STEPS, rng=rng))
    # the JAX script's y0 for text i: a normal draw from the i-th split key
    noise = []
    for _ in canary.TEXTS:
        rng, k = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(jax.random.normal(
            k, (1, GLUE_FRAMES, ts.LATENT), dtype=jnp.float32))))
    out = canary.sample_from_text(pipe, steps=GLUE_STEPS, noise=noise).numpy()
    assert out.shape == ref.shape == (4, GLUE_FRAMES, ts.LATENT)
    np.testing.assert_allclose(out, ref, atol=GLUE_ATOL * np.abs(ref).max(), rtol=0)
    # the texts decode to different valid lengths, so the stretch differs per text
    lengths = {int(pipe["tts"].generate([t], max_length=48, return_target_mask=True)[1].sum())
               for t in canary.TEXTS}
    assert len(lengths) > 1, lengths


def test_canaries_run_on_the_cpu_and_raise_without_a_card():
    quiet = lambda *_: None  # noqa: E731
    pipe, gt = canary.build_and_train(tts_steps=2, cfm_steps=2, device="cpu", verbose=quiet)
    before = [p.detach().clone() for p in pipe["cfm"].voicebox.parameters()]
    anchor = canary.untrained_cfm(pipe)
    again = canary.untrained_cfm(pipe)
    for p, q in zip(anchor.voicebox.parameters(), again.voicebox.parameters()):
        assert torch.equal(p, q)  # the anchor's weights come from its seed
    lat = canary.sample_from_text(pipe, cfm=anchor, steps=3)
    assert lat.shape == gt.shape == (4, 121, 40) and bool(torch.isfinite(lat).all())
    for p, q in zip(pipe["cfm"].voicebox.parameters(), before):
        assert torch.equal(p, q)  # the trained denoiser is left as it was
    dpipe, dgt = dur.build_and_train_duration(dp_steps=1, cfm_steps=1, device="cpu",
                                              verbose=quiet)
    lat = dur.sample_from_text_duration(dpipe, steps=3, quantize="w8a16")
    assert lat.shape == dgt.shape and bool(torch.isfinite(lat).all())
    if not torch.cuda.is_available():
        for build in (lambda: canary.build_and_train(tts_steps=1, cfm_steps=1),
                      lambda: dur.build_and_train_duration(dp_steps=1, cfm_steps=1),
                      lambda: gen.build_and_train_gen(tts_steps=1, cfm_steps=1),
                      lambda: spec.train(steps=1)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()


def test_untrained_anchor_keeps_torch_initialisation():
    """The port's modules keep torch's default initialisation (the upstream
    PyTorch reference's): a Linear's weight is uniform with std 1 /
    sqrt(3 fan_in) and its bias uniform; the JAX package's flax Dense is
    lecun-normal (std 1 / sqrt(fan_in)) with a zero bias. So an untrained
    anchor drawn at the same seed is another model in each package, and the
    canaries' gates are relative to the port's own anchor (ROADMAP Queue 3)."""
    pipe = {"cfm": _anchor_pipe(), "n_mels": 40, "device": torch.device("cpu")}
    vb = canary.untrained_cfm(pipe).voicebox
    jvb = JaxVoiceBox(dim_in=40, num_cond_tokens=12, **canary.DENOISER)
    jparams = JaxCFM(jvb).init_params(jax.random.PRNGKey(canary.ANCHOR_SEED), seq_len=8,
                                      batch=1)
    w, bias = vb.to_embed.weight.detach(), vb.to_embed.bias.detach()
    jw, jb = (np.asarray(jparams["to_embed"][k]) for k in ("kernel", "bias"))
    fan_in = w.shape[1]  # the input, the cond ids' embedding and the cond, concatenated
    assert jw.shape == (fan_in, w.shape[0])
    assert float(w.std()) == pytest.approx((3 * fan_in) ** -0.5, rel=0.05)
    assert float(jw.std()) == pytest.approx(fan_in ** -0.5, rel=0.1)
    assert float(bias.abs().max()) > 0 and not np.any(jb)


def _anchor_pipe():
    vb = VoiceBox(dim_in=40, num_cond_tokens=12, **canary.DENOISER)
    return ConditionalFlowMatcherWrapper(vb, device="cpu")
