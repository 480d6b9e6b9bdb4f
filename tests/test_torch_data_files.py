"""The port's file-backed data (`voicebox_tpu_torch/training/data.py`)
against the JAX package's (`voicebox_tpu/training/data.py`) on one folder
of FLAC and WAV files with transcripts, on the CPU:

* `load_audio`, `AudioDataset` and `SpeechTextDataset` give the same files
  in the same order, the same texts and the same waves bit for bit; with
  `sample_rate=` the waves match JAX's resample at atol 1e-5 (the tolerance
  of `test_torch_stft.py::test_resample_matches_jax`);
* `item_length` equals the decoded length, from the header alone;
* `get_dataloader`'s batches and masks equal the JAX `DataLoader`'s at the
  same seed;
* `VoiceBoxTrainer` over `AudioDataset` gives the losses it gives over
  `ArrayDataset` of the same waves (a tiny MelVoco, prefetch on), and
  `TextToSemanticTrainer` trains over a `SpeechTextDataset` of WAV and
  transcripts, as `tests/test_seq2seq_trainer.py` drives the JAX trainer.
"""

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from flac_ref_encoder import write_flac
from jax_native_decoders import jax_native_decoders
from voicebox_tpu.training import data as jdata
from voicebox_tpu_torch import ConditionalFlowMatcherWrapper, MelVoco, VoiceBox, VoiceBoxTrainer
from voicebox_tpu_torch import HubertWithKmeans, TextToSemantic, TextToSemanticTrainer
from voicebox_tpu_torch.models.vocos import Vocos
from voicebox_tpu_torch.training import data

RESAMPLE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _jax_decoders(tmp_path_factory):
    """The JAX package's decoders load in this worker even where its own
    in-package build lost a race with another worker's
    (`jax_native_decoders`)."""
    with jax_native_decoders(tmp_path_factory.mktemp("jax_native")):
        yield


def _pcm(n, seed, bps=16):
    rs = np.random.RandomState(seed)
    x = 0.3 * np.sin(np.arange(n) * rs.uniform(0.01, 0.2)) + 0.05 * rs.randn(n)
    return np.round(x * (2 ** (bps - 1) - 1)).astype(np.int64)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A LibriTTS-style tree: FLAC at 24 kHz (16 and 24 bits, mono and
    stereo) and 16-bit WAV at 16 kHz in nested folders, most with a
    transcript, one of each without."""
    root = tmp_path_factory.mktemp("corpus")
    for sub in ("spk1/ch1", "spk2"):
        (root / sub).mkdir(parents=True)
    flacs = [("spk1/ch1/a.flac", 2400, 16, 1), ("spk1/ch1/b.flac", 3100, 24, 1),
             ("spk2/c.flac", 2750, 16, 2), ("d.flac", 3600, 16, 1)]
    for i, (name, n, bps, ch) in enumerate(flacs):
        write_flac(root / name, np.stack([_pcm(n, 10 * i + c, bps) for c in range(ch)]), 24000,
                   bps=bps, block_size=1024)
    rs = np.random.RandomState(3)
    for i in range(6):
        wavfile.write(root / f"spk{1 + i % 2}" / f"u{i}.wav", 16000,
                      _pcm(int(rs.randint(700, 1600)), 100 + i).astype(np.int16))
    for name in ("spk1/ch1/a", "spk1/ch1/b", "spk2/c", *(f"spk{1 + i % 2}/u{i}" for i in range(5))):
        (root / f"{name}.txt").write_text(f"  the words of {name.split('/')[-1]}\n")
    return root


def _rel(files, root):
    return [str((f[0] if isinstance(f, tuple) else f).relative_to(root)) for f in files]


@pytest.mark.parametrize("name", ["spk1/ch1/a.flac", "spk1/ch1/b.flac", "spk2/c.flac",
                                  "spk1/u0.wav"])
def test_load_audio_matches_jax(corpus, name):
    (w, sr), (jw, jsr) = data.load_audio(corpus / name), jdata.load_audio(corpus / name)
    assert sr == jsr and w.dtype == jw.dtype == np.float32
    np.testing.assert_array_equal(w, jw)


@pytest.mark.parametrize("ext", [".flac", ".wav"])
def test_audio_dataset_matches_jax(corpus, ext):
    ds, jds = data.AudioDataset(corpus, audio_extension=ext), jdata.AudioDataset(
        corpus, audio_extension=ext)
    assert _rel(ds.files, corpus) == _rel(jds.files, corpus) and len(ds) == (4 if ext == ".flac"
                                                                             else 6)
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds[i], jds[i])
        assert ds.item_length(i) == jds.item_length(i) == len(ds[i])


@pytest.mark.parametrize("ext", [".flac", ".wav"])
def test_speech_text_dataset_matches_jax(corpus, ext):
    ds = data.SpeechTextDataset(corpus, audio_extension=ext)
    jds = jdata.SpeechTextDataset(corpus, audio_extension=ext)
    assert _rel(ds.files, corpus) == _rel(jds.files, corpus) and len(ds) == (3 if ext == ".flac"
                                                                             else 5)
    for i in range(len(ds)):
        (text, w), (jtext, jw) = ds[i], jds[i]
        assert text == jtext and text.startswith("the words of")
        np.testing.assert_array_equal(w, jw)


def test_resampled_waves_match_jax(corpus):
    ds = data.AudioDataset(corpus, sample_rate=16000)
    jds = jdata.AudioDataset(corpus, sample_rate=16000)
    pairs = data.SpeechTextDataset(corpus, audio_extension=".wav", sample_rate=24000)
    jpairs = jdata.SpeechTextDataset(corpus, audio_extension=".wav", sample_rate=24000)
    for got, ref in [(ds[i], jds[i]) for i in range(len(ds))] + [
            (pairs[i][1], jpairs[i][1]) for i in range(2)]:
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=RESAMPLE_ATOL, rtol=0)
    for i in range(len(ds)):
        assert ds.item_length(i) == len(ds[i]) == len(jds[i])


def test_jax_item_length_rounds_where_resample_takes_the_ceiling(corpus):
    """2750 samples at 24 kHz resample to ceil(1833.3) = 1834 at 16 kHz in
    both packages; the JAX `item_length` says round(1833.3) = 1833, the
    port's the decoded length."""
    ds = data.AudioDataset(corpus, sample_rate=16000)
    jds = jdata.AudioDataset(corpus, sample_rate=16000)
    i = [str(f.relative_to(corpus)) for f in ds.files].index("spk2/c.flac")
    assert len(ds[i]) == len(jds[i]) == 1834
    assert ds.item_length(i) == 1834 and jds.item_length(i) == 1833


def test_item_length_reads_headers_only(corpus, monkeypatch):
    lengths = [len(w) for w in (data.AudioDataset(corpus, audio_extension=e, sample_rate=sr)[i]
                                for e, sr in ((".flac", None), (".wav", 24000))
                                for i in range(4))]

    def refuse(path):
        raise AssertionError(f"item_length decoded {path}")

    monkeypatch.setattr(data, "load_audio", refuse)
    got = [data.AudioDataset(corpus, audio_extension=e, sample_rate=sr).item_length(i)
           for e, sr in ((".flac", None), (".wav", 24000)) for i in range(4)]
    assert got == lengths
    assert data._item_length(data.ArrayDataset([np.zeros((7, 3))]), 0) == 7


def test_get_dataloader_matches_jax(corpus):
    kw = dict(batch_size=3, seed=5, bucket_multiple=512, bucket_offset=64, align_multiple=256)
    ours = list(data.get_dataloader(data.AudioDataset(corpus, audio_extension=".wav"), **kw))
    ref = list(jdata.get_dataloader(jdata.AudioDataset(corpus, audio_extension=".wav"), **kw))
    assert len(ours) == len(ref) == 2
    for (x, m), (jx, jm) in zip(ours, ref):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(m, jm)
    assert data.pad_to_multiple(1025, 512) == jdata.pad_to_multiple(1025, 512) == 1536


# a tiny MelVoco (8 mels, n_fft 256, win 160, hop 64) and denoiser
WAVE_MEL = dict(n_mels=8, n_fft=256, win_length=160)
WAVE_VOCOS = dict(input_channels=8, dim=16, intermediate_dim=24, num_layers=1, n_fft=256,
                  hop_length=64)
TINY_VB = dict(dim=32, depth=2, dim_head=16, heads=2, num_register_tokens=2,
               condition_on_text=False)


def _wave_trainer(dataset):
    torch.manual_seed(0)
    vb = VoiceBox(audio_enc_dec=MelVoco(vocos=Vocos(**WAVE_VOCOS), **WAVE_MEL), **TINY_VB)
    cfm = ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2, device="cpu")
    return VoiceBoxTrainer(cfm, batch_size=2, dataset=dataset, num_train_steps=2, valid_frac=0.0,
                           lr=1e-3, log_every=1000, seed=7, device="cpu")


def test_voicebox_trainer_over_files_equals_in_memory(corpus):
    files = data.AudioDataset(corpus, sample_rate=24000)
    in_memory = data.ArrayDataset([files[i] for i in range(len(files))])
    losses = []
    for ds in (files, in_memory):
        trainer = _wave_trainer(ds)
        losses.append([trainer.train_step()["loss"].item() for _ in range(2)])
    assert all(np.isfinite(losses[0]))
    assert losses[0] == losses[1]


def test_seq2seq_trainer_over_speech_text_dataset(corpus):
    torch.manual_seed(0)
    hubert = HubertWithKmeans(num_clusters=24, conv_dim=8, dim=16, depth=1, heads=2).eval()
    t2s = TextToSemantic(dim=32, source_depth=2, target_depth=1, heads=2, dim_head=16,
                         wav2vec=hubert, device="cpu")
    trainer = TextToSemanticTrainer(
        t2s, batch_size=2,
        dataset=data.SpeechTextDataset(corpus, audio_extension=".wav", sample_rate=16000),
        num_train_steps=2, valid_frac=0.25, text_bucket_multiple=8, semantic_bucket_multiple=2,
        log_every=1000, device="cpu")
    logs = [trainer.train_step() for _ in range(2)]
    assert trainer.steps == 2
    assert all(np.isfinite(lg["loss"].item()) and np.isfinite(lg["grad_norm"].item())
               for lg in logs)


def test_text_conditioned_trainer_derives_ids_from_waves(corpus):
    """Raw waves into a text-conditioned VoiceBox: the trainer takes the
    conditioning ids from the wrapper's TextToSemantic's wav2vec, as the
    JAX trainer derives them (the pipeline's third stage)."""
    torch.manual_seed(0)
    hubert = HubertWithKmeans(num_clusters=24, conv_dim=8, dim=16, depth=1, heads=2).eval()
    t2s = TextToSemantic(dim=32, source_depth=2, target_depth=2, heads=2, dim_head=16,
                         wav2vec=hubert, device="cpu")
    vb = VoiceBox(audio_enc_dec=MelVoco(vocos=Vocos(**WAVE_VOCOS), **WAVE_MEL), num_cond_tokens=25,
                  dim_cond_emb=16, **{**TINY_VB, "condition_on_text": True})
    cfm = ConditionalFlowMatcherWrapper(vb, text_to_semantic=t2s, device="cpu")
    trainer = VoiceBoxTrainer(cfm, batch_size=2, dataset=data.AudioDataset(corpus, sample_rate=24000),
                              num_train_steps=1, valid_frac=0.0, log_every=1000, prefetch_batches=0,
                              device="cpu")
    batches = []

    def recorded(it):
        for item in it:
            batches.append(item)
            yield item

    trainer.dl_iter = recorded(trainer.dl_iter)
    _, _, ids = trainer._next_batch(trainer.dl_iter)
    wave = torch.from_numpy(batches[0][0])
    np.testing.assert_array_equal(ids.numpy(), cfm._wav2vec_ids(wave, None).numpy())
    assert ids.shape[0] == 2 and int(ids.min()) >= 0 and int(ids.max()) < 24
    assert np.isfinite(trainer.train_step()["loss"].item())
    with pytest.raises(ValueError, match="TextToSemantic with a wav2vec"):
        VoiceBoxTrainer(ConditionalFlowMatcherWrapper(vb, device="cpu"), batch_size=2,
                        dataset=data.AudioDataset(corpus), num_train_steps=1, valid_frac=0.0,
                        device="cpu")
