"""The port's forward DSP (`ops/stft.py`) against the JAX package's, on the
CPU in float32, on non-silent noise-plus-tone waves:

* `stft` at atol 1e-3 x the spectrum's peak (the JAX DFT is an fp32 matmul
  over n_fft terms, the port's an FFT: each rounds its own sum);
* `spectrogram` and `mel_spectrogram` in power at rtol 1e-3 of each bin
  plus 1e-6 x the peak (quiet bins carry the sums' absolute rounding);
* `amplitude_to_db` of the mel at atol 1e-2 dB, `db_to_amplitude` at rtol
  1e-5; the filterbank equal to 1e-7;
* `resample` at atol 1e-5 (both convolve the same float32 taps).

The framing is the vocos-mel-24khz one (n_fft 1024, win 640, hop 256) and
smaller ones, with a wave length off the hop grid: n // hop + 1 frames.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebox_tpu.ops import stft as jstft
from voicebox_tpu_torch.ops import stft as tstft


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other test workers on the same cores, torch's intra-op
    threads oversubscribe them; the file runs on one thread and gives the
    cores back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wave(n, b=2, seed=0):
    rs = np.random.RandomState(seed)
    t = np.arange(n) / 24000.0
    tone = np.sin(2 * np.pi * rs.uniform(100, 4000, (b, 1)) * t[None])
    return (0.5 * tone + 0.1 * rs.randn(b, n)).astype(np.float32)


FRAMINGS = [(1024, 640, 256, 4900), (64, 48, 16, 333), (256, 160, 64, 2400)]


@pytest.mark.parametrize("n_fft,win,hop,n", FRAMINGS)
def test_stft_and_spectrogram_match_jax(n_fft, win, hop, n):
    wave = _wave(n)
    ref = np.asarray(jax.jit(functools.partial(jstft.stft, n_fft=n_fft, win_length=win,
                                               hop_length=hop))(jnp.asarray(wave)))
    out = tstft.stft(torch.from_numpy(wave), n_fft, win, hop).numpy()
    assert out.shape == ref.shape == (2, n_fft // 2 + 1, n // hop + 1)
    np.testing.assert_allclose(out, ref, atol=1e-3 * np.abs(ref).max(), rtol=0)
    for power in (2.0, 1.0):
        ref = np.asarray(jstft.spectrogram(jnp.asarray(wave), n_fft, win, hop, power=power))
        out = tstft.spectrogram(torch.from_numpy(wave), n_fft, win, hop, power=power).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-6 * ref.max())


@pytest.mark.parametrize("n_fft,win,hop,n", FRAMINGS)
def test_mel_and_db_match_jax(n_fft, win, hop, n):
    n_mels = 100 if n_fft == 1024 else 8
    kw = dict(n_mels=n_mels, sample_rate=24000, n_fft=n_fft, win_length=win, hop_length=hop)
    wave = _wave(n, seed=1)
    ref = np.asarray(jax.jit(functools.partial(jstft.mel_spectrogram, **kw))(jnp.asarray(wave)))
    out = tstft.mel_spectrogram(torch.from_numpy(wave), **kw)
    assert out.shape == ref.shape == (2, n_mels, n // hop + 1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-3, atol=1e-6 * ref.max())
    db_ref = np.asarray(jstft.amplitude_to_db(jnp.asarray(ref)))
    np.testing.assert_allclose(tstft.amplitude_to_db(out).numpy(), db_ref, atol=1e-2, rtol=0)
    np.testing.assert_allclose(tstft.amplitude_to_db(out, top_db=40.0).numpy(),
                               np.asarray(jstft.amplitude_to_db(jnp.asarray(ref), top_db=40.0)),
                               atol=1e-2, rtol=0)
    amp = tstft.db_to_amplitude(torch.from_numpy(db_ref.copy())).numpy()
    np.testing.assert_allclose(amp, np.asarray(jstft.db_to_amplitude(jnp.asarray(db_ref))),
                               rtol=1e-5, atol=0)


def test_melscale_fbanks_equal_jax():
    ref = jstft.melscale_fbanks(513, 0.0, 8000.0, 100, 24000)
    out = tstft.melscale_fbanks(513, 0.0, 8000.0, 100, 24000)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-7, rtol=0)


@pytest.mark.parametrize("orig,new,shape", [(16000, 24000, (2, 1000)), (24000, 16000, (1, 1, 999)),
                                            (44100, 24000, (700,))])
def test_resample_matches_jax(orig, new, shape):
    wave = np.random.RandomState(2).randn(*shape).astype(np.float32)
    ref = np.asarray(jstft.resample(jnp.asarray(wave), orig, new))
    out = tstft.resample(torch.from_numpy(wave), orig, new).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tstft.resample_np(wave, orig, new), out, atol=0, rtol=0)
    assert tstft.resample(torch.from_numpy(wave), orig, orig).shape == wave.shape
