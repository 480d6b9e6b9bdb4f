"""Audio DSP: STFT, power spectrogram, HTK mel filterbank, dB conversion,
inverse STFT by overlap-add, and polyphase sinc resampling.

Counterpart of `voicebox_tpu/ops/stft.py`. The JAX package builds the
(inverse) DFT from cos/sin matmuls and the overlap-add from shifted dense
adds, because its TPU backend had no FFT and slow scatters. Here the forward
STFT is `torch.stft` (cuFFT on the card), the inverse real DFT is
`torch.fft.irfft` (it drops the imaginary parts of the DC and Nyquist bins,
as the JAX basis does) and the overlap-add is `F.fold`. The framing is the
JAX package's, which is torch's: a `win_length` window zero-padded centred to
`n_fft` (`(n_fft - win_length) // 2` on the left), and with `center=True` a
reflect pad of `n_fft // 2` on both sides, so a wave of n samples gives
`n // hop + 1` frames.

Numerical contracts are torchaudio's defaults as the reference uses them:
Spectrogram(power 2, center, reflect, periodic Hann), MelScale (HTK, no
norm; the filterbank is built in float64 numpy and cast to fp32),
AmplitudeToDB (power, ref 1, amin 1e-10), DB_to_amplitude (ref 1, power
0.5), functional.resample (windowed sinc, width 6, rolloff 0.99). Only the
Vocos head's 'same' padding of the inverse STFT is ported.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "amplitude_to_db",
    "db_to_amplitude",
    "hann_window",
    "istft",
    "mel_spectrogram",
    "melscale_fbanks",
    "resample",
    "resample_np",
    "spectrogram",
    "stft",
]


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window's default), fp32."""
    return torch.hann_window(win_length, periodic=True, device=device)


def stft(audio: torch.Tensor, n_fft: int = 1024, win_length: Optional[int] = None,
         hop_length: Optional[int] = None, center: bool = True, pad_mode: str = "reflect",
         window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b, n) audio -> complex STFT (b, n_fft // 2 + 1, frames)."""
    win_length = win_length or n_fft
    hop_length = hop_length or n_fft // 4
    if window is None:
        window = hann_window(win_length, device=audio.device)
    return torch.stft(audio.float(), n_fft, hop_length=hop_length, win_length=win_length,
                      window=window.to(audio.device, torch.float32), center=center,
                      pad_mode=pad_mode, normalized=False, onesided=True, return_complex=True)


def spectrogram(audio: torch.Tensor, n_fft: int = 1024, win_length: Optional[int] = None,
                hop_length: Optional[int] = None, power: float = 2.0,
                center: bool = True) -> torch.Tensor:
    """|STFT|^power (b, n_fft // 2 + 1, frames), from re^2 + im^2."""
    spec = torch.view_as_real(stft(audio, n_fft, win_length, hop_length, center=center))
    power_spec = spec[..., 0] * spec[..., 0] + spec[..., 1] * spec[..., 1]
    if power == 2.0:
        return power_spec
    if power == 1.0:
        return power_spec.sqrt()
    return power_spec ** (power / 2.0)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=16)
def _fbanks_np(n_freqs: int, f_min: float, f_max: float, n_mels: int,
               sample_rate: int) -> np.ndarray:
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes)).astype(np.float32)
    fb.setflags(write=False)  # shared by every caller of the cache
    return fb


def melscale_fbanks(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                    sample_rate: int, device=None) -> torch.Tensor:
    """Triangular mel filterbank (n_freqs, n_mels), HTK scale, no norm, fp32."""
    fb = _fbanks_np(n_freqs, float(f_min), float(f_max), n_mels, sample_rate)
    return torch.from_numpy(fb.copy()).to(device)


def mel_spectrogram(audio: torch.Tensor, *, n_mels: int = 100, sample_rate: int = 24000,
                    f_min: float = 0.0, f_max: Optional[float] = 8000.0, n_fft: int = 1024,
                    win_length: int = 640, hop_length: int = 160,
                    power: float = 2.0) -> torch.Tensor:
    """(b, n) audio -> (b, n_mels, frames) mel power spectrogram."""
    spec = spectrogram(audio, n_fft, win_length, hop_length, power=power)
    fb = melscale_fbanks(n_fft // 2 + 1, f_min, f_max if f_max is not None else sample_rate / 2,
                         n_mels, sample_rate, device=spec.device)
    return torch.matmul(fb.T, spec)  # (mel, freq) @ (b, freq, T)


def amplitude_to_db(x: torch.Tensor, stype: str = "power", ref: float = 1.0,
                    amin: float = 1e-10, top_db: Optional[float] = None) -> torch.Tensor:
    """mult * log10(clamp(x, amin)) - mult * log10(max(amin, ref)), mult 10
    for power and 20 for magnitude; `top_db` floors at max - top_db."""
    multiplier = 10.0 if stype == "power" else 20.0
    x_db = multiplier * torch.log10(x.clamp_min(amin))
    x_db = x_db - multiplier * math.log10(max(amin, ref))
    if top_db is not None:
        x_db = torch.maximum(x_db, x_db.max() - top_db)
    return x_db


def db_to_amplitude(x: torch.Tensor, ref: float = 1.0, power: float = 0.5) -> torch.Tensor:
    """ref * (10^(0.1 x))^power."""
    return ref * torch.pow(torch.pow(10.0, 0.1 * x), power)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(b, T, n) frames -> (b, n + hop * (T - 1)) summed at stride `hop`."""
    b, n_frames, n = frames.shape
    out_len = n + hop * (n_frames - 1)
    y = F.fold(
        frames.transpose(1, 2), output_size=(1, out_len),
        kernel_size=(1, n), stride=(1, hop),
    )
    return y.reshape(b, out_len)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int,
          window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b, n_fft // 2 + 1, frames) complex spectrum -> (b, frames * hop_length)
    audio: windowed overlap-add with window-square normalisation, trimmed by
    (n_fft - hop) / 2 on both sides (the JAX `istft(padding="same")`, the
    Vocos head's semantics). `window` defaults to the periodic Hann window."""
    if window is None:
        window = hann_window(n_fft, device=spec.device)
    n_frames = spec.shape[-1]
    frames = torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1)  # (b, T, n_fft)
    y = _overlap_add(frames * window, hop_length)
    win_sq = _overlap_add((window * window).expand(1, n_frames, n_fft), hop_length)[0]
    y = y / win_sq.clamp_min(1e-11)
    pad = (n_fft - hop_length) // 2
    return y[:, pad: pad + n_frames * hop_length]


@functools.lru_cache(maxsize=32)
def _sinc_resample_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                          rolloff: float = 0.99):
    """torchaudio's windowed-sinc polyphase bank: (new, 2 width + orig)
    float32 taps, built in float64."""
    gcd = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // gcd, new_freq // gcd
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = idx - np.arange(new, dtype=np.float64)[:, None] / new
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t *= np.pi
    scale = base_freq / orig
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels = (kernels * window * scale).astype(np.float32)
    kernels.setflags(write=False)
    return kernels, orig, new, width


def resample(audio: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> torch.Tensor:
    """Polyphase sinc resampling along the last axis, any leading dims:
    (..., n) -> (..., ceil(n * new / orig)), computed in fp32 and returned in
    the input's dtype."""
    if orig_freq == new_freq:
        return audio
    lead = audio.shape[:-1]
    x = audio.reshape(-1, audio.shape[-1])
    kernels, orig, new, width = _sinc_resample_kernel(orig_freq, new_freq,
                                                      lowpass_filter_width, rolloff)
    b, n = x.shape
    target_length = math.ceil(new * n / orig)
    x = F.pad(x.float(), (width, width + orig))
    weight = torch.from_numpy(kernels.copy()).to(x.device)[:, None, :]  # (new, 1, k)
    out = F.conv1d(x[:, None, :], weight, stride=orig)  # (b, new, frames)
    out = out.transpose(1, 2).reshape(b, -1)[:, :target_length]
    return out.to(audio.dtype).reshape(*lead, target_length)


def resample_np(audio: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Host-side wrapper for the data pipeline (numpy in, numpy out, CPU)."""
    return resample(torch.from_numpy(np.ascontiguousarray(audio)), orig_freq, new_freq).numpy()
