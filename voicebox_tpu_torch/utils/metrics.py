"""Evaluation metrics.

Counterpart of `voicebox_tpu/utils/metrics.py`. `mel_spectral_distance` is
the quality metric of BASELINE.json's north star: the L2 distance between
log-mel spectrograms of two waveforms, through the same mel chain the codec
uses (`ops/stft.py::mel_spectrogram`, torchaudio semantics). Both functions
run on the device of the wave they are given.
"""

from __future__ import annotations

import torch

from ..ops.stft import amplitude_to_db, mel_spectrogram

__all__ = ["log_mel", "mel_spectral_distance"]


def log_mel(
    wav: torch.Tensor,
    sample_rate: int = 24000,
    n_mels: int = 100,
    n_fft: int = 1024,
    win_length: int = 640,
    hop_length: int = 160,
    f_max: float = 8000.0,
) -> torch.Tensor:
    """(b, n) or (n,) wave -> (b, n_mels, frames) log-mel (dB)."""
    wav = torch.as_tensor(wav)
    if wav.dim() == 1:
        wav = wav[None]
    mel = mel_spectrogram(
        wav, n_mels=n_mels, sample_rate=sample_rate, f_max=f_max,
        n_fft=n_fft, win_length=win_length, hop_length=hop_length,
    )
    return amplitude_to_db(mel)


def mel_spectral_distance(wav_a, wav_b, **mel_kwargs) -> torch.Tensor:
    """Mean over frames of the L2 distance between per-frame log-mel vectors
    of two waveforms ((b, n) or (n,)), truncated to the common length. A
    scalar tensor in dB."""
    wav_a, wav_b = torch.as_tensor(wav_a), torch.as_tensor(wav_b)
    wav_a = wav_a[None] if wav_a.dim() == 1 else wav_a
    wav_b = wav_b[None] if wav_b.dim() == 1 else wav_b
    n = min(wav_a.shape[-1], wav_b.shape[-1])
    ma = log_mel(wav_a[..., :n], **mel_kwargs)
    mb = log_mel(wav_b[..., :n], **mel_kwargs)
    return (ma - mb).square().sum(dim=1).sqrt().mean()
