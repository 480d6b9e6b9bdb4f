"""Inverse STFT by overlap-add, the Vocos head's last step.

Counterpart of `voicebox_tpu/ops/stft.py::hann_window` and `istft`. The JAX
package builds the inverse DFT from cos/sin matmuls and the overlap-add from
shifted dense adds, because its TPU backend had no FFT and slow scatters.
Here the inverse real DFT is `torch.fft.irfft` (it drops the imaginary parts
of the DC and Nyquist bins, as the JAX basis does) and the overlap-add is
`F.fold`. Only the Vocos head's 'same' padding is ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["hann_window", "istft"]


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window's default), fp32."""
    return torch.hann_window(win_length, periodic=True, device=device)


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
