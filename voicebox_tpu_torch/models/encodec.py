"""The Encodec codec: SEANet encoder and decoder, and residual vector
quantisation of their latents.

Counterpart of `voicebox_tpu/models/encodec.py`:

* `SEANetEncoder`: (b, n) audio -> (b, n / prod(ratios), dim) latents. A
  causal k7 stem, then per ratio (applied reversed: 2, 4, 5, 8) a residual
  unit (ELU, causal k3 conv to half width, ELU, k1 conv back, plus the
  input), ELU and a causal strided conv (kernel 2 r, stride r) doubling the
  channels; a two-layer LSTM with a skip; ELU and a causal k7 head. Causal
  means a left pad of kernel - stride, as the JAX package pads (it leaves
  out upstream's extra right pad of a last partial frame);
* `SEANetDecoder`: the mirror, with transposed convs whose non-causal tail
  (kernel - stride samples) is cut from the right;
* `ResidualVQ`: each of the q codebooks quantises the residual of the
  previous stage by its nearest entry. The distance is the JAX package's
  `||c||^2 - 2 r.c` (the `||r||^2` term does not change the argmin), so a
  code chosen here is the code chosen there up to rounding at a near tie;
* `EncodecModel`: the three together (`encode`, `rq`, `decode_latents`,
  `decode_codes`, `forward(return_encoded=)`).

State-dict keys are upstream facebook/encodec's (`encoder.model.{i}.conv.
conv.weight`, `….block.1.conv.conv.weight`, `….lstm.weight_ih_l{n}`,
`decoder.model.{i}.convtr.convtr.weight`) with the weight norm fused into
`weight`; the ELUs hold the other indices of `model`. The LSTM is
`nn.LSTM` (gates [i, f, g, o]); `utils/convert.py` packs the JAX package's
per-gate flax Denses into it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "CausalConv1d",
    "CausalConvTranspose1d",
    "EncodecModel",
    "ResidualUnit",
    "ResidualVQ",
    "SEANetDecoder",
    "SEANetEncoder",
]


def _causal_pad(x: torch.Tensor, kernel_size: int, stride: int = 1) -> torch.Tensor:
    """Left-pad the time axis of (b, c, t) by kernel - stride."""
    pad = kernel_size - stride
    return F.pad(x, (pad, 0)) if pad > 0 else x


class _Conv(nn.Module):
    """Holds the conv at upstream's `.conv` (its NormConv1d) key."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv


class CausalConv1d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.conv = _Conv(nn.Conv1d(in_channels, out_channels, kernel_size, stride=stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (b, c, t)
        return self.conv.conv(_causal_pad(x, self.kernel_size, self.stride))


class CausalConvTranspose1d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int):
        super().__init__()
        self.extra = kernel_size - stride
        convtr = nn.ConvTranspose1d(in_channels, out_channels, kernel_size, stride=stride)
        self.convtr = nn.Module()
        self.convtr.convtr = convtr

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (b, c, t) -> (b, c', t * stride)
        y = self.convtr.convtr(x)
        return y[..., :-self.extra] if self.extra > 0 else y


class ResidualUnit(nn.Module):
    """x + conv_k1(elu(conv_k3(elu(x)))), the convs at `block.1` / `block.3`."""

    def __init__(self, dim: int):
        super().__init__()
        self.block = nn.ModuleList([nn.ELU(), CausalConv1d(dim, dim // 2, 3), nn.ELU(),
                                    CausalConv1d(dim // 2, dim, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.block:
            h = layer(h)
        return x + h


class _LSTM(nn.Module):
    """Two stacked LSTMs over time with a skip (upstream SLSTM), on (b, c, t)."""

    def __init__(self, features: int, num_layers: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(features, features, num_layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = x.permute(2, 0, 1)  # (t, b, c)
        y, _ = self.lstm(seq)
        return (y + seq).permute(1, 2, 0)


def _run(model: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for layer in model:
        x = layer(x)
    return x


class SEANetEncoder(nn.Module):
    def __init__(self, channels: int = 1, dim: int = 128, n_filters: int = 32,
                 ratios: Sequence[int] = (8, 5, 4, 2)):
        super().__init__()
        mult = 1
        layers = [CausalConv1d(channels, n_filters, 7)]
        for ratio in reversed(tuple(ratios)):
            layers += [ResidualUnit(mult * n_filters), nn.ELU(),
                       CausalConv1d(mult * n_filters, mult * n_filters * 2, ratio * 2, ratio)]
            mult *= 2
        layers += [_LSTM(mult * n_filters), nn.ELU(), CausalConv1d(mult * n_filters, dim, 7)]
        self.model = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(b, n) or (b, 1, n) audio -> (b, n / prod(ratios), dim)."""
        if x.dim() == 2:
            x = x[:, None, :]
        return _run(self.model, x).transpose(1, 2)


class SEANetDecoder(nn.Module):
    def __init__(self, channels: int = 1, dim: int = 128, n_filters: int = 32,
                 ratios: Sequence[int] = (8, 5, 4, 2)):
        super().__init__()
        mult = 2 ** len(ratios)
        layers = [CausalConv1d(dim, mult * n_filters, 7), _LSTM(mult * n_filters)]
        for ratio in ratios:
            layers += [nn.ELU(),
                       CausalConvTranspose1d(mult * n_filters, mult * n_filters // 2,
                                             ratio * 2, ratio),
                       ResidualUnit(mult * n_filters // 2)]
            mult //= 2
        layers += [nn.ELU(), CausalConv1d(n_filters, channels, 7)]
        self.model = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(b, t, dim) latents -> (b, t * prod(ratios)) audio."""
        return _run(self.model, x.transpose(1, 2))[:, 0]


class ResidualVQ(nn.Module):
    def __init__(self, num_quantizers: int = 8, codebook_size: int = 1024, dim: int = 128):
        super().__init__()
        self.codebooks = nn.Parameter(torch.randn(num_quantizers, codebook_size, dim))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (b, n, dim) -> (quantized (b, n, dim), codes (b, n, q), commit loss)."""
        residual = x
        quantized = torch.zeros_like(x)
        codes = []
        for codebook in self.codebooks:
            dist = codebook.square().sum(dim=-1) - 2 * torch.matmul(residual, codebook.T)
            idx = dist.argmin(dim=-1)  # (b, n); the first index on a tie
            q = codebook[idx]
            residual = residual - q
            quantized = quantized + q
            codes.append(idx)
        return quantized, torch.stack(codes, dim=-1), residual.square().mean()


class EncodecModel(nn.Module):
    """The Encodec 24 kHz codec at its production geometry by default
    (n_filters 32, ratios 8/5/4/2: hop 320, 128-dim latents, RVQ 8 x 1024)."""

    sampling_rate = 24000

    def __init__(self, dim: int = 128, n_filters: int = 32,
                 ratios: Sequence[int] = (8, 5, 4, 2), num_quantizers: int = 8,
                 codebook_size: int = 1024):
        super().__init__()
        self.codebook_dim = dim
        self.num_quantizers = num_quantizers
        self.ratios = tuple(ratios)
        self.encoder = SEANetEncoder(dim=dim, n_filters=n_filters, ratios=ratios)
        self.decoder = SEANetDecoder(dim=dim, n_filters=n_filters, ratios=ratios)
        self.quantizer = ResidualVQ(num_quantizers, codebook_size, dim)

    @property
    def downsample_factor(self) -> int:
        out = 1
        for r in self.ratios:
            out *= r
        return out

    @torch.no_grad()
    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """(b, n) or (b, 1, n) audio -> (b, n / hop, codebook_dim) latents."""
        return self.encoder(audio)

    @torch.no_grad()
    def rq(self, latents: torch.Tensor):
        """latents -> (quantized, codes (b, n, q), commit loss)."""
        return self.quantizer(latents)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.rq(latents)[0])

    @torch.no_grad()
    def decode_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (b, n, q) -> audio (b, n * hop)."""
        books = self.quantizer.codebooks[: codes.shape[-1]]  # (q, size, dim)
        q_idx = torch.arange(codes.shape[-1], device=codes.device)
        quantized = books[q_idx[:, None, None], codes.permute(2, 0, 1)].sum(dim=0)
        return self.decoder(quantized)

    @torch.no_grad()
    def forward(self, audio: torch.Tensor, return_encoded: bool = False):
        latents = self.encode(audio)
        if return_encoded:
            return latents, None, None
        quantized, codes, _ = self.rq(latents)
        return self.decoder(quantized), codes, None
