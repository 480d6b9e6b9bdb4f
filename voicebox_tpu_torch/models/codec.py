"""The audio codec boundary: `AudioEncoderDecoder` and `EncodecVoco`.

Counterpart of `voicebox_tpu/models/codec.py`. `EncodecVoco.decode` is the
serving path's last stage, batched: RVQ-quantise the latents to codes,
Vocos `codes_to_features`, Vocos decode with the bandwidth id, iSTFT,
returning (b, 1, n * 320) at the encodec geometry. Encoding raw audio needs
the SEANet encoder, which is not ported yet; `MelVoco` neither.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .encodec import ResidualVQ
from .vocos import Vocos

__all__ = ["AudioEncoderDecoder", "EncodecVoco"]


class AudioEncoderDecoder(nn.Module):
    """Base of the codecs: a latent frame rate and width, encode, decode."""

    sampling_rate: int
    latent_dim: int
    downsample_factor: int

    @property
    def seconds_per_frame(self) -> float:
        """Audio seconds one latent frame covers (hop / sampling rate)."""
        return self.downsample_factor / self.sampling_rate

    def frames_for_seconds(self, seconds: float) -> int:
        """Latent frames spanning `seconds` of audio, at least 1."""
        if seconds <= 0:
            raise ValueError(f"duration must be positive, got {seconds}")
        return max(1, round(seconds / self.seconds_per_frame))

    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class EncodecVoco(AudioEncoderDecoder):
    """Encodec latents decoded by Vocos. `quantizer` and `vocos` default to
    the production geometry (RVQ 8 x 1024 x 128, vocos-encodec-24khz);
    `ratios` are Encodec's strides, whose product is the frame hop (320)."""

    def __init__(
        self,
        *,
        quantizer: Optional[ResidualVQ] = None,
        vocos: Optional[Vocos] = None,
        bandwidth_id: int = 2,
        sampling_rate: int = 24000,
        ratios: Sequence[int] = (8, 5, 4, 2),
    ):
        super().__init__()
        self.quantizer = quantizer if quantizer is not None else ResidualVQ()
        self.vocos = vocos if vocos is not None else Vocos.encodec_24khz()
        self.bandwidth_id = bandwidth_id
        self.sampling_rate = sampling_rate
        self.downsample_factor = 1
        for r in ratios:
            self.downsample_factor *= r

    @property
    def latent_dim(self) -> int:
        return self.quantizer.codebooks.shape[-1]

    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "encoding raw audio needs the SEANet encoder, not ported yet "
            "(ROADMAP Queue 1, item 9)"
        )

    @torch.no_grad()
    def decode_to_codes(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (b, n, dim) -> codes (b, q, n)."""
        _, codes, _ = self.quantizer(latents)
        return codes.transpose(1, 2)

    @torch.no_grad()
    def decode_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (b, q, n) -> audio (b, 1, n * hop)."""
        feats = self.vocos.codes_to_features(codes)
        bw = torch.tensor([self.bandwidth_id], device=codes.device)
        return self.vocos.decode(feats, bw)[:, None, :]

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (b, n, dim) -> audio (b, 1, n * hop)."""
        return self.decode_codes(self.decode_to_codes(latents))
