"""The audio codec boundary: `AudioEncoderDecoder`, `MelVoco` and
`EncodecVoco`.

Counterpart of `voicebox_tpu/models/codec.py`:

* `MelVoco.encode`: Spectrogram (n_fft 1024, win 640, the vocoder's hop,
  Hann, power 2) -> MelScale (100 mels, 24 kHz, f_max 8 kHz, HTK) ->
  AmplitudeToDB -> (b, frames, n_mels), frames = n // hop + 1 (so
  `frame_offset` is 1). `hop_length=None` takes the vocoder's hop, the JAX
  package's fix of the reference's 160 / 256 mismatch (another hop warns:
  decoded audio would be longer or shorter than the input);
* `MelVoco.decode`: DB_to_amplitude(ref 1, power 0.5) -> Vocos (the
  vocos-mel-24khz geometry by default) -> (b, frames * hop);
* `EncodecVoco.encode`: the SEANet encoder -> (b, n / 320, 128) continuous
  latents (the reference's `return_encoded=True`);
* `EncodecVoco.decode`: batched RVQ-quantise to codes, Vocos
  `codes_to_features`, Vocos decode with the bandwidth id, iSTFT, returning
  (b, 1, n * 320) at the Encodec geometry.

Both codecs are frozen: encode and decode run under `no_grad`.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.stft import amplitude_to_db, db_to_amplitude, mel_spectrogram
from .encodec import ResidualVQ, SEANetEncoder
from .vocos import Vocos

__all__ = ["AudioEncoderDecoder", "EncodecVoco", "MelVoco", "frame_mask"]


class AudioEncoderDecoder(nn.Module):
    """Base of the codecs: a latent frame rate and width, encode, decode."""

    sampling_rate: int
    latent_dim: int
    downsample_factor: int
    # frames(n samples) = n // downsample_factor + frame_offset: the
    # trainer's register-aligned buckets in samples use it
    frame_offset: int = 0

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


def frame_mask(sample_mask: torch.Tensor, frames: int) -> torch.Tensor:
    """The (b, frames) mask of latents encoded from padded waves whose
    (b, samples) `sample_mask` marks the real samples: ceil(len / ds) real
    frames a row, ds = samples / frames (the JAX trainers' rule, in float64
    as numpy computes it)."""
    lengths = sample_mask.sum(dim=-1).double()
    real = torch.ceil(lengths / (sample_mask.shape[-1] / frames))
    return torch.arange(frames, device=sample_mask.device)[None, :] < real[:, None]


def _mono(audio: torch.Tensor) -> torch.Tensor:
    """(b, 1, n) -> (b, n); (b, n) as it is."""
    return audio[:, 0, :] if audio.dim() == 3 and audio.shape[1] == 1 else audio


class MelVoco(AudioEncoderDecoder):
    """Log-mel latents, decoded by a mel Vocos."""

    frame_offset = 1  # center=True framing: n // hop + 1 frames

    def __init__(
        self,
        *,
        log: bool = True,
        n_mels: int = 100,
        sampling_rate: int = 24000,
        f_max: float = 8000,
        n_fft: int = 1024,
        win_length: int = 640,
        hop_length: Optional[int] = None,  # None: the vocoder's hop
        vocos: Optional[Vocos] = None,
    ):
        super().__init__()
        self.log = log
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.f_max = f_max
        self.win_length = win_length
        self.sampling_rate = sampling_rate
        self.vocos = vocos if vocos is not None else Vocos.mel_24khz()
        if self.vocos.input_channels != n_mels:
            raise ValueError(
                f"n_mels={n_mels} but the vocoder consumes {self.vocos.input_channels}-bin "
                "mels; pass a matching Vocos(input_channels=n_mels)"
            )
        self.hop_length = hop_length if hop_length is not None else self.vocos.hop_length
        if self.hop_length != self.vocos.hop_length:
            warnings.warn(
                f"MelVoco hop_length {self.hop_length} != vocoder hop {self.vocos.hop_length}: "
                f"decoded audio duration will be scaled by "
                f"{self.vocos.hop_length / self.hop_length:.3f}x",
                stacklevel=2,
            )

    @property
    def downsample_factor(self) -> int:
        return self.hop_length

    @property
    def latent_dim(self) -> int:
        return self.n_mels

    @torch.no_grad()
    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """(b, n) or (b, 1, n) audio -> (b, n // hop + 1, n_mels) log-mel."""
        mel = mel_spectrogram(_mono(audio), n_mels=self.n_mels, sample_rate=self.sampling_rate,
                              f_max=self.f_max, n_fft=self.n_fft, win_length=self.win_length,
                              hop_length=self.hop_length)
        if self.log:
            mel = amplitude_to_db(mel)
        return mel.transpose(1, 2)

    @torch.no_grad()
    def decode(self, mel: torch.Tensor) -> torch.Tensor:
        """(b, frames, n_mels) -> audio (b, frames * vocoder hop)."""
        mel = mel.float().transpose(1, 2)
        if self.log:
            mel = db_to_amplitude(mel, ref=1.0, power=0.5)
        return self.vocos.decode(mel)


class EncodecVoco(AudioEncoderDecoder):
    """Encodec latents from the SEANet encoder, decoded by RVQ and Vocos.
    `quantizer`, `vocos` and `encoder` default to the production geometry
    (RVQ 8 x 1024 x 128, vocos-encodec-24khz, SEANet n_filters 32); `ratios`
    are Encodec's strides, whose product is the frame hop (320). The
    state-dict keys are `encoder.model.*` (upstream's layout), `quantizer.
    codebooks` and `vocos.*`."""

    def __init__(
        self,
        *,
        quantizer: Optional[ResidualVQ] = None,
        vocos: Optional[Vocos] = None,
        encoder: Optional[SEANetEncoder] = None,
        bandwidth_id: int = 2,
        sampling_rate: int = 24000,
        ratios: Sequence[int] = (8, 5, 4, 2),
        n_filters: int = 32,
    ):
        super().__init__()
        self.quantizer = quantizer if quantizer is not None else ResidualVQ()
        self.vocos = vocos if vocos is not None else Vocos.encodec_24khz()
        self.encoder = encoder if encoder is not None else SEANetEncoder(
            dim=self.latent_dim, n_filters=n_filters, ratios=ratios)
        self.bandwidth_id = bandwidth_id
        self.sampling_rate = sampling_rate
        self.downsample_factor = 1
        for r in ratios:
            self.downsample_factor *= r

    @property
    def latent_dim(self) -> int:
        return self.quantizer.codebooks.shape[-1]

    @torch.no_grad()
    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """(b, n) or (b, 1, n) audio -> (b, n / hop, latent_dim) latents."""
        return self.encoder(_mono(audio).float())

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
