"""Vocos vocoder: ConvNeXt backbone + iSTFT head, in fp32.

Counterpart of `voicebox_tpu/models/vocos.py`: Conv1d embed -> LayerNorm
(AdaLayerNorm on the bandwidth id for the encodec variant) -> ConvNeXt
blocks (depthwise k7 conv, norm, 1x1 up, exact GELU, 1x1 down, layer-scale
residual) -> LayerNorm -> Linear to n_fft + 2 -> magnitude exp clipped at
100 and phase -> 'same'-padded iSTFT. The encodec variant also maps RVQ
codes to features as a sum of per-quantizer embeddings.

State-dict keys follow the upstream Vocos checkpoint layout
(`backbone.embed`, `backbone.norm`, `backbone.convnext.{i}.*`,
`backbone.final_layer_norm`, `head.out`,
`feature_extractor.codebook_weights`); `Vocos.from_pretrained` loads a
local upstream checkpoint, or builds a published geometry at random init
when the name is not a file (nothing is downloaded).
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stft import hann_window, istft

__all__ = ["AdaLayerNorm", "ConvNeXtBlock", "VocosBackbone", "ISTFTHead", "Vocos"]

_LN_EPS = 1e-6


class AdaLayerNorm(nn.Module):
    """LayerNorm without affine, then per-bandwidth scale and shift rows."""

    def __init__(self, num_embeddings: int, dim: int):
        super().__init__()
        self.dim = dim
        self.scale = nn.Embedding(num_embeddings, dim)
        self.shift = nn.Embedding(num_embeddings, dim)
        nn.init.ones_(self.scale.weight)
        nn.init.zeros_(self.shift.weight)

    def forward(self, x: torch.Tensor, bandwidth_id: torch.Tensor) -> torch.Tensor:
        x = F.layer_norm(x, (self.dim,), eps=_LN_EPS)
        return x * self.scale(bandwidth_id)[:, None, :] + self.shift(bandwidth_id)[:, None, :]


def _norm(dim: int, num_bandwidths: int) -> nn.Module:
    if num_bandwidths > 0:
        return AdaLayerNorm(num_bandwidths, dim)
    return nn.LayerNorm(dim, eps=_LN_EPS)


def _apply_norm(norm: nn.Module, x, bandwidth_id):
    if isinstance(norm, AdaLayerNorm):
        return norm(x, bandwidth_id)
    return norm(x)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int, layer_scale_init: float,
                 num_bandwidths: int = 0):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, kernel_size=7, padding=3, groups=dim)
        self.norm = _norm(dim, num_bandwidths)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x: torch.Tensor, bandwidth_id=None) -> torch.Tensor:  # (b, n, dim)
        residual = x
        x = self.dwconv(x.transpose(1, 2)).transpose(1, 2)
        x = _apply_norm(self.norm, x, bandwidth_id)
        x = self.pwconv2(F.gelu(self.pwconv1(x)))
        return residual + self.gamma * x


class VocosBackbone(nn.Module):
    def __init__(self, input_channels: int = 100, dim: int = 512,
                 intermediate_dim: int = 1536, num_layers: int = 8,
                 num_bandwidths: int = 0):
        super().__init__()
        self.num_bandwidths = num_bandwidths
        self.embed = nn.Conv1d(input_channels, dim, kernel_size=7, padding=3)
        self.norm = _norm(dim, num_bandwidths)
        self.convnext = nn.ModuleList([
            ConvNeXtBlock(dim, intermediate_dim, 1.0 / num_layers, num_bandwidths)
            for _ in range(num_layers)
        ])
        self.final_layer_norm = nn.LayerNorm(dim, eps=_LN_EPS)

    def forward(self, x: torch.Tensor, bandwidth_id=None) -> torch.Tensor:
        # x: (b, input_channels, n) -> (b, n, dim)
        if self.num_bandwidths > 0:
            assert bandwidth_id is not None
            bandwidth_id = torch.as_tensor(bandwidth_id, device=x.device).reshape(-1)
            if bandwidth_id.shape[0] == 1:
                bandwidth_id = bandwidth_id.expand(x.shape[0])
        x = self.embed(x).transpose(1, 2)
        x = _apply_norm(self.norm, x, bandwidth_id)
        for block in self.convnext:
            x = block(x, bandwidth_id)
        return self.final_layer_norm(x)


class ISTFTHead(nn.Module):
    def __init__(self, dim: int = 512, n_fft: int = 1024, hop_length: int = 256):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length
        self.out = nn.Linear(dim, n_fft + 2)
        self.register_buffer("window", hann_window(n_fft), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (b, n, dim) -> (b, n * hop)
        mag, phase = self.out(x).float().chunk(2, dim=-1)
        # the magnitude is clipped at 1e2, not the exponent (exp(100) is inf)
        mag = mag.exp().clamp_max(100.0)
        spec = torch.complex(mag * phase.cos(), mag * phase.sin()).transpose(1, 2)
        return istft(spec, self.n_fft, self.hop_length, window=self.window)


class EncodecFeatures(nn.Module):
    """RVQ codes -> features: the sum of one embedding per quantizer, from one
    concatenated (num_quantizers * codebook_size, dim) table."""

    def __init__(self, num_quantizers: int, codebook_size: int, dim: int):
        super().__init__()
        self.codebook_size = codebook_size
        self.codebook_weights = nn.Parameter(
            torch.randn(num_quantizers * codebook_size, dim) * 0.02
        )

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        # codes (b, q, n) -> (b, dim, n)
        offsets = torch.arange(codes.shape[1], device=codes.device) * self.codebook_size
        emb = F.embedding(codes + offsets[None, :, None], self.codebook_weights)
        return emb.sum(dim=1).transpose(1, 2)


class Vocos(nn.Module):
    """The vocoder. `Vocos.encodec_24khz()` builds the vocos-encodec-24khz
    geometry (input 128, dim 512, intermediate 1536, 8 layers, n_fft 1280,
    hop 320, 4 bandwidths), `Vocos.mel_24khz()` the vocos-mel-24khz one
    (input 100 mels, n_fft 1024, hop 256, no bandwidths)."""

    def __init__(self, input_channels: int = 100, dim: int = 512,
                 intermediate_dim: int = 1536, num_layers: int = 8, n_fft: int = 1024,
                 hop_length: int = 256, num_bandwidths: int = 0,
                 codebook_size: int = 1024, num_quantizers: int = 8):
        super().__init__()
        self.input_channels = input_channels
        self.hop_length = hop_length
        self.num_bandwidths = num_bandwidths
        self.backbone = VocosBackbone(input_channels, dim, intermediate_dim, num_layers,
                                      num_bandwidths)
        self.head = ISTFTHead(dim, n_fft, hop_length)
        if num_bandwidths > 0:
            self.feature_extractor = EncodecFeatures(num_quantizers, codebook_size,
                                                     input_channels)

    @classmethod
    def from_pretrained(cls, path_or_name: str, **kwargs) -> "Vocos":
        """A Vocos of a published geometry, from a local upstream checkpoint
        when `path_or_name` is a file, else at random init (no download). A
        name ending in `vocos-encodec-24khz` takes that geometry (input 128,
        4 bandwidths, n_fft 1280, hop 320), any other vocos-mel-24khz's
        (input 100, n_fft 1024, hop 256); `kwargs` override the rest of the
        constructor's arguments. A checkpoint's keys that this module lacks
        (the upstream encodec feature extractor, the iSTFT window) are
        skipped, and a parameter the file lacks keeps its init, with a
        warning."""
        if path_or_name.endswith("vocos-encodec-24khz"):
            kwargs.setdefault("n_fft", 1280)
            kwargs.setdefault("hop_length", 320)
            model = cls(input_channels=128, num_bandwidths=4, **kwargs)
        else:
            model = cls(input_channels=100, **kwargs)
        if os.path.exists(path_or_name):
            try:
                sd = torch.load(path_or_name, map_location="cpu", weights_only=True)
            except Exception:
                warnings.warn(f"torch.load(weights_only=True) failed for {path_or_name!r}; "
                              "loading it with the full unpickler: only for trusted files",
                              stacklevel=2)
                sd = torch.load(path_or_name, map_location="cpu", weights_only=False)
            for wrapper in ("state_dict", "model"):
                if wrapper in sd and isinstance(sd[wrapper], dict):
                    sd = sd[wrapper]
            own = model.state_dict()
            found = {k: v for k, v in sd.items() if k in own}
            missing = sorted(set(own) - set(found))
            if missing:
                warnings.warn(f"{path_or_name}: {len(missing)} tensors not in the checkpoint "
                              f"keep their init: {missing[:5]}", stacklevel=2)
            model.load_state_dict(found, strict=False)
        return model

    @classmethod
    def encodec_24khz(cls) -> "Vocos":
        return cls(input_channels=128, num_bandwidths=4, n_fft=1280, hop_length=320)

    @classmethod
    def mel_24khz(cls) -> "Vocos":
        """The vocos-mel-24khz geometry: 100 mel bins in, n_fft 1024, hop 256,
        plain LayerNorms (no bandwidth embedding)."""
        return cls(input_channels=100, n_fft=1024, hop_length=256)

    def decode(self, features: torch.Tensor,
               bandwidth_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        """features (b, input_channels, n) -> audio (b, n * hop_length)."""
        return self.head(self.backbone(features, bandwidth_id))

    def codes_to_features(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (b, q, n) -> features (b, input_channels, n)."""
        assert self.num_bandwidths > 0, "codes_to_features is an encodec-variant op"
        return self.feature_extractor(codes)
