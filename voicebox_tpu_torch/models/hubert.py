"""HubertWithKmeans: the frozen speech -> semantic-token quantiser.

Counterpart of `voicebox_tpu/models/hubert.py`: `wav (b, n) at 16 kHz ->
semantic ids (b, n / 320)`, with `target_sample_hz` and `downsample_factor`
for the conditioning-length algebra of the sampler. Modules and state-dict
keys are `transformers`' `HubertModel` (`feature_extractor.conv_layers.{i}`,
`feature_projection`, `encoder.pos_conv_embed`, `encoder.layers.{i}`), so
an upstream state dict loads through `utils/convert.py::
load_hubert_state_dict`; the k-means centres are the buffer
`cluster_centers`.

* 7 strided convs (total stride 320), exact GELU. Base models
  (`extractor_norm_mode="group"`): no conv bias and a GroupNorm with one
  group per channel (each channel normalised over time) after conv 0 only.
  Large models (`"layer"`): biased convs, a channel LayerNorm after each;
* the feature projection: LayerNorm(conv_dim), Linear(conv_dim -> dim);
* the weight-normed grouped conv positional embedding (kernel 128, 16
  groups; `weight = g v / ||v||`, the norm over the output and input axes,
  `parametrizations.weight.original0/1`), padded k / 2 on both sides, its
  last frame dropped for an even kernel, exact GELU, residual;
* base: LayerNorm, then post-norm blocks. Large (`layer_norm_first`):
  pre-norm blocks and one LayerNorm at the very end, skipped when
  `output_layer` truncates the stack (fairseq's `extract_features(...,
  output_layer=k)` returns the residual stream after block k);
* each block: biased q/k/v/out projections (q scaled by d^-0.5 after its
  bias), softmax attention in torch ops with masked keys at
  `finfo.min`, LayerNorm, Linear -> exact GELU -> Linear, LayerNorm.

Ids are the argmin over `|f|^2 - 2 f c^T + |c|^2`, in that order, as the JAX
package sums them. The model is frozen: its parameters take no gradient.
Random weights of the given geometry unless `checkpoint_path` names a
torch state dict; `kmeans_path` loads a joblib-dumped sklearn k-means (joblib
is imported only then), `fit_kmeans` fits one (`utils/kmeans.py`).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "HubertEncoder",
    "HubertEncoderLayer",
    "HubertFeatureExtractor",
    "HubertWithKmeans",
]

_EPS = 1e-5


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, norm: Optional[str]):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride=stride, bias=(norm == "layer"))
        if norm == "layer":
            self.layer_norm = nn.LayerNorm(c_out, eps=_EPS)
        elif norm == "group":
            self.layer_norm = nn.GroupNorm(c_out, c_out, eps=_EPS)
        self.norm = norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (b, c, t)
        x = self.conv(x)
        if self.norm == "layer":
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        elif self.norm == "group":
            x = self.layer_norm(x)
        return F.gelu(x)


class HubertFeatureExtractor(nn.Module):
    """(b, n) -> (b, frames, conv_dim), total stride 320."""

    def __init__(self, conv_dim: int = 512, kernels: Sequence[int] = (10, 3, 3, 3, 3, 2, 2),
                 strides: Sequence[int] = (5, 2, 2, 2, 2, 2, 2), norm_mode: str = "group"):
        super().__init__()
        if norm_mode not in ("group", "layer"):
            raise ValueError(f"norm_mode must be 'group' or 'layer', got {norm_mode!r}")
        self.kernels, self.strides = tuple(kernels), tuple(strides)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(1 if i == 0 else conv_dim, conv_dim, k, s,
                       "layer" if norm_mode == "layer" else ("group" if i == 0 else None))
            for i, (k, s) in enumerate(zip(self.kernels, self.strides)))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


class _FeatureProjection(nn.Module):
    def __init__(self, conv_dim: int, dim: int):
        super().__init__()
        self.layer_norm = nn.LayerNorm(conv_dim, eps=_EPS)
        self.projection = nn.Linear(conv_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(dim, dim)
                                                                for _ in range(4))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, dim = x.shape
        h = self.heads
        d = dim // h
        q = self.q_proj(x) * d ** -0.5  # scaled after its bias, as torch's MHA
        q, k, v = (t.reshape(b, n, h, d).transpose(1, 2)
                   for t in (q, self.k_proj(x), self.v_proj(x)))
        scores = q @ k.transpose(-1, -2)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :], torch.finfo(scores.dtype).min)
        out = scores.softmax(dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, n, dim))


class _FeedForward(nn.Module):
    def __init__(self, dim: int, ff_dim: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(dim, ff_dim)
        self.output_dense = nn.Linear(ff_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class HubertEncoderLayer(nn.Module):
    """One block: post-norm (base) or pre-norm (`pre_norm`, large)."""

    def __init__(self, dim: int = 768, heads: int = 12, ff_dim: int = 3072,
                 pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.attention = _Attention(dim, heads)
        self.layer_norm = nn.LayerNorm(dim, eps=_EPS)
        self.feed_forward = _FeedForward(dim, ff_dim)
        self.final_layer_norm = nn.LayerNorm(dim, eps=_EPS)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.pre_norm:
            x = x + self.attention(self.layer_norm(x), mask)
            return x + self.feed_forward(self.final_layer_norm(x))
        x = self.layer_norm(x + self.attention(x, mask))
        return self.final_layer_norm(x + self.feed_forward(x))


class _PosConvEmbed(nn.Module):
    def __init__(self, dim: int, kernel: int, groups: int):
        super().__init__()
        conv = nn.Conv1d(dim, dim, kernel, padding=kernel // 2, groups=groups)
        # g over the kernel axis (weight_norm dim=2), as wav2vec2 / HuBERT
        self.conv = nn.utils.parametrizations.weight_norm(conv, name="weight", dim=2)
        self.drop_last = kernel % 2 == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (b, n, dim)
        pos = self.conv(x.transpose(1, 2))
        if self.drop_last:
            pos = pos[..., :-1]
        return F.gelu(pos).transpose(1, 2)


class HubertEncoder(nn.Module):
    """Positional conv, then `depth` blocks, with the outer LayerNorm before
    them (base) or after them (`layer_norm_first`, when
    `apply_final_norm`)."""

    def __init__(self, dim: int = 768, depth: int = 12, heads: int = 12,
                 ff_dim: Optional[int] = None, conv_pos_kernel: int = 128,
                 conv_pos_groups: int = 16, layer_norm_first: bool = False,
                 apply_final_norm: bool = True):
        super().__init__()
        self.layer_norm_first = layer_norm_first
        self.pos_conv_embed = _PosConvEmbed(dim, conv_pos_kernel, conv_pos_groups)
        self.apply_outer_norm = not layer_norm_first or apply_final_norm
        if self.apply_outer_norm:
            self.layer_norm = nn.LayerNorm(dim, eps=_EPS)
        ff_dim = ff_dim if ff_dim is not None else 4 * dim
        self.layers = nn.ModuleList(HubertEncoderLayer(dim, heads, ff_dim, layer_norm_first)
                                    for _ in range(depth))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.pos_conv_embed(x)
        if not self.layer_norm_first:
            x = self.layer_norm(x)
        for layer in self.layers:
            x = layer(x, mask)
        if self.layer_norm_first and self.apply_outer_norm:
            x = self.layer_norm(x)
        return x


class HubertWithKmeans(nn.Module):
    """Frozen HuBERT features + k-means token assignment. `output_layer`
    (None: all `depth` blocks) builds only the first k blocks; pass 9 with a
    base geometry for audiolm-pytorch's layer-9 k-means vocabularies."""

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        kmeans_path: Optional[str] = None,
        num_clusters: int = 500,
        target_sample_hz: int = 16000,
        seq_len_multiple_of: Optional[int] = None,
        conv_dim: int = 512,
        dim: int = 768,
        depth: int = 12,
        heads: int = 12,
        ff_dim: Optional[int] = None,
        conv_pos_kernel: int = 128,
        conv_pos_groups: int = 16,
        layer_norm_first: bool = False,
        extractor_norm_mode: str = "group",
        output_layer: Optional[int] = None,
    ):
        super().__init__()
        self.target_sample_hz = target_sample_hz
        self.seq_len_multiple_of = seq_len_multiple_of
        self.num_clusters = self.codebook_size = num_clusters
        if output_layer is not None:
            if not 1 <= output_layer <= depth:
                raise ValueError(f"output_layer {output_layer} outside [1, depth={depth}]")
            depth = output_layer
        self.feature_extractor = HubertFeatureExtractor(conv_dim=conv_dim,
                                                        norm_mode=extractor_norm_mode)
        self.feature_projection = _FeatureProjection(conv_dim, dim)
        self.encoder = HubertEncoder(
            dim=dim, depth=depth, heads=heads, ff_dim=ff_dim, conv_pos_kernel=conv_pos_kernel,
            conv_pos_groups=conv_pos_groups, layer_norm_first=layer_norm_first,
            apply_final_norm=output_layer is None)
        self.register_buffer("cluster_centers", torch.randn(num_clusters, dim))
        self.requires_grad_(False)
        if checkpoint_path is not None:
            if not os.path.exists(checkpoint_path):
                raise FileNotFoundError(f"hubert checkpoint not found: {checkpoint_path}")
            from ..utils.convert import load_hubert_state_dict

            sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
            load_hubert_state_dict(sd, self)
        if kmeans_path is not None:
            self.load_kmeans(kmeans_path)

    @property
    def downsample_factor(self) -> int:
        return 320

    @property
    def device(self) -> torch.device:
        return self.cluster_centers.device

    def load_kmeans(self, path) -> None:
        """Centroids of a joblib-dumped sklearn k-means (`cluster_centers_`),
        as audiolm-pytorch loads them."""
        if not os.path.exists(path):
            raise FileNotFoundError(f"kmeans checkpoint not found: {path}")
        try:
            import joblib
        except ImportError as e:
            raise ImportError("kmeans_path needs joblib to read the sklearn k-means "
                              "(pip install joblib)") from e
        centers = torch.as_tensor(joblib.load(path).cluster_centers_, dtype=torch.float32)
        dim = self.cluster_centers.shape[-1]
        if centers.dim() != 2 or centers.shape[-1] != dim:
            raise ValueError(f"kmeans centroids {tuple(centers.shape)} don't match encoder "
                             f"dim {dim}")
        self.num_clusters = self.codebook_size = int(centers.shape[0])
        self.cluster_centers = centers.to(self.device)

    def num_frames(self, n_samples: int) -> int:
        """Frames the extractor gives a wave of `n_samples`, after the
        `seq_len_multiple_of` curtailment."""
        n = int(n_samples)
        if self.seq_len_multiple_of is not None:
            n = (n // int(self.seq_len_multiple_of)) * int(self.seq_len_multiple_of)
        for k, s in zip(self.feature_extractor.kernels, self.feature_extractor.strides):
            n = (n - k) // s + 1
        if n <= 0:
            raise ValueError(f"wav of {n_samples} samples too short for the extractor")
        return n

    def _prep_wav(self, wav) -> torch.Tensor:
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        if wav.dim() == 3 and wav.shape[1] == 1:
            wav = wav[:, 0]
        if self.seq_len_multiple_of is not None:
            m = int(self.seq_len_multiple_of)
            n = (wav.shape[-1] // m) * m
            if n <= 0:
                raise ValueError(f"wav of {wav.shape[-1]} samples shorter than "
                                 f"seq_len_multiple_of={m}")
            wav = wav[..., :n]
        return wav

    @torch.no_grad()
    def features(self, wav) -> torch.Tensor:
        """Encoder features (b, frames, dim), the vectors k-means quantises."""
        x = self.feature_projection(self.feature_extractor(self._prep_wav(wav)))
        return self.encoder(x)

    @torch.no_grad()
    def forward(self, wav, flatten: bool = True) -> torch.Tensor:
        """wav (b, n) or (b, 1, n) at target_sample_hz -> ids (b, frames)
        int64. `flatten` is audiolm-pytorch's keyword; ids are (b, frames)
        either way."""
        feats = self.features(wav)
        c = self.cluster_centers
        dist = ((feats * feats).sum(dim=-1, keepdim=True) - 2 * feats @ c.t()
                + (c * c).sum(dim=-1)[None, None, :])
        ids = dist.argmin(dim=-1)
        return ids if flatten else ids.reshape(ids.shape[0], -1)

    def fit_kmeans(self, wavs=None, *, features=None, generator=None, iters: int = 50):
        """Fit the vocabulary on `wavs` (b, n) or on `features` (n, dim);
        sets `cluster_centers` and returns (centroids, inertia)."""
        from ..utils.kmeans import fit_kmeans

        if (wavs is None) == (features is None):
            raise ValueError("pass exactly one of wavs / features")
        dim = self.cluster_centers.shape[-1]
        if features is None:
            features = self.features(wavs).reshape(-1, dim)
        features = torch.as_tensor(features, dtype=torch.float32, device=self.device)
        if features.dim() != 2 or features.shape[-1] != dim:
            raise ValueError(f"features must be (n, {dim}), got {tuple(features.shape)}")
        centroids, inertia = fit_kmeans(features, self.num_clusters, iters=iters,
                                        generator=generator)
        self.cluster_centers = centroids
        return centroids, inertia
