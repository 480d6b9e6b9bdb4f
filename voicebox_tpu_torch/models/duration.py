"""The duration predictor: phoneme ids -> per-phoneme frame counts ->
frame-rate phoneme ids, and its training against MAS-aligned durations.

Counterpart of `voicebox_tpu/models/duration.py`:

* `DurationPredictorNet`: the phoneme embedding fused with the (span-masked,
  optionally dropped) conditioning latents by `to_embed`, the
  ConvPositionEmbed residual, a plain-RMSNorm `Transformer` with qk-norm
  (its attention runs K1 forward and, in training, K2 + K3 backward on the
  card, in fp32 at the reference widths) and a Linear(dim, 1) head. Pad id
  -1 masks attention; a batch row of pads only is fully masked, and its
  durations are zeroed downstream. With `train=True` and an `Aligner` it
  returns the training loss: the span mask (a coin flip between a
  contiguous span of `frac_lengths_mask` of the sequence and Bernoulli
  `p_drop_prob` frames) and the CFG drop, the aligner's soft alignment of
  the mel frames to the phoneme embeddings, MAS (`ops/mas.py`) on the soft
  alignment, the masked-mean L1 of the durations against the MAS durations
  (no gradient) on the masked span, plus the forward-sum loss
  (`ops/forward_sum.py`) of the aligner's log-probabilities;
* `Aligner`: NS2's soft aligner, conv towers over the mel queries and the
  phoneme keys, energies -temperature x squared distance (temperature
  5e-4), masked log-softmax over the phonemes;
* `masked_frame_durations`: THE rounding rule, `clip(round(d), 1)` per real
  phoneme and 0 at pads, shared by alignment, `sample`'s lengths and the
  serving engine's horizon;
* `align_phoneme_ids_with_durations`: each id repeated for its duration,
  0 past a row's total;
* `DurationPredictor`: the tokenizer, `forward` (eval, or `train=True`:
  the loss), `loss_fn`, `forward_with_cond_scale` (CFG as one 2b
  forward; no cond means zero cond, fully dropped) and `load_torch` /
  `save_torch` (the reference's `.pt` layout).

State-dict keys are the reference's (`export_duration_predictor_torch`,
without the aligner): `DurationPredictor.net` loads
`utils.convert.duration_predictor_state_dict` with `strict=True`. The
training-only aligner is `DurationPredictor.aligner`, under the JAX
parameter names (`utils.convert.aligner_state_dict`).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

import torch.nn.functional as F

from ..ops.forward_sum import forward_sum_loss
from ..ops.interp import curtail_or_pad
from ..ops.mas import maximum_path
from ..ops.masks import coin_flip, mask_from_frac_lengths, prob_mask_like, uniform
from ..utils.convert import save_reference_checkpoint
from ..utils.tokenizer import Tokenizer
from .primitives import ConvPositionEmbed, Linear
from .transformer import Transformer

__all__ = [
    "Aligner",
    "DurationPredictor",
    "DurationPredictorNet",
    "align_phoneme_ids_with_durations",
    "masked_frame_durations",
]

_TRAIN_INPUTS = ("mel", "phoneme_len", "mel_len", "phoneme_mask", "mel_mask")


class Aligner(nn.Module):
    """Soft alignment of mel frames (queries) to phoneme embeddings (keys),
    in fp32 whatever the net's dtype, as the reference keeps it."""

    def __init__(self, dim_in: int = 80, dim_hidden: int = 512, attn_channels: int = 80,
                 temperature: float = 0.0005):
        super().__init__()
        self.temperature = temperature
        self.key_conv1 = nn.Conv1d(dim_hidden, dim_hidden * 2, 3, padding=1)
        self.key_conv2 = nn.Conv1d(dim_hidden * 2, attn_channels, 1)
        self.query_conv1 = nn.Conv1d(dim_in, dim_in * 2, 3, padding=1)
        self.query_conv2 = nn.Conv1d(dim_in * 2, dim_in, 1)
        self.query_conv3 = nn.Conv1d(dim_in, attn_channels, 1)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                mask: Optional[torch.Tensor] = None):
        """queries (b, dim_in, t_mel), keys (b, t_ph, dim_hidden), mask
        (b, t_ph) or (b, 1, t_ph) of real phonemes -> (soft, logprob), each
        (b, 1, t_mel, t_ph)."""
        keys, queries = keys.float(), queries.float()
        k = self.key_conv2(F.relu(self.key_conv1(keys.transpose(1, 2)))).transpose(1, 2)
        q = F.relu(self.query_conv2(F.relu(self.query_conv1(queries))))
        q = self.query_conv3(q).transpose(1, 2)  # (b, t_mel, c)
        dist = (q.square().sum(-1)[:, :, None] - 2 * torch.matmul(q, k.transpose(1, 2))
                + k.square().sum(-1)[:, None, :])
        energies = -self.temperature * dist
        if mask is not None:
            if mask.dim() == 3:
                mask = mask[:, 0, :]
            energies = energies.masked_fill(~mask[:, None, :], -1e9)
        logprob = energies.log_softmax(dim=-1)
        return logprob.exp()[:, None], logprob[:, None]


class DurationPredictorNet(nn.Module):
    """The network: phoneme embedding + cond -> transformer -> durations."""

    def __init__(
        self,
        num_phoneme_tokens: int,
        dim_phoneme_emb: int = 512,
        dim: int = 512,
        latent_dim: Optional[int] = None,
        depth: int = 10,
        dim_head: int = 64,
        heads: int = 8,
        ff_mult: float = 4.0,
        ff_dropout: float = 0.0,
        conv_pos_embed_kernel_size: int = 31,
        conv_pos_embed_groups: Optional[int] = None,
        attn_dropout: float = 0.0,
        attn_qk_norm: bool = True,
        use_gateloop_layers: bool = False,
        p_drop_prob: float = 0.2,
        frac_lengths_mask=(0.1, 1.0),
        dtype=torch.float32,
    ):
        super().__init__()
        self.dim = dim
        self.p_drop_prob = p_drop_prob
        self.frac_lengths_mask = tuple(frac_lengths_mask)
        self.register_buffer("null_cond", torch.zeros(dim))  # the reference's key
        lin = dict(dtype=dtype)
        needs_proj = latent_dim is not None and latent_dim != dim
        self.proj_in = Linear(latent_dim, dim, **lin) if needs_proj else None
        self.to_phoneme_emb = nn.Embedding(num_phoneme_tokens, dim_phoneme_emb, dtype=dtype)
        self.to_embed = Linear(dim_phoneme_emb + dim, dim, **lin)
        self.conv_embed = ConvPositionEmbed(dim, kernel_size=conv_pos_embed_kernel_size,
                                            groups=conv_pos_embed_groups, **lin)
        self.transformer = Transformer(
            dim=dim, depth=depth, dim_head=dim_head, heads=heads, ff_mult=ff_mult,
            attn_qk_norm=attn_qk_norm, use_gateloop_layers=use_gateloop_layers,
            attn_dropout=attn_dropout, ff_dropout=ff_dropout, **lin,
        )
        self.to_pred = nn.Sequential(Linear(dim, 1, **lin))

    def _span_mask(self, batch: int, seq_len: int, generator, device) -> torch.Tensor:
        """The training span mask: a coin flip between a contiguous span of
        `frac_lengths_mask` of the sequence and Bernoulli(p_drop_prob)."""
        use_frac = coin_flip(generator, device)
        lo, hi = self.frac_lengths_mask
        frac = (uniform((batch,), generator, device) * (hi - lo) + lo).clamp_min(lo)
        span = mask_from_frac_lengths(seq_len, frac, generator)
        bern = prob_mask_like((batch, seq_len), self.p_drop_prob, generator, device)
        return torch.where(use_frac, span, bern)

    def forward(
        self,
        *,
        cond: torch.Tensor,  # (b, t, latent_dim | dim)
        phoneme_ids: torch.Tensor,  # (b, t_ph) int, pad = -1
        cond_drop_prob: float = 0.0,
        cond_drop_mask: Optional[torch.Tensor] = None,  # (b,) bool, True = drop
        cond_mask: Optional[torch.Tensor] = None,  # (b, t) bool, True = masked out
        self_attn_mask: Optional[torch.Tensor] = None,  # (b, t_ph) bool
        train: bool = False,
        aligner: Optional[Aligner] = None,
        mel: Optional[torch.Tensor] = None,  # (b, t_mel, aligner dim_in), training
        phoneme_len: Optional[torch.Tensor] = None,
        mel_len: Optional[torch.Tensor] = None,
        phoneme_mask: Optional[torch.Tensor] = None,  # (b, t_ph)
        mel_mask: Optional[torch.Tensor] = None,  # (b, t_mel)
        return_aligned_phoneme_ids: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """Durations (b, t_ph) in the net's dtype; with `train=True` the
        training loss (and with `return_aligned_phoneme_ids` the MAS
        durations (b, t_ph)), the span and CFG masks drawn from `generator`
        unless given."""
        batch, seq_len, _ = cond.shape
        if self.proj_in is not None:
            cond = self.proj_in(cond)
        if cond_mask is None:
            cond_mask = (self._span_mask(batch, seq_len, generator, cond.device) if train else
                         torch.zeros(batch, seq_len, dtype=torch.bool, device=cond.device))
        cond = cond * (~cond_mask[..., None]).to(cond.dtype)
        if cond_drop_mask is None and cond_drop_prob > 0.0:
            cond_drop_mask = prob_mask_like((batch,), cond_drop_prob, generator, cond.device)
        if cond_drop_mask is not None:
            cond = cond.masked_fill(cond_drop_mask[:, None, None], 0.0)

        if self_attn_mask is None:
            self_attn_mask = phoneme_ids != -1
        phoneme_emb = self.to_phoneme_emb(phoneme_ids.clamp_min(0))
        cond = curtail_or_pad(cond, phoneme_ids.shape[-1])
        x = self.to_embed(torch.cat([phoneme_emb, cond.to(phoneme_emb.dtype)], dim=-1))
        x = self.conv_embed(x, mask=self_attn_mask) + x
        x = self.transformer(x, mask=self_attn_mask, train=train, generator=generator)
        durations = self.to_pred(x)[..., 0]
        if not train:
            return durations

        given = dict(mel=mel, phoneme_len=phoneme_len, mel_len=mel_len,
                     phoneme_mask=phoneme_mask, mel_mask=mel_mask)
        missing = [k for k in _TRAIN_INPUTS if given[k] is None]
        if aligner is None or missing:
            raise ValueError(
                f"training the duration predictor needs an aligner and {', '.join(_TRAIN_INPUTS)}"
                f" (missing: {', '.join(missing + ([] if aligner is not None else ['aligner']))})"
            )
        soft, logprob = aligner(mel.transpose(1, 2), phoneme_emb, phoneme_mask)
        attn_mask = phoneme_mask[:, :, None] & mel_mask[:, None, :]  # (b, t_ph, t_mel)
        alignment = maximum_path(soft[:, 0].transpose(1, 2), attn_mask)
        t_ph = phoneme_ids.shape[-1]
        target = alignment.sum(dim=-1).float()  # no gradient: MAS is a bool path

        loss_mask = curtail_or_pad(cond_mask[:, :t_ph, None], t_ph)[..., 0] & self_attn_mask
        l1 = (durations.float() - target).abs().masked_fill(~loss_mask, 0.0)
        den = loss_mask.sum(dim=-1).float().clamp_min(1e-5)
        dur_loss = (l1.sum(dim=-1) / den).mean()
        loss = dur_loss + forward_sum_loss(logprob, phoneme_len, mel_len)
        if return_aligned_phoneme_ids:
            return loss, target
        return loss


def masked_frame_durations(phoneme_ids, durations):
    """`clip(round(d), 1)` per position as int32 (every real phoneme speaks
    for at least one frame; round half to even), then 0 at pad positions
    (id < 0). numpy in, numpy out (the engine's host math); torch in, torch
    out."""
    if isinstance(durations, torch.Tensor):
        per = torch.round(durations).clamp_min(1).to(torch.int32)
        ids = torch.as_tensor(phoneme_ids, device=durations.device)
        return torch.where(ids >= 0, per, torch.zeros_like(per))
    per = np.clip(np.round(durations), 1, None).astype(np.int32)
    return np.where(np.asarray(phoneme_ids) >= 0, per, 0)


def align_phoneme_ids_with_durations(phoneme_ids: torch.Tensor, durations: torch.Tensor,
                                     total_length: Optional[int] = None) -> torch.Tensor:
    """Phoneme ids at the frame rate (b, total_length): frame j takes the
    phoneme i with cumsum[i-1] <= j < cumsum[i] of the masked durations,
    and frames past a row's total take id 0 (the reference's one-hot sum).
    `total_length` defaults to the longest row's total."""
    per = masked_frame_durations(phoneme_ids, durations)
    boundaries = torch.cumsum(per, dim=-1)
    if total_length is None:
        total_length = int(boundaries[:, -1].max())
    frames = torch.arange(total_length, device=boundaries.device, dtype=boundaries.dtype)
    frames = frames.expand(boundaries.shape[0], -1).contiguous()
    idx = torch.searchsorted(boundaries, frames, right=True)  # boundaries <= frame
    idx = idx.clamp(max=phoneme_ids.shape[-1] - 1)
    aligned = torch.gather(phoneme_ids, -1, idx)
    return torch.where(frames < boundaries[:, -1:], aligned, torch.zeros_like(aligned))


class DurationPredictor(nn.Module):
    """The reference's module surface: tokenizer, eval forward and
    CFG-scaled inference over `net`. The attached codec sets the width of
    the conditioning latents; it is not a registered submodule."""

    def __init__(
        self,
        *,
        audio_enc_dec=None,
        tokenizer=None,
        num_phoneme_tokens: Optional[int] = None,
        dim_phoneme_emb: int = 512,
        dim: int = 512,
        depth: int = 10,
        aligner_dim_in: int = 80,
        aligner_attn_channels: int = 80,
        **net_kwargs,
    ):
        super().__init__()
        if tokenizer is not None and num_phoneme_tokens is not None:
            raise ValueError("when a tokenizer is given, num_phoneme_tokens is not needed")
        if tokenizer is None and num_phoneme_tokens is None:
            tokenizer = Tokenizer()
        if tokenizer is not None:
            num_phoneme_tokens = tokenizer.vocab_size
        self.tokenizer = tokenizer
        self.__dict__["audio_enc_dec"] = audio_enc_dec
        self.aligner_dim_in = aligner_dim_in
        self.aligner_attn_channels = aligner_attn_channels
        latent_dim = None
        if audio_enc_dec is not None and audio_enc_dec.latent_dim != dim:
            latent_dim = audio_enc_dec.latent_dim
        self.net = DurationPredictorNet(
            num_phoneme_tokens=num_phoneme_tokens, dim_phoneme_emb=dim_phoneme_emb, dim=dim,
            latent_dim=latent_dim, depth=depth, **net_kwargs,
        )
        self.aligner = Aligner(dim_in=aligner_dim_in, dim_hidden=dim_phoneme_emb,
                               attn_channels=aligner_attn_channels)

    @property
    def cond_dim(self) -> int:
        """Width of the conditioning latents the net takes."""
        codec = self.audio_enc_dec
        return codec.latent_dim if codec is not None else self.net.dim

    def _device(self) -> torch.device:
        return next(self.net.parameters()).device

    def _phoneme_ids(self, texts, phoneme_ids) -> torch.Tensor:
        if phoneme_ids is None:
            if self.tokenizer is None or texts is None:
                raise ValueError("pass phoneme_ids, or texts with a tokenizer attached")
            phoneme_ids = self.tokenizer.texts_to_tensor_ids(texts)
        if not torch.is_tensor(phoneme_ids):
            phoneme_ids = torch.from_numpy(np.asarray(phoneme_ids))
        return phoneme_ids.to(self._device()).long()

    # keys a checkpoint may lack: frozen zeros and the RoPE table, which the
    # net makes itself (the JAX package skips both when it loads)
    _OPTIONAL_KEYS = ("null_cond", "rotary_emb.inv_freq")

    def load_torch(self, path_or_state) -> dict:
        """Load the net from a reference `DurationPredictor` checkpoint: a
        raw state dict, a trainer checkpoint with the predictor under
        `duration_predictor.` (the reference's, the JAX package's
        `save_torch`, or this package's trainer's, which nests it under
        `net.`), or a path to one. The aligner (training only; the NS2
        package's names) and any codec weights are not loaded, as in the
        JAX package: the aligner retrains from its init. Returns the state
        dict loaded into `net`."""
        sd = path_or_state
        if not isinstance(sd, Mapping):
            sd = torch.load(sd, map_location="cpu", weights_only=False)
        for wrapper in ("state_dict", "model"):
            if wrapper in sd and isinstance(sd[wrapper], Mapping):
                sd = sd[wrapper]
        for prefix in ("duration_predictor.", "net."):
            if any(k.startswith(prefix) for k in sd):
                sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        sd = {k: torch.as_tensor(v) for k, v in sd.items()
              if not k.startswith(("aligner.", "align_loss.", "audio_enc_dec."))}
        own = self.net.state_dict()
        missing = [k for k in own if k not in sd and not k.endswith(self._OPTIONAL_KEYS)]
        unexpected = [k for k in sd if k not in own]
        if missing or unexpected:
            raise KeyError(f"not a DurationPredictor checkpoint of this geometry: missing "
                           f"{missing[:5]}, unexpected {unexpected[:5]}")
        self.net.load_state_dict(sd, strict=False)
        return sd

    def save_torch(self, path, prefix: str = "") -> dict:
        """Write the net as a reference `DurationPredictor` state dict, fp32,
        inside a `{'model', 'optim', 'scheduler'}` checkpoint; `prefix=
        'duration_predictor.'` gives the keys of a wrapper's state dict. The
        aligner is left out (the JAX package's `save_torch` does the same),
        so the reference loads it with `strict=False`. Returns the
        checkpoint."""
        model = {f"{prefix}{k}": v.detach().to("cpu", torch.float32, copy=True)
                 for k, v in self.net.state_dict().items()}
        return save_reference_checkpoint(path, model)

    def loss_fn(self, *, cond, phoneme_ids, mel=None, phoneme_len=None, mel_len=None,
                phoneme_mask=None, mel_mask=None, cond_drop_prob: float = 0.0, generator=None,
                **kwargs):
        """The training loss (a scalar fp32 tensor, with gradients): the span
        and CFG masks are `cond_mask` / `cond_drop_mask` or drawn from
        `generator`; `return_aligned_phoneme_ids=True` also returns the MAS
        durations."""
        return self.net(cond=cond, phoneme_ids=phoneme_ids, mel=mel, phoneme_len=phoneme_len,
                        mel_len=mel_len, phoneme_mask=phoneme_mask, mel_mask=mel_mask,
                        cond_drop_prob=cond_drop_prob, train=True, aligner=self.aligner,
                        generator=generator, **kwargs)

    def forward(self, *, cond, texts=None, phoneme_ids=None, train: bool = False, **kwargs):
        """Durations (b, t_ph) of the phonemes under `cond` latents, or with
        `train=True` the training loss (`loss_fn`'s keywords)."""
        ids = self._phoneme_ids(texts, phoneme_ids)
        cond = torch.as_tensor(cond, device=ids.device)
        if train:
            return self.loss_fn(cond=cond, phoneme_ids=ids, **kwargs)
        with torch.no_grad():
            return self.net(cond=cond, phoneme_ids=ids, **kwargs)

    @torch.no_grad()
    def forward_with_cond_scale(
        self,
        *,
        cond=None,
        texts=None,
        phoneme_ids=None,
        cond_scale: float = 1.0,
        return_aligned_phoneme_ids: bool = False,
        total_length: Optional[int] = None,
        **kwargs,
    ):
        """CFG-scaled durations, `null + (cond - null) * cond_scale`, with
        the conditioned and the null half as one 2b forward. Without `cond`
        (no voice prompt) the cond is zero and fully dropped and the scale
        is 1. With `return_aligned_phoneme_ids` also returns the ids at the
        frame rate, `total_length` frames long (default: the longest row)."""
        ids = self._phoneme_ids(texts, phoneme_ids)
        b = ids.shape[0]
        if cond is None:
            cond = torch.zeros(b, ids.shape[1], self.cond_dim, device=ids.device)
            kwargs.setdefault("cond_drop_mask", torch.ones(b, dtype=torch.bool,
                                                           device=ids.device))
            cond_scale = 1.0
        cond = torch.as_tensor(cond, device=ids.device)
        b = cond.shape[0]
        if cond_scale == 1.0:
            drop = kwargs.pop("cond_drop_mask", torch.zeros(b, dtype=torch.bool,
                                                            device=ids.device))
            durations = self.net(cond=cond, phoneme_ids=ids, cond_drop_mask=drop, **kwargs)
        else:
            drop2 = torch.arange(2 * b, device=ids.device) >= b
            out2 = self.net(cond=torch.cat([cond, cond]), phoneme_ids=torch.cat([ids, ids]),
                            cond_drop_mask=drop2, **kwargs)
            durations, null_durations = out2[:b], out2[b:]
            durations = null_durations + (durations - null_durations) * cond_scale
        if not return_aligned_phoneme_ids:
            return durations
        return durations, align_phoneme_ids_with_durations(ids, durations, total_length)
