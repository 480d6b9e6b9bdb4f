"""The VoiceBox denoiser: the vector field of the conditional flow matcher.

Counterpart of `voicebox_tpu/models/voicebox.py::VoiceBox`: `proj_in` when a
codec with another latent width is attached, input fusion
`to_embed(cat(x, cond_emb, cond))`, the ConvPositionEmbed residual, the fp32
time MLP, the adaptive-norm Transformer and the linear head.
Kept from the JAX package: `cond` defaults to `target` when absent (the
reference's quirk); ids < 0 map to the null row; classifier-free guidance
drops the condition through an explicit `cond_drop_mask`.

Training: with `train=True` attention dropout is on (`attn_dropout`, its
keep masks from `generator`), and the span mask (`frac_lengths_mask` of the
sequence, the part to generate) is drawn from `generator` unless `cond_mask`
is given, and with `cond_drop_prob > 0` so is the CFG drop unless
`cond_drop_mask` is given. With a `target` the forward returns the masked
mean MSE over the span and the attention mask, in fp32: per sample
num / clamp(den, 1e-5), then the mean over the batch. The JAX package's
128-lane padding (`pad_to_lane_multiple`) is a TPU layout rule and is not
ported: the masked loss is the same without it. `attn_scores_dtype` is the
JAX field: None (fp32) by default; bf16 holds the plain attention's score
matrix in bf16 (the CPU, and attention dropout in training) and changes
nothing on K1, which holds no score matrix.

Under tensor parallelism a `to_cond_emb` whose rows the rule splits holds
this rank's block of rows (ids outside it give zeros, then one all-reduce
over "model"). Inside `parallel/sequence_parallel.py::seq_shard` x, cond
and the masks are this rank's frames: the ids stay whole and their
embedding is stretched to the global length, then sliced; the span mask
is built over the global length and sliced; the loss's numerator and
denominator are summed over "seq", so every rank returns the whole
sequence's loss.

State-dict keys are the reference's (`export_voicebox_torch`), so the
exporter's output loads with `strict=True`. The attached codec is frozen and
holds its own weights, so it is not a registered submodule: it appears in no
key and moves with `ConditionalFlowMatcherWrapper`, which registers it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.interp import interpolate_1d
from ..ops.masks import mask_from_frac_lengths, prob_mask_like, reduce_masks_with_and, uniform
from ..parallel.collectives import all_reduce, reduce_from_group
from ..parallel.sequence_parallel import current_shard
from .primitives import ConvPositionEmbed, LearnedSinusoidalPosEmb, Linear
from .transformer import Transformer

__all__ = ["VoiceBox"]


class VoiceBox(nn.Module):
    def __init__(
        self,
        num_cond_tokens: Optional[int] = None,
        audio_enc_dec=None,
        dim_in: Optional[int] = None,
        dim_cond_emb: int = 1024,
        dim: int = 1024,
        depth: int = 24,
        dim_head: int = 64,
        heads: int = 16,
        ff_mult: float = 4.0,
        ff_dropout: float = 0.0,
        time_hidden_dim: Optional[int] = None,
        conv_pos_embed_kernel_size: int = 31,
        conv_pos_embed_groups: Optional[int] = None,
        attn_dropout: float = 0.0,
        attn_qk_norm: bool = True,
        attn_scores_dtype: Optional[torch.dtype] = None,  # see ops/flash_attention.py
        use_gateloop_layers: bool = False,
        num_register_tokens: int = 16,
        frac_lengths_mask: Tuple[float, float] = (0.7, 1.0),
        condition_on_text: bool = True,
        remat: bool = False,
        remat_policy: Optional[str] = None,  # see ops/remat.py
        dtype=torch.float32,
        param_dtype=None,
    ):
        super().__init__()
        assert depth % 2 == 0, "depth must be even (U-Net skip symmetry)"
        if condition_on_text:
            assert num_cond_tokens is not None, (
                "num_cond_tokens must be set when condition_on_text=True"
            )
        # not registered: the codec is frozen and owns its weights
        self.__dict__["audio_enc_dec"] = audio_enc_dec
        self.num_cond_tokens = num_cond_tokens
        self.condition_on_text = condition_on_text
        self.dtype = dtype
        self.frac_lengths_mask = tuple(frac_lengths_mask)
        if audio_enc_dec is not None:
            self.latent_dim = audio_enc_dec.latent_dim
        else:
            self.latent_dim = dim_in if dim_in is not None else dim
        time_hidden_dim = time_hidden_dim or dim * 4

        needs_proj = audio_enc_dec is not None and dim != self.latent_dim
        x_dim = dim if needs_proj else self.latent_dim
        self.register_buffer("null_cond", torch.zeros(x_dim))
        lin = dict(dtype=dtype, param_dtype=param_dtype)
        self.proj_in = Linear(self.latent_dim, dim, **lin) if needs_proj else None
        # the time MLP computes in fp32 whatever its storage dtype
        self.sinu_pos_emb = nn.Sequential(
            LearnedSinusoidalPosEmb(dim), Linear(dim, time_hidden_dim), nn.SiLU()
        )
        self.to_cond_emb = (
            nn.Embedding(num_cond_tokens + 1, dim_cond_emb, dtype=param_dtype or dtype)
            if condition_on_text else None
        )
        dim_cond = dim_cond_emb if condition_on_text else 0
        self.to_embed = Linear(x_dim * 2 + dim_cond, dim, **lin)
        self.conv_embed = ConvPositionEmbed(
            dim, kernel_size=conv_pos_embed_kernel_size,
            groups=conv_pos_embed_groups, **lin,
        )
        self.transformer = Transformer(
            dim=dim, depth=depth, dim_head=dim_head, heads=heads, ff_mult=ff_mult,
            num_register_tokens=num_register_tokens, adaptive_rmsnorm=True,
            adaptive_rmsnorm_cond_dim_in=time_hidden_dim, attn_qk_norm=attn_qk_norm,
            use_gateloop_layers=use_gateloop_layers, attn_dropout=attn_dropout,
            ff_dropout=ff_dropout, attn_scores_dtype=attn_scores_dtype, remat=remat,
            remat_policy=remat_policy, **lin,
        )
        self.to_pred = Linear(dim, self.latent_dim, bias=False, **lin)

    @property
    def null_cond_id(self) -> int:
        # the last embedding row doubles as the CFG null token
        return self.num_cond_tokens

    def _proj_in(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.proj_in is None else self.proj_in(t)

    def forward(
        self,
        x: torch.Tensor,  # (b, n, latent_dim) noisy latent
        *,
        times,  # float, () or (b,)
        cond_token_ids: Optional[torch.Tensor] = None,  # (b, n_cond) int
        self_attn_mask: Optional[torch.Tensor] = None,  # (b, n) bool
        cond_drop_prob: float = 0.0,
        cond_drop_mask: Optional[torch.Tensor] = None,  # (b,) bool, True = drop
        target: Optional[torch.Tensor] = None,  # (b, n, latent_dim) flow target
        cond: Optional[torch.Tensor] = None,  # (b, n, latent_dim)
        cond_mask: Optional[torch.Tensor] = None,  # (b, n) bool, True = generate
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The vector field (b, n, latent_dim), or with `target` the scalar
        masked-MSE loss."""
        x = self._proj_in(x)
        if cond is None:  # the reference's quirk: cond defaults to the target
            cond = target
        assert cond is not None, "either cond or target must be provided"
        cond = self._proj_in(cond)
        batch, seq_len, _ = cond.shape

        times = torch.as_tensor(times, device=x.device)
        if times.dim() == 0 or times.numel() == 1:
            times = times.reshape(1).expand(batch)

        shard = current_shard()
        if cond_mask is None and train:
            lo, hi = self.frac_lengths_mask
            frac = (uniform((batch,), generator, x.device) * (hi - lo) + lo).clamp_min(lo)
            if shard is None:
                cond_mask = mask_from_frac_lengths(seq_len, frac, generator)
            else:  # the span over the whole sequence, this rank's frames of it
                start = shard.rank * seq_len
                cond_mask = mask_from_frac_lengths(seq_len * shard.size, frac, generator)
                cond_mask = cond_mask[:, start:start + seq_len]
        elif cond_mask is None:
            cond_mask = torch.ones(batch, seq_len, dtype=torch.bool, device=x.device)
        cond = cond * (~cond_mask[..., None]).to(cond.dtype)

        cond_ids = cond_token_ids
        if cond_drop_mask is None and cond_drop_prob > 0:
            cond_drop_mask = prob_mask_like((batch,), cond_drop_prob, generator, x.device)
        if cond_drop_mask is not None:
            cond = cond.masked_fill(cond_drop_mask[:, None, None], 0.0)
            if cond_ids is not None:
                cond_ids = cond_ids.masked_fill(cond_drop_mask[:, None], self.null_cond_id)

        parts = [x, cond]
        if self.condition_on_text:
            assert cond_ids is not None, "cond_token_ids required when condition_on_text"
            cond_ids = cond_ids.masked_fill(cond_ids < 0, self.null_cond_id)
            # the table in the compute dtype first, as flax's Embed promotes
            # it: the backward's scatter-add then sums in that dtype and
            # rounds once to the parameter's
            cond_emb = self._embed(cond_ids)
            if shard is not None:
                # the ids are whole: stretch to the global length, keep the shard
                n_global = seq_len * shard.size
                if cond_emb.shape[-2] != n_global:
                    cond_emb = interpolate_1d(cond_emb.transpose(1, 2),
                                              n_global).transpose(1, 2)
                start = shard.rank * seq_len
                cond_emb = cond_emb[:, start:start + seq_len]
            elif cond_emb.shape[-2] != seq_len:
                cond_emb = interpolate_1d(cond_emb.transpose(1, 2), seq_len).transpose(1, 2)
                if self_attn_mask is not None:
                    self_attn_mask = interpolate_1d(self_attn_mask, seq_len)
            parts = [x, cond_emb, cond]

        x = self.to_embed(torch.cat([t.to(self.dtype) for t in parts], dim=-1))
        x = self.conv_embed(x, mask=self_attn_mask) + x

        time_emb = self.sinu_pos_emb(times)  # fp32
        x = self.transformer(x, mask=self_attn_mask, adaptive_rmsnorm_cond=time_emb,
                             train=train, generator=generator)
        x = self.to_pred(x)
        if target is None:
            return x

        loss_mask = reduce_masks_with_and(cond_mask, self_attn_mask)
        loss = (x.float() - target.float()).square().mean(dim=-1)
        loss = torch.where(loss_mask, loss, 0.0)
        num, den = loss.sum(dim=-1), loss_mask.sum(dim=-1).to(loss.dtype)
        if shard is not None:  # the masked mean over the whole sequence
            num = reduce_from_group(num, shard.group)
            den = all_reduce(den.clone(), shard.group)
        return (num / den.clamp_min(1e-5)).mean()

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        """The cond-id embedding; under tensor parallelism this rank's rows
        of the table, the other ids zero, summed over "model"."""
        table = self.to_cond_emb.weight.to(self.dtype)
        tp = getattr(self.to_cond_emb, "tp", None)
        if tp is None:
            return nn.functional.embedding(ids, table)
        local = ids - self.to_cond_emb.tp_rows
        inside = (local >= 0) & (local < table.shape[0])
        emb = nn.functional.embedding(local.clamp(0, table.shape[0] - 1), table)
        return reduce_from_group(emb * inside[..., None].to(emb.dtype), tp.group)

    def forward_with_cond_scale(self, x: torch.Tensor, *, times, cond_scale: float = 1.0,
                                **kwargs) -> torch.Tensor:
        """Classifier-free guidance, `null + (cond - null) * cond_scale`, with
        the conditioned and the null half as ONE forward at batch 2b."""
        b = x.shape[0]
        if cond_scale == 1.0:
            drop = torch.zeros(b, dtype=torch.bool, device=x.device)
            return self(x, times=times, cond_drop_mask=drop, **kwargs)

        def cat(t):
            if isinstance(t, torch.Tensor) and t.dim() > 0:
                return torch.cat([t, t], dim=0)
            return t

        times = torch.as_tensor(times, device=x.device)
        if times.dim() == 0 or times.numel() == 1:
            times = times.reshape(1).expand(b)
        drop2 = torch.arange(2 * b, device=x.device) >= b
        out2 = self(cat(x), times=cat(times), cond_drop_mask=drop2,
                    **{k: cat(v) for k, v in kwargs.items()})
        out2 = out2.to(x.dtype)
        logits, null_logits = out2[:b], out2[b:]
        return null_logits + (logits - null_logits) * cond_scale
