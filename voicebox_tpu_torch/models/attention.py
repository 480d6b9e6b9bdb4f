"""Multi-head bidirectional attention.

Counterpart of `voicebox_tpu/models/attention.py::Attention` (the branch
without sequence parallelism): fused QKV projection, heads split to
(b, h, n, d), per-head qk-norm with the fixed scale 10, rotary on q and k
(tagged "qk_rotary" for remat policies), then `ops.flash_attention` (K1
forward, K2 + K3 backward on the card) and the output projection. In
training (`train=True`) with `attn_dropout > 0` the attention weights are
dropped, as the JAX package does on its XLA path: `reference_attention`
with its keep mask drawn from `generator`. Every other call goes to
`flash_attention`. `scores_dtype` (the JAX module's field of that name)
reaches both: on the CPU the plain version then holds its score matrix in
that dtype; on the card K1 holds none, and the option changes nothing, as
on the JAX package's Pallas path. Ring attention ignores it, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.flash_attention import flash_attention, reference_attention
from ..ops.masks import uniform
from ..ops.remat import checkpoint_name
from ..ops.ring_attention import ring_attention, ring_attention_prefixed
from ..parallel.sequence_parallel import current_shard
from .primitives import Linear, MultiheadRMSNorm, apply_rotary_pos_emb

__all__ = ["Attention"]


class Attention(nn.Module):
    tp = None

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 qk_norm: bool = False, qk_norm_scale: float = 10.0,
                 attn_dropout: float = 0.0, scores_dtype: Optional[torch.dtype] = None,
                 dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.attn_dropout = attn_dropout
        self.scores_dtype = scores_dtype
        self.qk_norm_scale = qk_norm_scale if qk_norm else None
        dim_inner = heads * dim_head
        if qk_norm:
            self.q_norm = MultiheadRMSNorm(dim_head, heads)
            self.k_norm = MultiheadRMSNorm(dim_head, heads)
        self.to_qkv = Linear(dim, dim_inner * 3, bias=False, dtype=dtype,
                             param_dtype=param_dtype)
        self.to_out = Linear(dim_inner, dim, bias=False, dtype=dtype, param_dtype=param_dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                rotary_emb: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None, prefix: int = 0) -> torch.Tensor:
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        heads = None
        if self.tp is not None:  # this rank's heads
            h = self.heads // self.tp.size
            heads = slice(self.tp.rank * h, (self.tp.rank + 1) * h)
        q, k, v = (
            t.reshape(b, n, h, d).transpose(1, 2)
            for t in self.to_qkv(x).chunk(3, dim=-1)
        )
        if self.qk_norm_scale is not None:
            q, k = self.q_norm(q, heads), self.k_norm(k, heads)
        if rotary_emb is not None:
            q = checkpoint_name(apply_rotary_pos_emb(rotary_emb, q), "qk_rotary")
            k = checkpoint_name(apply_rotary_pos_emb(rotary_emb, k), "qk_rotary")
        shard = current_shard()
        if shard is not None:
            if train and self.attn_dropout > 0:
                raise ValueError("attention dropout is not supported under sequence "
                                 "parallelism (the JAX package refuses it too)")
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            if prefix:
                out = torch.cat(ring_attention_prefixed(q, k, v, prefix, mask,
                                                        self.qk_norm_scale, shard.group), dim=2)
            else:
                out = ring_attention(q, k, v, mask, self.qk_norm_scale, shard.group)
        elif train and self.attn_dropout > 0:
            keep = None
            if heads is not None:  # drawn for every head, this rank's kept
                keep = uniform((b, self.heads, n, k.shape[2]), generator,
                               x.device)[:, heads] < 1.0 - self.attn_dropout
            out = reference_attention(q, k, v, mask, self.qk_norm_scale,
                                      dropout=self.attn_dropout, keep=keep,
                                      generator=generator, scores_dtype=self.scores_dtype)
        else:
            # K1 takes contiguous (b, h, n, d) operands
            out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  mask=mask, scale=self.qk_norm_scale,
                                  scores_dtype=self.scores_dtype)
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * d))
