"""Bidirectional transformer with register tokens, optional U-Net skip
connections and adaptive or plain RMSNorm.

Counterpart of `voicebox_tpu/models/transformer.py::Transformer` with its
unrolled loop. Module layout and state-dict keys are the reference's:
`register_tokens`, `layers.{i}` = [skip_combiner, gateloop, attn_prenorm,
attn, ff_prenorm, ff] (absent entries are None and hold no keys),
`rotary_emb.inv_freq`, `final_norm.gamma`.

Per block: [skip combine] -> [GateLoop + residual, with
`use_gateloop_layers`] -> prenorm attention + residual -> prenorm
feed-forward + residual. The skip combine is `Linear(cat(x, skip *
skip_connect_scale))` (2^-0.5 unless given). Registers are prepended at
rotary position -10000 and are never masked; the rotary table's base is
`rotary_theta`. `VoiceBox` leaves the skip connections off; the flag is
kept for checkpoints that carry `skip_combiner_{i}`.

The JAX package's `scan_layers=True` stores the blocks as two stacks,
`layers_front` and `layers_back`, to bound XLA's compile time; eager
PyTorch has no such cost, so the port keeps one layout, `layers.{i}`, and
`utils/convert.py` maps the stacks onto it (front row j is layer j, back
row j layer depth / 2 + j). `rotary_table`, `layer_forward` and `finish`
are the pieces of `forward` that `parallel/pipeline.py` runs per stage.

Inside `parallel/sequence_parallel.py::seq_shard` the block runs on this
rank's frames: rotary positions are offset by the shard, the registers
are ring attention's replicated prefix, and GateLoop is refused (its
recurrence spans the whole sequence), as in the JAX package.

`remat=True` rematerialises each block (attention and feed-forward, not the
skip combiner) in the backward under `remat_policy` (`ops/remat.py`: None is
full recompute, "dots", "dots_no_batch" and the JAX package's tag names),
as the JAX package's `nn.remat(_Block, policy=...)` does.

`attn_scores_dtype` is handed to every block's attention (`Attention`'s
`scores_dtype`): opt-in bf16 scores on the plain path, nothing on K1.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch import nn

from ..ops.remat import parse_policy, remat_call
from ..parallel.sequence_parallel import current_shard
from .attention import Attention
from .primitives import (AdaptiveRMSNorm, FeedForward, Linear, RMSNorm, RotaryEmbedding,
                         SimpleGateLoopLayer)

__all__ = ["Transformer"]


class Transformer(nn.Module):
    def __init__(
        self,
        dim: int,
        depth: int,
        dim_head: int = 64,
        heads: int = 8,
        ff_mult: float = 4.0,
        num_register_tokens: int = 0,
        adaptive_rmsnorm: bool = False,
        adaptive_rmsnorm_cond_dim_in: Optional[int] = None,
        use_unet_skip_connection: bool = False,
        attn_qk_norm: bool = False,
        use_gateloop_layers: bool = False,
        attn_dropout: float = 0.0,
        ff_dropout: float = 0.0,
        attn_scores_dtype: Optional[torch.dtype] = None,
        remat: bool = False,
        remat_policy: Optional[str] = None,
        rotary_theta: float = 50000.0,
        skip_connect_scale: Optional[float] = None,
        dtype=torch.float32,
        param_dtype=None,
    ):
        super().__init__()
        assert depth % 2 == 0, "depth must be even (U-Net skip symmetry)"
        parse_policy(remat_policy)  # unknown parts raise here
        self.remat, self.remat_policy = remat, remat_policy
        self.attn_dropout = attn_dropout
        self.depth = depth
        self.skip_connect_scale = 2 ** -0.5 if skip_connect_scale is None else skip_connect_scale
        self.compute_dtype = dtype
        self.num_register_tokens = num_register_tokens
        if num_register_tokens > 0:
            self.register_tokens = nn.Parameter(torch.randn(num_register_tokens, dim))

        def prenorm():
            if adaptive_rmsnorm:
                return AdaptiveRMSNorm(dim, cond_dim=adaptive_rmsnorm_cond_dim_in)
            return RMSNorm(dim)

        self.adaptive = adaptive_rmsnorm
        self.layers = nn.ModuleList()
        for ind in range(depth):
            has_skip = use_unet_skip_connection and ind + 1 > depth // 2
            self.layers.append(nn.ModuleList([
                Linear(dim * 2, dim, dtype=dtype, param_dtype=param_dtype)
                if has_skip else None,
                SimpleGateLoopLayer(dim, dtype=dtype, param_dtype=param_dtype)
                if use_gateloop_layers else None,
                prenorm(),
                Attention(dim, dim_head=dim_head, heads=heads, qk_norm=attn_qk_norm,
                          attn_dropout=attn_dropout, scores_dtype=attn_scores_dtype,
                          dtype=dtype, param_dtype=param_dtype),
                prenorm(),
                FeedForward(dim, mult=ff_mult, dropout=ff_dropout, dtype=dtype,
                            param_dtype=param_dtype),
            ]))
        self.rotary_emb = RotaryEmbedding(dim_head, theta=rotary_theta)
        self.final_norm = RMSNorm(dim)

    def _block(self, layer, x, mask, rotary_emb, norm_cond, train, generator):
        _, gateloop, attn_prenorm, attn, ff_prenorm, ff = layer
        if gateloop is not None:
            x = gateloop(x) + x
        if self.adaptive:
            def norm(m, t):
                return m(t, cond=norm_cond)
        else:
            def norm(m, t):
                return m(t)
        x = attn(norm(attn_prenorm, x), mask=mask, rotary_emb=rotary_emb, train=train,
                 generator=generator, prefix=self.num_register_tokens) + x
        return ff(norm(ff_prenorm, x)) + x

    def rotary_table(self, seq_len: int, device) -> torch.Tensor:
        """The rotary table of seq_len frames after the registers (at -10000),
        offset by the shard under `seq_shard`."""
        num_reg = self.num_register_tokens
        shard = current_shard()
        offset = 0
        if shard is not None:
            if self.layers and self.layers[0][1] is not None:
                raise ValueError("GateLoop's recurrence spans the whole sequence: it is not "
                                 "supported under sequence parallelism")
            offset = shard.rank * seq_len  # seq_len is the shard's
        positions = torch.arange(offset, offset + seq_len, device=device, dtype=torch.float32)
        if num_reg > 0:
            positions = torch.cat([positions.new_full((num_reg,), -10000.0), positions])
        return self.rotary_emb(positions)

    def layer_forward(self, i: int, x: torch.Tensor, skip: Optional[torch.Tensor], mask,
                      rotary_emb, norm_cond, train: bool = False,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Layer i: the skip combine (where layer i has one; `skip` is the
        activation it pops), then the block, rematerialised under `remat`."""
        layer = self.layers[i]
        if layer[0] is not None:
            x = layer[0](torch.cat([x, skip * self.skip_connect_scale], dim=-1))
        block = partial(self._block, layer, mask=mask, rotary_emb=rotary_emb,
                        norm_cond=norm_cond, train=train, generator=generator)
        if self.remat:
            draws = train and self.attn_dropout > 0 and generator is not None
            return remat_call(block, x, policy=self.remat_policy, draws=draws)
        return block(x)

    def finish(self, x: torch.Tensor) -> torch.Tensor:
        """Registers dropped, then the final norm."""
        return self.final_norm(x[:, self.num_register_tokens:])

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                adaptive_rmsnorm_cond: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`train` turns attention dropout on, its keep masks drawn from
        `generator`."""
        batch, seq_len, _ = x.shape
        num_reg = self.num_register_tokens
        if num_reg > 0:
            registers = self.register_tokens.to(x.dtype).expand(batch, -1, -1)
            x = torch.cat([registers, x], dim=1)
            if mask is not None:
                mask = torch.cat([mask.new_ones(batch, num_reg), mask], dim=1)
        rotary_emb = self.rotary_table(seq_len, x.device)
        skips = []
        for i, layer in enumerate(self.layers):
            skip = None
            if layer[0] is None:
                skips.append(x)
            else:
                skip = skips.pop()
            x = self.layer_forward(i, x, skip, mask, rotary_emb, adaptive_rmsnorm_cond,
                                   train=train, generator=generator)
        return self.finish(x)
