"""Sequence parallelism for the VoiceBox denoiser: the time axis split over
a "seq" process group, the whole denoiser run on each rank's shard.

Counterpart of `voicebox_tpu/parallel/sequence_parallel.py`. The JAX
package clones its modules with `seq_axis` set and runs them inside
`shard_map`; here the same modules run on a rank's frames inside
`seq_shard(group)`, which they read (`current_shard`):

* attention -> ring attention, the register tokens a replicated prefix
  (`ops/ring_attention.py::ring_attention_prefixed`); attention dropout is
  refused, as JAX refuses it;
* ConvPositionEmbed -> a halo of kernel_size // 2 frames from each
  neighbour (zeros at the ends of the sequence), the conv then run without
  padding: the full sequence's conv, shard by shard; the halo's gradient
  goes back to the neighbour that sent it (`halo_exchange`);
* rotary positions offset by the shard (the registers stay at -10000);
* `cond_token_ids` replicated, their embedding stretched to the global
  length and sliced to the shard;
* the masked mean loss: numerator and denominator summed over "seq", the
  numerator's gradient left on each rank (JAX's `psum` and its transpose);
* GateLoop's recurrence spans the whole sequence and is refused, as JAX
  refuses it.

The random numbers of the loss (the noise, the span mask, the CFG drop)
are drawn at the full length on every rank and the shard's frames kept
(`ops/masks.py::batch_frames`, beside `batch_rows` for a "data" axis), so
a rank draws what one process draws and the run equals it. Under a
("data", "seq") mesh the gradients of the replicated parameters are summed
over "seq" and averaged over "data" (`data_parallel.py`).

One module serves both ways, so the JAX package's `make_sp_pair` (a
module and its `seq_axis` clone sharing a layout) has no counterpart here.
`sp_forward(model, group)` is the vector field on the rank's frames;
`make_sp_loss_fn(cfm, group)` the CFM loss with the draws at full length;
`shard_draws` the block both it and the trainers run a rank's loss in.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

from ..ops.masks import batch_frames, batch_rows
from .collectives import ring_shift

__all__ = ["SEQ_AXIS", "SeqShard", "current_shard", "halo_exchange", "make_sp_loss_fn",
           "seq_shard", "shard_draws", "sp_forward"]

SEQ_AXIS = "seq"


@dataclass
class SeqShard:
    group: object
    rank: int
    size: int


_SHARDS: List[SeqShard] = []


@contextlib.contextmanager
def seq_shard(group):
    """Inside the block the denoiser runs on this rank's frames of a
    sequence split over `group` (one equal block of frames per rank, in
    rank order)."""
    _SHARDS.append(SeqShard(group, dist.get_rank(group), dist.get_world_size(group)))
    try:
        yield _SHARDS[-1]
    finally:
        _SHARDS.pop()


def current_shard() -> Optional[SeqShard]:
    return _SHARDS[-1] if _SHARDS else None


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, group):
        ctx.halo, ctx.group = halo, group
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        left = ring_shift(x[:, -halo:].contiguous(), group, 1)  # from rank - 1
        right = ring_shift(x[:, :halo].contiguous(), group, -1)  # from rank + 1
        if rank == 0:
            left = torch.zeros_like(left)
        if rank == world - 1:
            right = torch.zeros_like(right)
        return torch.cat([left, x, right], dim=1)

    @staticmethod
    def backward(ctx, g):
        h, group = ctx.halo, ctx.group
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        g_left, g_mid, g_right = g[:, :h], g[:, h:-h], g[:, -h:]
        if rank == 0:
            g_left = torch.zeros_like(g_left)
        if rank == world - 1:
            g_right = torch.zeros_like(g_right)
        dx = g_mid.clone()
        dx[:, -h:] += ring_shift(g_left.contiguous(), group, -1)  # back to rank - 1's end
        dx[:, :h] += ring_shift(g_right.contiguous(), group, 1)  # back to rank + 1's start
        return dx, None, None


def halo_exchange(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """(b, n_local, d) -> (b, halo + n_local + halo): `halo` frames from each
    neighbour on the ring, zeros at the sequence's two ends (the zero
    padding a full-sequence conv sees)."""
    if x.shape[1] < halo:
        raise ValueError(f"a shard of {x.shape[1]} frames is shorter than the conv's halo "
                         f"({halo}): use fewer shards or a smaller kernel")
    return _Halo.apply(x, halo, group)


def sp_forward(model, group):
    """The vector field on this rank's frames: `fn(x, times, cond, cond_mask,
    self_attn_mask[, cond_token_ids]) -> (b, n_local, latent_dim)`, x, cond
    and the masks the rank's frames, the ids whole."""

    def fn(x, times, cond, cond_mask=None, self_attn_mask=None, cond_token_ids=None):
        with seq_shard(group):
            return model(x, times=times, cond=cond, cond_mask=cond_mask,
                         self_attn_mask=self_attn_mask, cond_token_ids=cond_token_ids,
                         cond_drop_prob=0.0)

    return fn


def shard_draws(group, frames: int, rows=None) -> contextlib.ExitStack:
    """The block a rank's loss runs in: the denoiser on its `frames` of a
    sequence split over `group`, every frame-shaped draw made at the full
    length and cut to them, and with `rows` = (offset, rows, total) every
    row-shaped draw cut to the rank's rows of a batch split over "data"."""
    stack = contextlib.ExitStack()
    if rows is not None:
        stack.enter_context(batch_rows(*rows))
    if group is not None:
        shard = stack.enter_context(seq_shard(group))
        stack.enter_context(batch_frames(shard.rank * frames, frames, shard.size * frames))
    return stack


def make_sp_loss_fn(cfm, group, *, rows=None):
    """The CFM loss on this rank's frames (and, with `rows`, its rows):
    `loss_fn(x1, mask=, cond_token_ids=, cond=, generator=, **draws)`, the
    wrapper's `loss_fn` inside `shard_draws`: the span mask built over the
    full length and cut, the loss over the whole sequence on every rank.
    Explicit draws (`noise`, `cond_mask`) are the rank's frames."""

    def loss_fn(x1, **kw):
        with shard_draws(group, x1.shape[1], rows):
            return cfm.loss_fn(x1, **kw)

    return loss_fn
