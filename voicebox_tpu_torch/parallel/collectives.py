"""The collectives of the model-parallel layouts, and their transposes.

The JAX package gets these from XLA inside one SPMD program (`psum`,
`ppermute`, `all_gather` and their transposes under `jax.grad`). Here each
rank is a process, so each collective is called by hand, and the ones that
sit inside a model's forward are autograd Functions whose backward is the
forward's transpose:

* `copy_to_group`: identity forward, all-reduce (sum) of the gradient
  backward (Megatron's `f`: a replicated input entering a split layer);
* `reduce_from_group`: all-reduce (sum) forward, identity backward
  (Megatron's `g`: partial sums leaving a split layer; also the masked
  loss's numerator summed over "seq");
* `gather_last_from_group`: all-gather along the last axis forward, this
  rank's slice of the gradient backward;
* `mean_over_group`: the mean over the group both ways (JAX's `pmean`,
  whose transpose is itself);
* `ring_shift`: this rank's tensor to the rank `shift` places on, one
  `all_to_all_single` (JAX's `ppermute` round the ring), the primitive of
  ring attention and of the halo exchange;
* `neighbour_exchange`: a tensor to the next rank and one to the previous,
  without wrapping round, in one `all_to_all_single`: a pipeline step's
  traffic (`pipeline.py`, which passes the gradients back by hand with the
  same call).

Sums run in fp32 (a bf16 tensor is widened for its all-reduce and rounded
once after); gathers and ring passes move bytes, whatever the dtype.

Under gloo a CUDA tensor goes through host memory inside gloo itself; on
the H100 machine (torch 2.11) gloo takes CUDA tensors for every collective
here (`chip_smoke.py` phase 22).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather_into", "all_reduce", "copy_to_group", "gather_last_from_group",
           "mean_over_group", "neighbour_exchange", "reduce_from_group", "ring_shift"]


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over `group`, in place (in fp32); returns `t`."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.copy_(all_reduce(t.float(), group))
    dist.all_reduce(t, group=group)
    return t


def all_gather_into(out: torch.Tensor, t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `t` into `out` (contiguous), rank-major along axis 0."""
    dist.all_gather_into_tensor(out.view(-1).view(torch.uint8),  # as bytes
                                t.contiguous().view(-1).view(torch.uint8), group=group)
    return out


def ring_shift(t: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """The tensor of the rank `shift` places before this one on the ring
    (rank r sends to r + shift and receives from r - shift), in one
    all_to_all_single whose splits are zero but for those two ranks."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if world == 1 or shift % world == 0:
        return t.clone()
    src = t.contiguous().view(-1).view(torch.uint8)  # as bytes
    out = torch.empty_like(src)
    n = src.numel()
    ins, outs = [0] * world, [0] * world
    ins[(rank + shift) % world] = n
    outs[(rank - shift) % world] = n
    dist.all_to_all_single(out, src, outs, ins, group=group)
    return out.view(t.dtype).view(t.shape)


def neighbour_exchange(group, device, to_next=None, to_prev=None, from_prev=None,
                       from_next=None):
    """Send `to_next` to the next rank of `group` and `to_prev` to the
    previous one (the first rank has no previous, the last no next), and
    receive a tensor like the template `from_prev` from the previous rank
    and one like `from_next` from the next (None: that neighbour sends
    nothing). One all_to_all_single of bytes; every rank of the group calls
    it, with templates that match what its neighbours send, a rank with
    nothing to send or receive too. `device` holds the byte buffers.
    Returns (from the previous rank, from the next), None where nothing
    came."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if (to_prev is not None and rank == 0) or (to_next is not None and rank == world - 1):
        raise ValueError("neighbour_exchange does not wrap round the group")
    ins, outs, send = [0] * world, [0] * world, []
    for peer, t in ((rank - 1, to_prev), (rank + 1, to_next)):  # in rank order
        if t is not None:
            send.append(t.contiguous().view(-1).view(torch.uint8))
            ins[peer] = send[-1].numel()
    for peer, like in ((rank - 1, from_prev), (rank + 1, from_next)):
        if like is not None:
            outs[peer] = like.numel() * like.element_size()
    src = torch.cat(send) if send else torch.empty(0, dtype=torch.uint8, device=device)
    out = torch.empty(sum(outs), dtype=torch.uint8, device=device)
    dist.all_to_all_single(out, src, outs, ins, group=group)
    got, start = [], 0
    for peer, like in ((rank - 1, from_prev), (rank + 1, from_next)):
        if like is None:
            got.append(None)
            continue
        got.append(out[start:start + outs[peer]].view(like.dtype).view(like.shape))
        start += outs[peer]
    return tuple(got)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group).div_(dist.get_world_size(group))

    @staticmethod
    def backward(ctx, g):
        return (all_reduce(g.contiguous().clone(), ctx.group)
                .div_(dist.get_world_size(ctx.group)), None)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        ctx.rank, ctx.width = rank, x.shape[-1]
        local = x.movedim(-1, 0).contiguous()
        out = torch.empty((world * local.shape[0], *local.shape[1:]), dtype=x.dtype,
                          device=x.device)
        all_gather_into(out, local, group)
        return out.movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.width, ctx.width), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def mean_over_group(x: torch.Tensor, group) -> torch.Tensor:
    return _MeanOverGroup.apply(x, group)


def gather_last_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """(..., w) on each rank -> (..., world * w), the ranks' in order."""
    return _GatherLast.apply(x, group)

