"""The trainers' data-parallel layouts over the mesh's "data" axis.

The JAX package runs one SPMD program: the batch is split over "data",
XLA inserts one `psum` of the gradients per step, and under "fsdp" the
large parameters and their optimizer state live split over "data"
(`voicebox_tpu/parallel/sharding_rules.py`). Here each rank is a process
that runs the model on its rows, and `DataParallel` does the rest by hand:

* at set-up, every rank takes rank 0's weights (a broadcast, as DDP does);
* once a step, after the last micro-batch, the gradients (in fp32) and the
  step's loss go through ONE all-reduce and are divided by the world size:
  the mean over ranks of equal rows is the mean over the global batch, as
  the JAX `psum` gives it. No hook on the module takes part, so the bf16
  live copies the trainer swaps in need no care, and the kernels K1-K4
  see the plain tensors of a single-process step;
* "fsdp": every parameter the rule splits (`sharding_rules`) is held by
  the optimizer as this rank's shard, a `Parameter` of its own: the fp32
  master, both Adam moments and the EMA are split along the rule's axis.
  After the reduction each rank keeps its shard of those gradients, the
  clip's sum of squares is all-reduced over the shards, the optimizer
  steps the shards, and one all-gather rebuilds the whole weights in the
  module for the next step. The module holds whole weights between steps,
  so validation, sampling and a rank-0 checkpoint need no collective.
  Parameters under `min_fsdp_size`, or with no axis that divides, stay
  whole on every rank, as the rule leaves them.

The reduction is an all-reduce in both layouts (a reduce-scatter would move
half the bytes under "fsdp"), so the two move the same bytes a step; what
"fsdp" saves is the optimizer's state, 2 x (1 - 1 / world) of the split
parameters' fp32 bytes less the master shard's 1 / world.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from .mesh import DATA_AXIS, MODEL_AXIS
from .sharding_rules import APPLIED_MODES, MODES, module_partition_specs

__all__ = ["DataParallel"]


def check_mode(mode: str) -> None:
    if mode in APPLIED_MODES:
        return
    if mode in MODES:
        raise NotImplementedError(
            f"param_sharding={mode!r}: tensor-parallel layouts are not ported yet "
            "(ROADMAP Queue 1, item 15b)")
    raise ValueError(f"unknown param_sharding {mode!r} (use one of {APPLIED_MODES})")


class DataParallel:
    """`named_params` (the trainer's, named as in `module`) laid out over
    the mesh's "data" axis under `mode` ("replicated" or "fsdp")."""

    def __init__(self, mesh, module: nn.Module, named_params: Sequence[Tuple[str, nn.Parameter]],
                 mode: str = "replicated", min_fsdp_size: int = 2 ** 16):
        check_mode(mode)
        self.mesh, self.mode = mesh, mode
        self.group = mesh.get_group(DATA_AXIS)
        self.rank, self.world = mesh.get_local_rank(DATA_AXIS), mesh[DATA_AXIS].size()
        self.src = dist.get_global_rank(self.group, 0)
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        specs = module_partition_specs(module, mode, {DATA_AXIS: self.world, MODEL_AXIS: 1},
                                       min_fsdp_size)
        self.axes: List[Optional[int]] = [
            specs[n].index(DATA_AXIS) if DATA_AXIS in specs[n] else None for n in self.names]
        with torch.no_grad():
            self.broadcast([p.data for p in self.params])
            # the tensors the optimizer steps: this rank's shard, or the parameter
            self.shards = [p if a is None else nn.Parameter(self.local(p.detach(), a).clone())
                           for p, a in zip(self.params, self.axes)]

    @property
    def sharded(self) -> List[bool]:
        return [a is not None for a in self.axes]

    def local(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """This rank's block of `t` along `axis` (a view)."""
        return t.chunk(self.world, dim=axis)[self.rank]

    def broadcast(self, tensors: List[torch.Tensor]) -> None:
        """Rank 0's values into `tensors` on every rank, one collective per dtype."""
        for dtype in {t.dtype for t in tensors}:
            group = [t for t in tensors if t.dtype == dtype]
            flat = _flatten_dense_tensors(group)
            dist.broadcast(flat, self.src, group=self.group)
            for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
                t.copy_(v)

    def reduce(self, grads: List[torch.Tensor],
               scalars: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """The mean over ranks of the gradients (fp32) and of `scalars` (a
        1-D tensor: the loss), in one all-reduce. Under "fsdp" a split
        parameter's gradient comes back as this rank's shard."""
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [scalars.reshape(-1).float()])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.world)
        out, offset = [], 0
        for g, a in zip(grads, self.axes):
            piece = flat[offset:offset + g.numel()].view(g.shape)
            out.append(piece if a is None else self.local(piece, a).clone())
            offset += g.numel()
        return out, flat[offset:].clone()  # a view would keep the whole buffer alive

    def mean(self, values: torch.Tensor) -> torch.Tensor:
        """The mean over ranks of a small fp32 tensor."""
        values = values.float().clone()
        dist.all_reduce(values, group=self.group)
        return values.div_(self.world)

    def total(self, values: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of a small tensor."""
        values = values.clone()
        dist.all_reduce(values, group=self.group)
        return values

    @torch.no_grad()
    def gather(self, shards: Sequence[torch.Tensor],
               into: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
        """Whole tensors from every rank's shards (one all-gather per dtype);
        a tensor that is not split comes back as it is. With `into`, each
        whole tensor is copied there as it is made (one at a time)."""
        out = list(shards)
        split = [i for i, a in enumerate(self.axes) if a is not None]
        for dtype in {shards[i].dtype for i in split}:
            idx = [i for i in split if shards[i].dtype == dtype]
            local = _flatten_dense_tensors([shards[i] for i in idx])
            pieces = [torch.empty_like(local) for _ in range(self.world)]
            dist.all_gather(pieces, local, group=self.group)
            per_rank = [_unflatten_dense_tensors(p, [shards[i] for i in idx]) for p in pieces]
            for k, i in enumerate(idx):
                whole = torch.cat([r[k] for r in per_rank], dim=self.axes[i])
                if into is None:
                    out[i] = whole
                else:
                    into[i].copy_(whole)
        return out if into is None else list(into)

    def gather_params(self) -> None:
        """The module's whole weights from the optimizer's updated shards."""
        if self.mode == "fsdp":
            self.gather(self.shards, into=[p.data for p in self.params])

    def dtensor(self, i: int, t: torch.Tensor):
        """Parameter i's shard `t` as a `DTensor` over "data", for the
        sharded checkpoint (sharing `t`'s storage); a whole tensor as it is."""
        if self.axes[i] is None:
            return t
        from torch.distributed.tensor import DTensor, Shard

        full = self.params[i].shape
        stride = tuple(math.prod(full[k + 1:]) for k in range(len(full)))
        return DTensor.from_local(t, self.mesh[DATA_AXIS], [Shard(self.axes[i])],
                                  run_check=False, shape=full, stride=stride)

    def shard_of(self, i: int, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's piece of a whole tensor of parameter `i` (a copy)."""
        if t is None or self.axes[i] is None:
            return t
        return self.local(t, self.axes[i]).clone()
