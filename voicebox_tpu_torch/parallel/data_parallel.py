"""The trainers' parallel layouts over the mesh: data parallelism over
"data", with FSDP, tensor parallelism over "model" and sequence
parallelism over "seq".

The JAX package runs one SPMD program: the batch is split over "data",
XLA inserts one `psum` of the gradients per step, and under "fsdp" the
large parameters and their optimizer state live split over "data"
(`voicebox_tpu/parallel/sharding_rules.py`). Here each rank is a process
that runs the model on its rows, and `DataParallel` does the rest by hand:

* at set-up, every rank takes rank 0's weights (a broadcast, as DDP does);
  under a "model" axis each rank then keeps its pieces of the parameters
  the tensor-parallel rule splits (`tensor_parallel.py`);
* once a step, after the last micro-batch, the gradients are reduced over
  "data" in fp32 and divided by its size: the mean over ranks of equal
  rows is the mean over the global batch, as the JAX `psum` gives it. The
  gradients a "model" rank holds only its part of (the qk-norm gains, the
  whole biases of split layers) are first summed over "model"; under a
  "seq" axis the gradients are summed over it too (each rank's are its
  frames' share), as JAX's `psum` over "seq" is. No hook on the module
  takes part, so the bf16 live copies the trainer swaps in need no care,
  and the kernels K1-K4 see plain tensors;
* "replicated": the whole gradients and the step's loss go through ONE
  all-reduce of a flat fp32 buffer;
* "fsdp": every parameter the rule splits over "data" is held by the
  optimizer as this rank's shard, a `Parameter` of its own: the fp32
  master, both Adam moments and the EMA are split along the rule's axis.
  Its gradients go through a reduce-scatter straight into this rank's
  shard, in buckets of at most `BUCKET` elements, each rank's piece of a
  gradient copied into the bucket and the gradient freed as it is; what
  stays whole (and the loss) goes through one all-reduce. The clip's sum
  of squares is all-reduced over the shards, the optimizer steps the
  shards, and an all-gather rebuilds the module's whole weights: straight
  into the module's storage where the rule splits the first axis (a
  parameter's pieces are then its contiguous blocks), through one bucket
  copied into the module's strided blocks where it splits another. The
  module holds whole weights between steps, so validation, sampling and a
  rank-0 checkpoint need no collective;
* "tp" and "fsdp+tp": the tensor-parallel pieces first, then (with fsdp)
  the same on what the rule leaves, over "data", of the pieces.

Under "fsdp" a rank saves, beside the moments' split share, the bytes of
the reduction's flat buffer (the whole gradients' size under "replicated",
one bucket here), and moves half the bytes of an all-reduce.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from .collectives import all_gather_into, all_reduce
from .mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS
from .sharding_rules import APPLIED_MODES, MODES, module_partition_specs
from .tensor_parallel import Split, shard_module

__all__ = ["BUCKET", "DataParallel"]

BUCKET = 2 ** 24  # elements of a reduce-scatter's or an all-gather's bucket


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown param_sharding {mode!r} (use one of {APPLIED_MODES})")


def _size(mesh, axis: str) -> int:
    return mesh[axis].size() if axis in (mesh.mesh_dim_names or ()) else 1


class DataParallel:
    """`named_params` (the trainer's, named as in `module`) laid out over
    the mesh under `mode`; the module's split parameters are replaced by
    this rank's pieces (`named_params` then holds them)."""

    def __init__(self, mesh, module: nn.Module, named_params: Sequence[Tuple[str, nn.Parameter]],
                 mode: str = "replicated", min_fsdp_size: int = 2 ** 16):
        check_mode(mode)
        self.mesh, self.mode = mesh, mode
        self.group = mesh.get_group(DATA_AXIS)
        self.rank, self.world = mesh.get_local_rank(DATA_AXIS), mesh[DATA_AXIS].size()
        self.model, self.seq = _size(mesh, MODEL_AXIS), _size(mesh, SEQ_AXIS)
        if self.model > 1 and "tp" not in mode:
            raise ValueError(f"a model axis of {self.model} needs param_sharding 'tp' or "
                             f"'fsdp+tp', got {mode!r}")
        if self.seq > 1 and mode != "replicated":
            raise ValueError("sequence parallelism keeps the parameters replicated")
        self.tp_group = mesh.get_group(MODEL_AXIS) if self.model > 1 else None
        self.tp_rank = mesh.get_local_rank(MODEL_AXIS) if self.model > 1 else 0
        self.seq_group = mesh.get_group(SEQ_AXIS) if self.seq > 1 else None
        self.seq_rank = mesh.get_local_rank(SEQ_AXIS) if self.seq > 1 else 0
        # the mesh's second axis ("model" or "seq"), whose ranks share a data rank
        self.inner = self.tp_group or self.seq_group
        self.names = [n for n, _ in named_params]
        params = [p for _, p in named_params]
        specs = module_partition_specs(module, mode, {DATA_AXIS: self.world,
                                                      MODEL_AXIS: self.model}, min_fsdp_size)
        with torch.no_grad():
            self.broadcast([p.data for p in params])
        self.splits: Dict[str, Split] = {}
        partial: List[str] = []
        if self.model > 1:
            self.splits, partial = shard_module(module, self.tp_group, specs)
        by_name = dict(module.named_parameters())
        self.params = [by_name[n] for n in self.names]
        self.partial = [n in partial for n in self.names]
        self.axes: List[Optional[int]] = [
            specs[n].index(DATA_AXIS) if DATA_AXIS in specs[n] else None for n in self.names]
        with torch.no_grad():
            # the tensors the optimizer steps: this rank's shard, or the parameter
            self.shards = [p if a is None else nn.Parameter(self.local(p.detach(), a).clone())
                           for p, a in zip(self.params, self.axes)]

    @property
    def named_params(self) -> List[Tuple[str, nn.Parameter]]:
        return list(zip(self.names, self.params))

    @property
    def sharded(self) -> List[bool]:
        return [a is not None for a in self.axes]

    @property
    def counted(self) -> List[bool]:
        """Per gradient after `reduce`: whether this rank counts it in a sum
        over every rank (each distinct piece once)."""
        return [(a is not None or self.rank == 0)
                and (n in self.splits or self.tp_rank == 0) and self.seq_rank == 0
                for n, a in zip(self.names, self.axes)]

    def clip_group(self):
        """The groups the clip's sum of squares is all-reduced over, in turn
        (None when every rank holds every whole gradient after `reduce`)."""
        if self.splits:
            return (self.tp_group, self.group)
        return self.group if any(self.sharded) else None

    def local(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """This rank's block of `t` along `axis` (a view)."""
        return t.chunk(self.world, dim=axis)[self.rank]

    def broadcast(self, tensors: List[torch.Tensor]) -> None:
        """The values of the mesh's first rank into `tensors` on every rank
        of the mesh: down "data" from its first rank, then along the second
        axis; one collective per dtype and axis."""
        for dtype in {t.dtype for t in tensors}:
            group = [t for t in tensors if t.dtype == dtype]
            flat = _flatten_dense_tensors(group)
            for g in (self.group, self.inner):
                if g is not None and dist.get_world_size(g) > 1:
                    dist.broadcast(flat, dist.get_global_rank(g, 0), group=g)
            for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
                t.copy_(v)

    def _buckets(self, idx: List[int], sizes: List[int]):
        bucket, total = [], 0
        for i in idx:
            if bucket and total + sizes[i] > BUCKET:
                yield bucket
                bucket, total = [], 0
            bucket.append(i)
            total += sizes[i]
        if bucket:
            yield bucket

    def reduce(self, grads: List[Optional[torch.Tensor]],
               scalars: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """The mean over "data" (and sum over "seq") of the gradients (fp32)
        and of `scalars` (a 1-D tensor: the loss). Under "fsdp" a split
        parameter's gradient comes back as this rank's shard; `grads`'
        entries (and the parameters' `.grad`) are released as they are
        reduced."""
        n = len(grads)
        out: List[Optional[torch.Tensor]] = [None] * n
        if self.tp_group is not None:  # the heads' and rows' shares, summed over "model"
            part = [i for i in range(n) if self.partial[i]]
            flat = torch.cat([grads[i].reshape(-1).float() for i in part])
            all_reduce(flat, self.tp_group)
            for i, t in zip(part, _unflatten_dense_tensors(flat, [grads[i] for i in part])):
                grads[i] = t
        whole = [i for i in range(n) if self.axes[i] is None]
        flat = torch.cat([grads[i].reshape(-1).float() for i in whole]
                         + [scalars.reshape(-1).float()])
        k = scalars.numel()
        if self.seq_group is not None:  # each rank's frames' share, summed over "seq"
            all_reduce(flat[:-k], self.seq_group)
        if self.world > 1:
            all_reduce(flat, self.group)
        flat.div_(self.world)
        offset = 0
        for i in whole:
            out[i] = flat[offset:offset + grads[i].numel()].view(grads[i].shape)
            offset += grads[i].numel()
        rest = flat[offset:].clone()  # a view would keep the whole buffer alive
        split = [i for i in range(n) if self.axes[i] is not None]
        sizes = {i: grads[i].numel() for i in split}
        for bucket in self._buckets(split, sizes):
            per = sum(sizes[i] // self.world for i in bucket)
            buf = torch.empty((self.world, per), dtype=torch.float32, device=scalars.device)
            offset = 0
            for i in bucket:
                m = sizes[i] // self.world
                for r, piece in enumerate(grads[i].chunk(self.world, self.axes[i])):
                    buf[r, offset:offset + m].view(piece.shape).copy_(piece)
                offset += m
                grads[i] = self.params[i].grad = None
            mine = torch.empty(per, dtype=torch.float32, device=buf.device)
            dist.reduce_scatter_tensor(mine, buf.view(-1), group=self.group)
            del buf
            mine.div_(self.world)
            offset = 0
            for i in bucket:
                m = sizes[i] // self.world
                out[i] = mine[offset:offset + m].view(self.shards[i].shape)
                offset += m
        return out, rest

    def mean(self, values: torch.Tensor) -> torch.Tensor:
        """The mean over "data" of a small fp32 tensor (equal on the ranks
        of the second axis)."""
        return all_reduce(values.float().clone(), self.group).div_(self.world)

    def total(self, values: torch.Tensor) -> torch.Tensor:
        """The sum over "data" ranks of a small tensor."""
        return all_reduce(values.clone(), self.group)

    @torch.no_grad()
    def _gather_into(self, shards: Sequence[torch.Tensor],
                     into: Sequence[torch.Tensor]) -> None:
        """Every rank's shards of the split parameters into the whole tensors
        `into`: an all-gather into a target's own storage where its pieces are
        its contiguous blocks, else through one bucket."""
        split = [i for i, a in enumerate(self.axes) if a is not None]
        rest = []
        for i in split:
            if self.axes[i] == 0 and into[i].is_contiguous():
                all_gather_into(into[i], shards[i].detach().contiguous(), self.group)
            else:
                rest.append(i)
        sizes = {i: shards[i].numel() for i in rest}
        for bucket in self._buckets(rest, {i: s * self.world for i, s in sizes.items()}):
            per = sum(sizes[i] for i in bucket)
            dtype = shards[bucket[0]].dtype
            if any(shards[i].dtype != dtype for i in bucket):
                for i in bucket:  # one dtype a bucket
                    self._gather_bucket([i], shards, into, sizes[i])
                continue
            self._gather_bucket(bucket, shards, into, per)

    def _gather_bucket(self, bucket, shards, into, per) -> None:
        dtype, device = shards[bucket[0]].dtype, shards[bucket[0]].device
        local = torch.cat([shards[i].detach().reshape(-1) for i in bucket])
        gathered = torch.empty((self.world, per), dtype=dtype, device=device)
        all_gather_into(gathered.view(-1), local, self.group)
        offset = 0
        for i in bucket:
            m = shards[i].numel()
            for r, block in enumerate(into[i].chunk(self.world, self.axes[i])):
                block.copy_(gathered[r, offset:offset + m].view(block.shape))
            offset += m

    def gather(self, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Whole tensors (of this rank's tensor-parallel pieces) from every
        rank's shards; a tensor that is not split comes back as it is."""
        out = list(shards)
        into = [None if a is None else
                torch.empty(p.shape, dtype=s.dtype, device=s.device)
                for p, s, a in zip(self.params, shards, self.axes)]
        self._gather_into(shards, into)
        for i, a in enumerate(self.axes):
            if a is not None:
                out[i] = into[i]
        return out

    def gather_params(self) -> None:
        """The module's whole weights from the optimizer's updated shards."""
        if "fsdp" in self.mode:
            self._gather_into(self.shards, [p.data for p in self.params])

    def whole(self, tensors: Sequence[torch.Tensor], sharded: bool = True) -> List[torch.Tensor]:
        """The reference layout's whole tensors from this rank's tensors of
        every parameter (the optimizer's, shards where `sharded`; else the
        module's): gathered over "data", then over "model". Every rank
        calls it."""
        out = self.gather(tensors) if sharded and any(self.sharded) else list(tensors)
        return [self.splits[n].whole(t) if n in self.splits and t is not None else t
                for n, t in zip(self.names, out)]

    def module_state(self, module: nn.Module) -> dict:
        """`module`'s state dict in the reference layout (every rank calls it)."""
        state = module.state_dict()
        if self.splits:
            wholes = self.whole([p.detach() for p in self.params], sharded=False)
            for n, t in zip(self.names, wholes):
                if n in self.splits:
                    state[n] = t
        return state

    def local_state(self, state: dict) -> dict:
        """This rank's pieces of a whole state dict, for the module."""
        return {k: self.splits[k].local(v) if k in self.splits else v for k, v in state.items()}

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
        """This rank's piece of a whole tensor of parameter `i` (a copy): its
        tensor-parallel piece, then its shard."""
        if t is None:
            return t
        name = self.names[i]
        if name in self.splits:
            t = self.splits[name].local(t)
        if self.axes[i] is None:
            return t
        return self.local(t, self.axes[i]).clone()
