"""Tensor parallelism over the mesh's "model" group: Megatron's layout on
the VoiceBox denoiser.

The JAX package gets tensor parallelism from placement alone:
`sharding_rules.py` splits `to_qkv` / `proj_in` by output, `to_out` /
`proj_out` by input and the embeddings by vocabulary over "model", and
XLA inserts the collectives, so the math is the single device's. Here each
rank holds the pieces of the split parameters it computes with and calls
the collectives itself (`collectives.py`):

* attention: the rank's heads. It holds its heads' rows of q, k and v in
  the fused `to_qkv` (a gather of rows, not the rule's contiguous chunk,
  which at model 2 and the flagship's 3 x 512 outputs would be all of q
  and half of k; the same number of rows), uses its heads' `q_norm` /
  `k_norm` gains, runs K1 (and K2 / K3 in training) on (b, heads / model,
  n, d) and multiplies by its heads' columns of `to_out` (the rule's
  chunk); one all-reduce of the partial sums follows, and the input's
  gradient is all-reduced in the backward;
* feed-forward: where the inner width divides over "model", the rank takes
  its columns of both GEGLU halves (x and gate) of `proj_in` and the same
  rows of `proj_out`, one all-reduce after (`proj_out`'s bias added once,
  after it); where only `proj_in`'s doubled width divides (the flagship's
  1365), `proj_in` is split as the rule splits it (its contiguous chunk),
  the pre-activation is all-gathered, and `proj_out` stays whole, as the
  rule leaves it;
* any other Linear the rule splits by output (a codec's `proj_in`,
  GateLoop's `to_qkva`): the rule's chunk, the output all-gathered;
* the cond-token embedding, where its rows divide: the rule's chunk of
  rows, ids outside it give zeros, one all-reduce.

The gains of qk-norm and the biases of layers split by output are whole on
every rank, as the rule leaves them (it splits matrices only), and each
rank uses and differentiates its part only: their gradients are summed
over "model" (`partial`). Every other whole parameter is computed alike on
every rank, so its gradient is the whole gradient there.

`shard_module(module, group, specs)` replaces each split parameter by this
rank's piece and returns `({name: Split}, partial names)`; `Split.whole`
rebuilds the whole tensor from every rank's piece (an all-gather),
`Split.local` takes this rank's piece of a whole tensor. Checkpoints keep
the reference layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from .collectives import all_gather_into
from .mesh import MODEL_AXIS

__all__ = ["Split", "TPGroup", "shard_module"]


@dataclass
class TPGroup:
    """The "model" process group a module computes over."""

    group: object
    rank: int
    size: int
    mode: str = "column"  # a Linear's: "column", "column_gather" or "row"
    rows: Optional[torch.Tensor] = None  # a column Linear's rows of its whole bias


@dataclass
class Split:
    """How a split parameter lies over "model": along `axis` rank r holds
    the whole's indices `index[r]`, in that order."""

    axis: int
    index: List[torch.Tensor]
    rank: int
    group: object

    def local(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a whole tensor (a copy)."""
        return whole.index_select(self.axis, self.index[self.rank].to(whole.device))

    def whole(self, piece: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's piece (all call it)."""
        world = len(self.index)
        moved = piece.movedim(self.axis, 0).contiguous()
        out = torch.empty((world * moved.shape[0], *moved.shape[1:]), dtype=piece.dtype,
                          device=piece.device)
        all_gather_into(out, moved, self.group)
        order = torch.cat(self.index).to(piece.device)
        whole = torch.empty_like(out).index_copy_(0, order, out)
        return whole.movedim(0, self.axis).contiguous()


def _chunk(n: int, size: int) -> List[torch.Tensor]:
    return list(torch.arange(n).chunk(size))


def _heads(h: int, d: int, size: int, blocks: int) -> List[torch.Tensor]:
    """Rows of `blocks` stacked (h * d)-row blocks (q, k, v) held by each
    rank: its h / size heads in every block."""
    hl = h // size
    return [torch.cat([torch.arange(j * h * d + r * hl * d, j * h * d + (r + 1) * hl * d)
                       for j in range(blocks)]) for r in range(size)]


def _place(module: nn.Module, name: str, split: Split) -> None:
    owner, _, leaf = name.rpartition(".")
    parent = module.get_submodule(owner) if owner else module
    old = getattr(parent, leaf)
    setattr(parent, leaf, nn.Parameter(split.local(old.detach()).clone(),
                                       requires_grad=old.requires_grad))


def shard_module(module: nn.Module, group, specs: Dict[str, tuple]):
    """Replace the parameters the rule (`specs`, `module_partition_specs`
    under "tp" or "fsdp+tp") splits over "model" by this rank's pieces and
    mark the layers that compute with them; returns ({name: Split}, the
    names of the whole parameters whose gradients are partial). Raises for a
    split parameter whose layer has no tensor-parallel form."""
    from ..models.attention import Attention
    from ..models.primitives import GEGLU, Linear

    rank, size = dist.get_rank(group), dist.get_world_size(group)
    split_names = {n for n, s in specs.items() if MODEL_AXIS in s}
    splits: Dict[str, Split] = {}
    partial: List[str] = []
    handled = set()

    def split(name, axis, index, linear_mode: Optional[str] = None):
        splits[name] = Split(axis, index, rank, group)
        if linear_mode is None:
            return
        owner = name.rpartition(".")[0]
        layer = module.get_submodule(owner)
        rows = None
        if linear_mode != "row" and layer.bias is not None:
            rows = index[rank].to(layer.bias.device)
            partial.append(f"{owner}.bias")
        layer.tp = TPGroup(group, rank, size, linear_mode, rows)

    for mname, m in module.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(m, Attention):
            h, d = m.heads, m.dim_head
            if h % size:
                raise ValueError(f"{mname}: {h} heads do not split over model={size}")
            qkv, out = f"{prefix}to_qkv.weight", f"{prefix}to_out.weight"
            if not {qkv, out} <= split_names:
                raise NotImplementedError(f"{mname}: the rule splits only part of attention")
            split(qkv, 0, _heads(h, d, size, 3), "column")
            split(out, 1, _heads(h, d, size, 1), "row")
            m.tp = TPGroup(group, rank, size)
            if m.qk_norm_scale is not None:
                partial += [f"{prefix}q_norm.gamma", f"{prefix}k_norm.gamma"]
            handled |= {qkv, out}
        elif (isinstance(m, nn.Sequential) and len(m) == 4 and isinstance(m[1], GEGLU)
              and f"{prefix}0.weight" in split_names):
            inner = m[3].in_features
            w_in, w_out = f"{prefix}0.weight", f"{prefix}3.weight"
            if w_out in split_names:  # both halves' columns, the Megatron pair
                split(w_in, 0, _heads(size, inner // size, size, 2), "column")
                split(w_out, 1, _chunk(inner, size), "row")
                handled |= {w_in, w_out}
            else:  # the rule's chunk of proj_in, the activation gathered
                split(w_in, 0, _chunk(2 * inner, size), "column_gather")
                handled.add(w_in)
    for name in sorted(split_names - handled):
        owner, _, leaf = name.rpartition(".")
        layer = module.get_submodule(owner) if owner else module
        spec = specs[name]
        if isinstance(layer, Linear) and leaf == "weight" and spec[0] == MODEL_AXIS:
            split(name, 0, _chunk(layer.out_features, size), "column_gather")  # gathered
            handled.add(name)
        elif isinstance(layer, nn.Embedding) and spec[0] == MODEL_AXIS:  # by vocabulary
            split(name, 0, _chunk(layer.num_embeddings, size))
            layer.tp = TPGroup(group, rank, size)
            layer.tp_rows = int(splits[name].index[rank][0])
            handled.add(name)
        else:
            raise NotImplementedError(
                f"{name}: the tensor-parallel rule splits it {spec}, and its layer "
                f"({type(layer).__name__}) has no tensor-parallel form here")
    for name, s in splits.items():
        _place(module, name, s)
    return splits, partial
