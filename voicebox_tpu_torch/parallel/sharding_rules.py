"""Parameter placement rules: replicated, FSDP-style and tensor-parallel
layouts over the ("data", "model") mesh.

Counterpart of `voicebox_tpu/parallel/sharding_rules.py`.
`param_partition_spec` is the JAX package's rule, whole: a pure function of
a parameter's path, its shape in the JAX layout and the mesh shape.

* `replicated`: every rank holds every parameter (plain data parallelism);
* `fsdp`: every parameter of at least `min_fsdp_size` elements is split
  along its largest axis that divides over the "data" axis (the first such
  axis on a tie), all others replicated;
* `tp`: Megatron's layout on the "model" axis (qkv and up projections by
  output, out and down projections by input, embeddings by vocabulary);
* `fsdp+tp`: the tp rules first, then fsdp on what they left.

`module_partition_specs` applies the rule to a torch module: a flax Dense
kernel is (in, out) where a torch `Linear` weight is (out, in), and a flax
Conv kernel (k, in / groups, out) where a `Conv1d` weight is (out,
in / groups, k), so the rule runs on the reversed shape and its axes are
reversed back. Module names are the JAX package's where the rules read
them: a feed-forward's `ff.0` and `ff.3` are its `proj_in` and `proj_out`.
The trainers apply every mode (`data_parallel.py`; the "model" pieces in
`tensor_parallel.py`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

from torch import nn

from .mesh import DATA_AXIS, MODEL_AXIS

__all__ = ["APPLIED_MODES", "MODES", "module_partition_specs", "param_partition_spec"]

MODES = ("replicated", "fsdp", "tp", "fsdp+tp")
APPLIED_MODES = ("replicated", "fsdp", "tp", "fsdp+tp")

# parent-name substrings that get Megatron column / row sharding on "model"
_COLUMN_PARALLEL = ("to_qkv", "proj_in", "to_q", "to_kv")  # shard the output dim
_ROW_PARALLEL = ("to_out", "proj_out")  # shard the input dim
_VOCAB_PARALLEL = ("to_cond_emb", "to_phoneme_emb", "text_embed", "sem_embed")

Spec = Tuple[Optional[str], ...]


def param_partition_spec(path: Union[str, Sequence[str]], shape: Sequence[int],
                         mode: str = "replicated", mesh_shape: Optional[dict] = None,
                         min_fsdp_size: int = 2 ** 16) -> Spec:
    """The mesh axis of each axis of one parameter (None: not split), by the
    rules of `mode`; `()` under "replicated". `path` is the parameter's
    names (a tuple or dotted), `shape` in the JAX layout."""
    if mode not in MODES:
        raise ValueError(f"unknown param_sharding {mode!r} (use one of {MODES})")
    if mode == "replicated":
        return ()
    names = tuple(path.split(".")) if isinstance(path, str) else tuple(path)
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    model_n = (mesh_shape or {}).get(MODEL_AXIS, 1)
    data_n = (mesh_shape or {}).get(DATA_AXIS, 1)
    spec = [None] * ndim

    if "tp" in mode and model_n > 1 and ndim >= 2:
        parent = names[-2] if len(names) >= 2 else ""
        if any(s in parent for s in _COLUMN_PARALLEL) and shape[-1] % model_n == 0:
            spec[-1] = MODEL_AXIS
        elif any(s in parent for s in _ROW_PARALLEL) and shape[-2] % model_n == 0:
            spec[-2] = MODEL_AXIS
        elif any(s in parent for s in _VOCAB_PARALLEL) and shape[0] % model_n == 0:
            spec[0] = MODEL_AXIS

    if "fsdp" in mode and data_n > 1 and math.prod(shape) >= min_fsdp_size:
        # the largest still-unsplit axis that divides over "data"
        for ax in sorted(range(ndim), key=lambda i: -shape[i]):
            if spec[ax] is None and shape[ax] % data_n == 0:
                spec[ax] = DATA_AXIS
                break
    return tuple(spec)


def _jax_name(module: nn.Module, owner: str) -> str:
    """The JAX package's name of the module that owns a parameter: its own
    name, a feed-forward's `proj_in` / `proj_out` for `ff.0` / `ff.3`, and
    the container's name for another index."""
    parent, _, last = owner.rpartition(".")
    if not last.isdigit():
        return last
    container = module.get_submodule(parent) if parent else module
    if (isinstance(container, nn.Sequential) and len(container) > 1
            and type(container[1]).__name__ == "GEGLU"):
        return {"0": "proj_in", "3": "proj_out"}.get(last, last)
    return _jax_name(module, parent) if parent else last


def module_partition_specs(module: nn.Module, mode: str = "replicated",
                           mesh_shape: Optional[dict] = None,
                           min_fsdp_size: int = 2 ** 16) -> Dict[str, Spec]:
    """`param_partition_spec` for every parameter of `module`, by name, in
    the torch layout: one entry per axis."""
    specs = {}
    for name, p in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        flip = leaf == "weight" and isinstance(
            module.get_submodule(owner) if owner else module, (nn.Linear, nn.Conv1d))
        shape = tuple(p.shape)[::-1] if flip else tuple(p.shape)
        spec = param_partition_spec((_jax_name(module, owner), leaf), shape, mode, mesh_shape,
                                    min_fsdp_size)
        spec = spec + (None,) * (len(shape) - len(spec))
        specs[name] = spec[::-1] if flip else spec
    return specs
