"""The device mesh and this process's rows of a batch.

Counterpart of `voicebox_tpu/parallel/mesh.py`. The reference trains with
DDP only (trainer.py:89-95); the JAX package runs SPMD over a
`jax.sharding.Mesh` with a "data" and a "model" axis. Here the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the process group's ranks,
one process per card (or per CPU process), with the same axis names: the
batch is split over "data", and "model" is reserved for tensor parallelism,
which waits for ROADMAP item 15b (a "model" axis wider than 1 raises).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["DATA_AXIS", "MODEL_AXIS", "make_mesh", "shard_batch"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data_parallel: Optional[int] = None, model_parallel: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the process group, pure
    data parallelism by default. `device_type` is "cuda" on a machine with
    a card, else "cpu"; set the process's card (`torch.cuda.set_device`)
    first."""
    if model_parallel > 1:
        raise NotImplementedError(
            "model_parallel > 1: tensor-parallel layouts are not ported yet (ROADMAP Queue 1, "
            "item 15b)")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh needs a process group: call parallel.distributed."
                           "maybe_initialize_distributed (or torchrun) first")
    world = dist.get_world_size()
    if data_parallel is None:
        data_parallel = world // model_parallel
    if data_parallel * model_parallel != world:
        raise ValueError(f"mesh {data_parallel}x{model_parallel} != {world} processes")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(data_parallel, model_parallel),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def shard_batch(mesh: DeviceMesh, batch):
    """This rank's block of rows of a global batch (a tensor, an array, or a
    tuple / list / dict of them), split along the leading axis over "data"."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    n, size = batch.shape[0], mesh[DATA_AXIS].size()
    if n % size:
        raise ValueError(f"a batch of {n} rows does not split over {size} ranks")
    rows = n // size
    start = mesh.get_local_rank(DATA_AXIS) * rows
    return batch[start:start + rows]
