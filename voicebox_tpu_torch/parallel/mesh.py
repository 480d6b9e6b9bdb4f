"""The device mesh and this process's rows of a batch.

Counterpart of `voicebox_tpu/parallel/mesh.py`. The reference trains with
DDP only (trainer.py:89-95); the JAX package runs SPMD over a
`jax.sharding.Mesh` with a "data" and a "model" axis. Here the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the process group's ranks,
one process per card (or per CPU process), with the same axis names: the
batch is split over "data", the tensor-parallel pieces over "model"
(`tensor_parallel.py`). Sequence parallelism builds a ("data", "seq") mesh
instead (`seq_parallel > 1`), as the JAX trainer does: the batch over
"data", the time axis over "seq".
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "make_mesh", "shard_batch"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


def make_mesh(data_parallel: Optional[int] = None, model_parallel: int = 1,
              device_type: Optional[str] = None, seq_parallel: int = 1) -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the process group, pure
    data parallelism by default; with `seq_parallel > 1` a ("data", "seq")
    mesh. Consecutive ranks share a "data" row. `device_type` is "cuda" on
    a machine with a card, else "cpu"; set the process's card
    (`torch.cuda.set_device`) first."""
    if model_parallel > 1 and seq_parallel > 1:
        raise ValueError("sequence parallelism keeps the parameters replicated: a mesh takes "
                         "model_parallel or seq_parallel, not both")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh needs a process group: call parallel.distributed."
                           "maybe_initialize_distributed (or torchrun) first")
    world = dist.get_world_size()
    inner, axis = (seq_parallel, SEQ_AXIS) if seq_parallel > 1 else (model_parallel, MODEL_AXIS)
    if data_parallel is None:
        data_parallel = world // inner
    if data_parallel * inner != world:
        raise ValueError(f"mesh {data_parallel}x{inner} != {world} processes")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(data_parallel, inner),
                      mesh_dim_names=(DATA_AXIS, axis))


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
