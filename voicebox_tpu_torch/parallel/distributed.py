"""Multi-process bootstrap.

Counterpart of `voicebox_tpu/parallel/distributed.py`. The reference gets
its launch topology from `accelerate launch` (reference trainer.py:89-95);
here it is torchrun's environment (`MASTER_ADDR`, `MASTER_PORT`, `RANK`,
`WORLD_SIZE`, `LOCAL_RANK`) or explicit arguments, which
`maybe_initialize_distributed` turns into a `torch.distributed` process
group. Without either it does nothing, and everything runs in one process.

Under a process group an entry point's `"cuda"` is this process's card,
`cuda:{LOCAL_RANK}` (the global rank when `LOCAL_RANK` is unset), and it
raises when that card does not exist: a device is never remapped quietly.
Ranks that share one card pass `device="cuda:0"` themselves.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["is_multihost", "local_cuda_device", "maybe_initialize_distributed",
           "process_index"]


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def maybe_initialize_distributed(init_method: Optional[str] = None,
                                 world_size: Optional[int] = None,
                                 rank: Optional[int] = None,
                                 backend: Optional[str] = None) -> bool:
    """Join a process group if the arguments or torchrun's environment ask
    for one: `init_method` (`"tcp://host:port"`, `"file:///path"`) with
    `world_size` and `rank`, else `MASTER_ADDR` / `RANK` / `WORLD_SIZE`.
    `backend` defaults to NCCL with a card and gloo without. Safe to call
    more than once and in a single process (a no-op). Returns True when
    more than one process takes part."""
    if _initialized():
        return dist.get_world_size() > 1
    from_env = all(k in os.environ for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))
    if init_method is None and not from_env:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if init_method is None:
        dist.init_process_group(backend)
    else:
        if world_size is None or rank is None:
            raise ValueError("an explicit init_method needs world_size and rank")
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)
    return dist.get_world_size() > 1


def is_multihost() -> bool:
    """More than one process in the group."""
    return _initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def local_cuda_device() -> torch.device:
    """This process's card under a process group: `cuda:{LOCAL_RANK}`, or
    the global rank without `LOCAL_RANK`. Raises if the card is missing."""
    index = int(os.environ.get("LOCAL_RANK", process_index()))
    count = torch.cuda.device_count()
    if index >= count:
        raise RuntimeError(
            f"this process's card is cuda:{index} (LOCAL_RANK or the rank) but the machine has "
            f"{count}; ranks that share a card pass device='cuda:0' themselves")
    return torch.device("cuda", index)
