"""A serialisable record of a training run's hyperparameters.

Counterpart of `voicebox_tpu/training/config.py`: `TrainConfig` holds what
`VoiceBoxTrainer` takes (dtypes as strings, so the record stays JSON) and
`build(cfm_wrapper, dataset, **overrides)` makes the trainer.

    cfg = TrainConfig(batch_size=8, num_train_steps=1000, moment_dtype="bfloat16")
    trainer = cfg.build(cfm, dataset)
    json.dumps(cfg.to_dict())

`MeshConfig(data_parallel=, model_parallel=)` builds the ("data", "model")
DeviceMesh over the process group (`parallel.mesh.make_mesh`); sequence
parallelism builds its ("data", "seq") mesh from `seq_parallel`.
`TrainConfig` also records `use_mesh`, `param_sharding`, `seq_parallel`
and `min_fsdp_size`, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

__all__ = ["MeshConfig", "TrainConfig"]


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape; data_parallel=None = all remaining devices."""

    data_parallel: Optional[int] = None
    model_parallel: int = 1

    def build(self):
        from ..parallel.mesh import make_mesh

        return make_mesh(self.data_parallel, self.model_parallel)


@dataclass(frozen=True)
class TrainConfig:
    """Everything `VoiceBoxTrainer` takes, as a serialisable record."""

    batch_size: int = 32
    num_train_steps: Optional[int] = None
    num_warmup_steps: Optional[int] = None
    num_epochs: Optional[int] = None
    lr: float = 3e-4
    initial_lr: float = 1e-5
    grad_accum_every: int = 1
    wd: float = 0.0
    max_grad_norm: Optional[float] = 0.5
    valid_frac: float = 0.05
    random_split_seed: int = 42
    log_every: int = 10
    save_results_every: int = 100
    save_model_every: Optional[int] = None
    results_folder: Optional[str] = None
    # "bfloat16": Adam moments, bf16 live parameters over an fp32 master,
    # the EMA's storage (torch dtype names, so the record stays JSON)
    moment_dtype: Optional[str] = None
    param_dtype: Optional[str] = None
    ema_decay: Optional[float] = None
    ema_dtype: Optional[str] = None
    seed: int = 0
    bucket_multiple: int = 256
    max_length: Optional[int] = None
    bucket_offset: Optional[int] = None
    prefetch_batches: int = 2
    checkpoint_backend: str = "msgpack"
    use_mesh: bool = True
    param_sharding: str = "replicated"
    seq_parallel: int = 1
    min_fsdp_size: int = 2 ** 16
    mesh: Optional[MeshConfig] = field(default=None)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        d = dict(d)
        if isinstance(d.get("mesh"), dict):
            d["mesh"] = MeshConfig(**d["mesh"])
        return cls(**d)

    def build(self, cfm_wrapper, dataset, **overrides):
        """Construct the trainer; kwargs here override config fields."""
        from .trainer import VoiceBoxTrainer

        kwargs = self.to_dict()
        mesh_cfg = kwargs.pop("mesh")
        kwargs.update(overrides)
        for key in ("moment_dtype", "ema_dtype", "param_dtype"):
            if isinstance(kwargs.get(key), str):
                kwargs[key] = getattr(torch, kwargs[key])
        if mesh_cfg is not None and "mesh" not in overrides:
            kwargs["mesh"] = MeshConfig(**mesh_cfg).build()
        return VoiceBoxTrainer(cfm_wrapper, dataset=dataset, **kwargs)
