"""Trainer checkpoints in the reference trainer's layout.

Counterpart of `voicebox_tpu/training/checkpoint.py::MsgpackCheckpointer`
(one file of {model, optim, steps}) and of the checkpoint halves of
`VoiceBoxTrainer.save_torch` / `load_torch`. The port's own format is the
reference's `.pt`, `torch.save({'model', 'optim', 'scheduler'})` (reference
trainer.py:191-197), so one file resumes on the reference build, on the JAX
package (`VoiceBoxTrainer.load_torch`) and here:

* `model`: the denoiser's state dict under `voicebox.`, fp32 (the trainer's
  fp32 master weights when it trains bf16 live parameters), or the duration
  predictor's (its net and aligner) under `duration_predictor.`;
* `optim`: a torch `AdamW.state_dict()` in the reference's index layout
  (`utils/convert.py::export_optimizer_state`); moments kept in bf16 are
  written widened to fp32, which loses nothing;
* `scheduler`: empty (the learning rate follows the step count);
* `steps`: the number of optimizer steps taken, and, with an EMA, `ema`:
  its tensors by model key in their own dtype. The reference ignores both.

A checkpoint without `steps` (the reference's, the JAX package's) resumes at
the optimizer's step count; one without `ema` restarts the EMA at the loaded
weights. The JAX package's default backend, "msgpack", names this format
here. Under data parallelism rank 0 writes it, the moments and the EMA of
an FSDP run gathered whole first, and every rank reads it.

"orbax", the JAX package's sharded multi-host backend
(`voicebox_tpu/training/checkpoint.py::OrbaxCheckpointer`), is
`ShardedCheckpointer` here: `torch.distributed.checkpoint` writes the
trainer's state under `results_folder/orbax/<steps>` (the number of
optimizer steps it holds), each rank its own shards (an FSDP shard as a
`DTensor` over the "data" axis; a tensor every rank holds is written
once), and keeps the newest `max_to_keep` (5) step directories.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..utils.convert import (export_optimizer_state, optimizer_state_by_name,
                             save_reference_checkpoint)
from .optimizer import ParamsEMA, adam_state, restore_adam_state

__all__ = ["BACKENDS", "ShardedCheckpointer", "check_backend", "load_trainer_checkpoint",
           "save_trainer_checkpoint"]

BACKENDS = ("msgpack", "orbax")


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r} (use one of {BACKENDS})")


def _is_first_rank() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class ShardedCheckpointer:
    """Step directories of `torch.distributed.checkpoint` under `directory`,
    the newest `max_to_keep` kept. Every rank of the process group calls
    `save` and `load` with its own state dict (tensors, `DTensor` shards);
    without a process group it runs in one process."""

    def __init__(self, directory, max_to_keep: Optional[int] = 5):
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep

    def steps(self) -> List[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, steps: int, state: dict) -> Path:
        import torch.distributed.checkpoint as dcp

        path = self.directory / str(int(steps))
        dcp.save(state, checkpoint_id=str(path))
        if self.max_to_keep is not None and _is_first_rank():
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(self.directory / str(old), ignore_errors=True)
        return path

    def resolve(self, step_or_path: Union[int, str, Path, None]) -> Path:
        """An int step, a step directory (its name is the step) or
        None / "latest" -> the directory to read."""
        if step_or_path is None or str(step_or_path) == "latest":
            step_or_path = self.latest_step()
            if step_or_path is None:
                raise FileNotFoundError(f"no checkpoint under {self.directory}")
        if isinstance(step_or_path, int):
            return self.directory / str(step_or_path)
        path = Path(step_or_path)
        if not path.name.isdigit():
            raise ValueError(f"{path} is no step directory (its name must be the step)")
        return path

    def load(self, step_or_path, state: dict) -> Path:
        """Read into `state`'s tensors in place; returns the directory."""
        import torch.distributed.checkpoint as dcp

        path = self.resolve(step_or_path)
        dcp.load(state, checkpoint_id=str(path))
        return path


def save_trainer_checkpoint(
    path, *, module: torch.nn.Module, named_params: Sequence[Tuple[str, torch.Tensor]],
    optimizer: torch.optim.Optimizer, steps: int, lr: float, wd: float,
    betas=(0.9, 0.99), eps: float = 1e-8, ema: Optional[ParamsEMA] = None,
    prefix: str, extra_model_state: Optional[dict] = None,
    moments: Optional[tuple] = None, ema_tensors: Optional[Sequence[torch.Tensor]] = None,
    state_dict: Optional[dict] = None,
) -> dict:
    """`module`'s state dict (or `state_dict`: a tensor-parallel run's,
    gathered whole) under `prefix` (the denoiser's `voicebox.`; the
    duration trainer's `duration_predictor.`), `named_params` named as in
    it. `moments` ((exp_avg list, exp_avg_sq list, count)) and
    `ema_tensors` replace the optimizer's and the EMA's own, per parameter
    (an FSDP or tensor-parallel run's, gathered whole)."""
    state_dict = module.state_dict() if state_dict is None else state_dict
    model = {prefix + k: v.detach().to("cpu", torch.float32, copy=True)
             for k, v in state_dict.items()}
    names = [prefix + n for n, _ in named_params]
    mus, nus, count = moments or adam_state(optimizer, [p for _, p in named_params])
    mu_sd = {n: m for n, m in zip(names, mus) if m is not None}
    nu_sd = {n: v for n, v in zip(names, nus) if v is not None}
    optim = export_optimizer_state(model, mu_sd, nu_sd, count, lr=lr, wd=wd, betas=betas,
                                   eps=eps)
    extra = {"steps": int(steps)}
    if ema_tensors is None and ema is not None:
        ema_tensors = ema.shadow
    if ema_tensors is not None:
        extra["ema"] = {n: e.detach().to("cpu", copy=True) for n, e in zip(names, ema_tensors)}
    model.update(extra_model_state or {})
    return save_reference_checkpoint(path, model, optim, **extra)


def load_trainer_checkpoint(
    path, *, module: torch.nn.Module, named_params: Sequence[Tuple[str, torch.Tensor]],
    optimizer: torch.optim.Optimizer, prefix: str, ema: Optional[ParamsEMA] = None,
    module_state: Optional[Callable[[dict], dict]] = None,
    opt_params: Optional[Sequence[torch.Tensor]] = None,
    shard: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None,
    localize: Optional[Callable[[dict], dict]] = None,
) -> int:
    """Restore the weights, the moments, the step and the EMA; returns the
    number of steps taken. `module_state` picks `module`'s state dict out of
    the checkpoint's `model` dict; by default it is the entries under
    `prefix`, the prefix stripped. Moments and EMA are looked up under
    `prefix` + the parameter's name, and go to `opt_params` (the tensors the
    optimizer steps; by default the parameters) through `shard(i, whole)`
    (this rank's piece of parameter i's; by default the whole). `localize`
    turns the whole state dict into the module's (a tensor-parallel
    rank's pieces)."""
    pkg = torch.load(path, map_location="cpu", weights_only=False)
    if module_state is None:
        state = {k[len(prefix):]: v for k, v in pkg["model"].items() if k.startswith(prefix)}
    else:
        state = module_state(pkg["model"])
    if localize is not None:
        state = localize(state)
    with torch.no_grad():
        module.load_state_dict(state, strict=True)
    mu, nu, count = optimizer_state_by_name(pkg)
    names = [prefix + n for n, _ in named_params]
    params = list(opt_params) if opt_params is not None else [p for _, p in named_params]
    piece = shard or (lambda i, t: t)
    restore_adam_state(optimizer, params, [piece(i, mu.get(n)) for i, n in enumerate(names)],
                       [piece(i, nu.get(n)) for i, n in enumerate(names)], count)
    if ema is not None:
        if "ema" in pkg:
            with torch.no_grad():
                for i, (e, n) in enumerate(zip(ema.shadow, names)):
                    e.copy_(piece(i, pkg["ema"][n]))
        else:
            ema.reset()
    return int(pkg.get("steps", count))
