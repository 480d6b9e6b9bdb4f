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
here; "orbax" (sharded, multi-host) waits for ROADMAP item 15.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ..utils.convert import (export_optimizer_state, optimizer_state_by_name,
                             save_reference_checkpoint)
from .optimizer import ParamsEMA, adam_state, restore_adam_state

__all__ = ["check_backend", "load_trainer_checkpoint", "save_trainer_checkpoint"]

def check_backend(backend: str) -> None:
    if backend == "orbax":
        raise NotImplementedError(
            "checkpoint_backend='orbax' (sharded, multi-host checkpoints) is not ported yet "
            "(ROADMAP Queue 1, item 15); 'msgpack' writes the reference's .pt layout")
    if backend != "msgpack":
        raise ValueError(f"unknown checkpoint backend {backend!r}")


def save_trainer_checkpoint(
    path, *, module: torch.nn.Module, named_params: Sequence[Tuple[str, torch.Tensor]],
    optimizer: torch.optim.Optimizer, steps: int, lr: float, wd: float,
    betas=(0.9, 0.99), eps: float = 1e-8, ema: Optional[ParamsEMA] = None,
    prefix: str, extra_model_state: Optional[dict] = None,
) -> dict:
    """`module`'s state dict under `prefix` (the denoiser's `voicebox.`; the
    duration trainer's `duration_predictor.`), `named_params` named as in
    it."""
    model = {prefix + k: v.detach().to("cpu", torch.float32, copy=True)
             for k, v in module.state_dict().items()}
    names = [prefix + n for n, _ in named_params]
    mus, nus, count = adam_state(optimizer, [p for _, p in named_params])
    mu_sd = {n: m for n, m in zip(names, mus) if m is not None}
    nu_sd = {n: v for n, v in zip(names, nus) if v is not None}
    optim = export_optimizer_state(model, mu_sd, nu_sd, count, lr=lr, wd=wd, betas=betas,
                                   eps=eps)
    extra = {"steps": int(steps)}
    if ema is not None:
        extra["ema"] = {n: e.detach().to("cpu", copy=True) for n, e in zip(names, ema.shadow)}
    model.update(extra_model_state or {})
    return save_reference_checkpoint(path, model, optim, **extra)


def load_trainer_checkpoint(
    path, *, module: torch.nn.Module, named_params: Sequence[Tuple[str, torch.Tensor]],
    optimizer: torch.optim.Optimizer, prefix: str, ema: Optional[ParamsEMA] = None,
    module_state: Optional[Callable[[dict], dict]] = None,
) -> int:
    """Restore the weights, the moments, the step and the EMA; returns the
    number of steps taken. `module_state` picks `module`'s state dict out of
    the checkpoint's `model` dict; by default it is the entries under
    `prefix`, the prefix stripped. Moments and EMA are looked up under
    `prefix` + the parameter's name."""
    pkg = torch.load(path, map_location="cpu", weights_only=False)
    if module_state is None:
        state = {k[len(prefix):]: v for k, v in pkg["model"].items() if k.startswith(prefix)}
    else:
        state = module_state(pkg["model"])
    with torch.no_grad():
        module.load_state_dict(state, strict=True)
    mu, nu, count = optimizer_state_by_name(pkg)
    names = [prefix + n for n, _ in named_params]
    restore_adam_state(optimizer, [p for _, p in named_params], [mu.get(n) for n in names],
                       [nu.get(n) for n in names], count)
    if ema is not None:
        if "ema" in pkg:
            with torch.no_grad():
                for e, n in zip(ema.shadow, names):
                    e.copy_(pkg["ema"][n])
        else:
            ema.reset()
    return int(pkg.get("steps", count))
