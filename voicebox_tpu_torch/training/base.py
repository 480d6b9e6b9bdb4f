"""The trainers' shared core on one device: optimizer and schedule,
accumulation and the fp32 clip, the EMA, metrics and trackers, checkpoints,
the validation loop.

Counterpart of `voicebox_tpu/training/base.py`, limited to what the stage
trainers need on one device:

* `TrainerBase`: steps from epochs (one epoch is one pass over the
  training split, each step taking `batch_size * grad_accum_every` items),
  AdamW (Adam at wd 0; bf16 moments with `moment_dtype`) under the warmup
  -> cosine schedule of `training/optimizer.py`, the optional EMA,
  `metrics.jsonl` and tracker fan-out as the JAX trainers write them,
  buffered device losses fetched together at log boundaries, `save` /
  `load` in the reference trainer's `.pt` layout (`training/checkpoint.py`,
  the module's state under `state_prefix`);
* `StageTrainer`: the loop of one-model stage trainers: per-field bucketed
  paired loaders with a validation split and prefetching, a step that
  accumulates gradients over micro-batches, clips them in fp32, steps the
  optimizer, the schedule and the EMA, a validation loss every
  `save_results_every` steps (its draws from a generator seeded by the
  step) and a checkpoint every `save_model_every` steps. Subclasses give
  `_prepare_batch(fields)` (loader fields -> tensors on the device) and
  `_loss(batch, generator, **draws)`.

The device mesh, multi-host loaders and sharded checkpoints raise
NotImplementedError (ROADMAP Queue 1, item 15). The port's
`VoiceBoxTrainer` keeps its own set-up and step on this class's logging,
EMA view and checkpoints. Metrics and checkpoints are written only when a
`results_folder` is given, and a checkpoint's `steps` counts the optimizer
steps it holds.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models.cfm import resolve_device
from .checkpoint import check_backend, load_trainer_checkpoint, save_trainer_checkpoint
from .data import PairedDataLoader, PrefetchLoader, TokenizedTextDataset, random_split
from .optimizer import ParamsEMA, clip_by_global_norm_f32, get_optimizer, warmup_cosine_schedule

__all__ = ["StageTrainer", "TrainerBase"]

_MESH = ("mesh: multi-device layouts and multi-host loaders are not ported yet "
         "(ROADMAP Queue 1, item 15)")


class TrainerBase:
    project_name = "voicebox"
    state_prefix = "model."

    @staticmethod
    def _steps_from_epochs(num_epochs: int, dataset_len: int, batch_size: int,
                           grad_accum_every: int, valid_frac: float) -> int:
        n_train = int((1 - valid_frac) * dataset_len) if valid_frac > 0 else dataset_len
        return max(1, n_train // (batch_size * grad_accum_every)) * num_epochs

    def _setup_core(self, *, module: torch.nn.Module, num_train_steps: int,
                    num_warmup_steps: Optional[int], lr: float, initial_lr: float, wd: float,
                    max_grad_norm: Optional[float], moment_dtype, ema_decay: Optional[float],
                    ema_dtype, log_every: int, save_results_every: int,
                    save_model_every: Optional[int], results_folder,
                    force_clear_prev_results: bool, checkpoint_backend: str, trackers: tuple,
                    seed: int, device):
        check_backend(checkpoint_backend)
        if save_model_every is not None and results_folder is None:
            raise ValueError("save_model_every needs a results_folder to write to")
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.steps = 0
        self.num_train_steps = num_train_steps
        self.num_warmup_steps = num_warmup_steps or 0
        self.lr, self.initial_lr, self.wd = lr, initial_lr, wd
        self.max_grad_norm = max_grad_norm
        self.named_params = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
        self.params = [p for _, p in self.named_params]
        self.optimizer = get_optimizer(self.named_params, lr=lr, wd=wd, moment_dtype=moment_dtype)
        self.scheduler = warmup_cosine_schedule(self.optimizer, lr, initial_lr,
                                                self.num_warmup_steps, num_train_steps)
        self.ema = None if ema_decay is None else ParamsEMA(self.params, ema_decay, ema_dtype)
        self.log_every = log_every
        self.save_results_every = save_results_every
        self.save_model_every = save_model_every
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.metrics: list = []
        self._metrics_path = self.results_folder = None
        if results_folder is not None:
            self.results_folder = Path(results_folder)
            if force_clear_prev_results and self.results_folder.exists():
                shutil.rmtree(self.results_folder)
            self.results_folder.mkdir(parents=True, exist_ok=True)
            self._metrics_path = self.results_folder / "metrics.jsonl"
        self._trackers = tuple(trackers)
        self._loss_buffer: list = []

    # ------------------------------------------------------------------
    # logging

    def print(self, msg):
        print(msg, flush=True)

    def _log_metrics(self, record: dict, step: Optional[int] = None):
        step = self.steps if step is None else step
        record = dict(record, step=step, time=time.time())
        self.metrics.append(record)
        if self._metrics_path is not None:
            with open(self._metrics_path, "a") as f:
                f.write(json.dumps(record, default=float) + "\n")
        for tracker in self._trackers:
            if callable(tracker) and not hasattr(tracker, "log"):
                tracker(record, step)
            elif record.get("event") == "init_trackers":
                if hasattr(tracker, "init_trackers"):
                    tracker.init_trackers(self.project_name, record["config"])
            elif hasattr(tracker, "log"):
                tracker.log({k: v for k, v in record.items() if k not in ("step", "time")},
                            step=step)

    def _flush_losses(self) -> Optional[float]:
        """Fetch the buffered losses in one transfer and log them; returns the
        last one."""
        if not self._loss_buffer:
            return None
        steps, losses = zip(*self._loss_buffer)
        values = torch.stack(losses).cpu().tolist()
        for s, v in zip(steps, values):
            self._log_metrics({"train_loss": v}, step=s)
        self._loss_buffer.clear()
        return values[-1]

    def _log_init_hps(self):
        self.hps = {"num_train_steps": self.num_train_steps,
                    "num_warmup_steps": self.num_warmup_steps, "learning_rate": self.lr,
                    "initial_learning_rate": self.initial_lr, "wd": self.wd}
        self._log_metrics({"event": "init_trackers", "config": self.hps})

    # ------------------------------------------------------------------
    # checkpoints

    def save(self, path, extra_model_state: Optional[dict] = None) -> dict:
        """Write the run (fp32 weights, moments, step, EMA) in the reference
        trainer's layout; returns the checkpoint."""
        self._flush_losses()
        return save_trainer_checkpoint(
            path, module=self.module, named_params=self.named_params, optimizer=self.optimizer,
            steps=self.steps, lr=self.lr, wd=self.wd, ema=self.ema,
            extra_model_state=extra_model_state, prefix=self.state_prefix)

    def _module_state(self, model: dict) -> dict:
        """The module's state dict out of a checkpoint's `model` dict."""
        n = len(self.state_prefix)
        return {k[n:]: v for k, v in model.items() if k.startswith(self.state_prefix)}

    def load(self, path) -> None:
        """Resume from a checkpoint written by `save`: weights, moments, step
        count (and so the learning rate), EMA."""
        self.steps = load_trainer_checkpoint(
            path, module=self.module, named_params=self.named_params, optimizer=self.optimizer,
            ema=self.ema, prefix=self.state_prefix, module_state=self._module_state)
        sched = self.scheduler  # at the loaded step, as if it had stepped there
        sched.last_epoch = self.steps
        for group, base, factor in zip(self.optimizer.param_groups, sched.base_lrs,
                                       sched.lr_lambdas):
            group["lr"] = base * factor(self.steps)
        sched._last_lr = [g["lr"] for g in self.optimizer.param_groups]

    @property
    def ema_params(self) -> Optional[dict]:
        """{name: EMA tensor} (None without `ema_decay`)."""
        if self.ema is None:
            return None
        return {n: e for (n, _), e in zip(self.named_params, self.ema.shadow)}

    # ------------------------------------------------------------------
    # the loop

    def train_step(self, **draws):  # pragma: no cover - abstract
        raise NotImplementedError

    def train(self):
        try:
            while self.steps < self.num_train_steps:
                self.train_step()
        finally:
            self._flush_losses()
        self.print("training complete")
        for tracker in self._trackers:
            if hasattr(tracker, "finish"):
                tracker.finish()


class StageTrainer(TrainerBase):
    ckpt_prefix = "model"

    def _setup_paired_loaders(self, dataset, tokenizer, *, batch_size: int,
                              grad_accum_every: int, valid_frac: float,
                              random_split_seed: int, seed: int, bucket_multiples, pad_values,
                              max_lengths, prefetch_batches: int):
        """Tokenized view, validation split, per-field bucketed loaders and
        prefetching (into pinned memory on the card)."""
        self.batch_size, self.grad_accum_every = batch_size, grad_accum_every
        self.ds = TokenizedTextDataset(dataset, tokenizer)
        self.valid_ds = self.ds
        if valid_frac > 0:
            self.ds, self.valid_ds = random_split(self.ds, valid_frac, random_split_seed)
        if min(len(self.ds), len(self.valid_ds)) < batch_size:
            raise ValueError(
                f"the training and validation splits ({len(self.ds)} and "
                f"{len(self.valid_ds)} items) must each hold a batch of {batch_size}"
            )
        kw = dict(bucket_multiples=tuple(bucket_multiples), pad_values=tuple(pad_values),
                  max_lengths=tuple(max_lengths))
        dl = PairedDataLoader(self.ds, batch_size * grad_accum_every, seed=seed, **kw)
        valid_dl = PairedDataLoader(self.valid_ds, batch_size, seed=seed + 1, **kw)
        if prefetch_batches > 0:
            pin = self._pinned if self.device.type == "cuda" else None
            self.dl_iter = PrefetchLoader(dl, prefetch_batches, pin).cycle()
            self.valid_dl_iter = PrefetchLoader(valid_dl, 1, pin).cycle()
        else:
            self.dl_iter, self.valid_dl_iter = dl.cycle(), valid_dl.cycle()

    @staticmethod
    def _pinned(fields):
        return tuple(tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in f)
                     for f in fields)

    def _put(self, a, dtype=None) -> torch.Tensor:
        if not torch.is_tensor(a):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device, dtype, non_blocking=True)

    def _prepare_batch(self, fields) -> dict:  # pragma: no cover - abstract
        raise NotImplementedError

    def _loss(self, batch: dict, generator, **draws) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def _gradients(self, batch: dict, draws: dict):
        """(mean loss, gradients): the loss and its backward per micro-batch,
        the gradients summed in the parameters' `.grad` and averaged."""
        accum = self.grad_accum_every
        micro = next(iter(batch.values())).shape[0] // accum
        loss_sum = torch.zeros((), device=self.device)
        for i in range(accum):
            sl = slice(i * micro, (i + 1) * micro)
            loss = self._loss({k: v[sl] for k, v in batch.items()}, self.generator,
                              **{k: v[sl] for k, v in draws.items()})
            loss.backward()
            loss_sum += loss.detach()
        for p in self.params:  # an unused parameter still decays, as under optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if accum > 1:
            torch._foreach_div_(grads, accum)
        return loss_sum / accum, grads

    def train_step(self, **draws):
        """One optimizer step. `draws` (the loss's injectable draws, each for
        the whole step's batch) replace the generator's, to replay a run.
        Returns {"loss", "grad_norm"} as tensors on the device."""
        steps = self.steps
        batch = self._prepare_batch(next(self.dl_iter))
        self.module.train()
        loss, grads = self._gradients(batch, draws)
        grad_norm = None
        if self.max_grad_norm is not None:
            grad_norm = clip_by_global_norm_f32(grads, self.max_grad_norm)
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.ema is not None:
            self.ema.update()

        self._loss_buffer.append((steps, loss))
        if steps % self.log_every == 0:
            self.print(f"{steps}: loss: {self._flush_losses():0.3f}")
        if steps % self.save_results_every == 0:
            batch = self._prepare_batch(next(self.valid_dl_iter))
            gen = torch.Generator(device=self.device).manual_seed(steps)
            with torch.no_grad():
                valid_loss = float(self._loss(batch, gen))
            self.print(f"{steps}: valid loss {valid_loss:0.3f}")
            self._log_metrics({"valid_loss": valid_loss})
        self.steps += 1
        if self.save_model_every is not None and steps % self.save_model_every == 0:
            path = self.results_folder / f"{self.ckpt_prefix}.{steps}.pt"
            self.save(path)
            self.print(f"{steps}: saving model to {path}")
        return {"loss": loss, "grad_norm": grad_norm}
