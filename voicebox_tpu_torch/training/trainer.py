"""The VoiceBox trainer: CFM loss, gradient accumulation, fp32 global-norm
clip, AdamW and the warmup -> cosine schedule, on latent datasets.

Counterpart of the core of `voicebox_tpu/training/trainer.py::VoiceBoxTrainer`
(defaults, `train_step`, `train`) on one device. A step takes
`batch_size * grad_accum_every` items, runs the loss and its backward per
micro-batch (on the card: K1 forward, K2 + K3 backward in every attention
layer), sums the gradients in the fp32 parameters' `.grad` and divides by
the count, clips, steps AdamW and then the schedule. Losses stay on the
device between log boundaries and are fetched together. Every
`save_results_every` steps a validation batch gives a loss, with the span
and CFG masks drawn from a generator seeded by the step.

Datasets hold latents (n, d) or (latents (n, d), frame-aligned ids (n,))
pairs (`training.data.ArrayDataset`); raw audio needs the SEANet encoder,
which is not ported yet. Parameters must be fp32: the denoiser computes in
its `dtype` (bf16 on the card) and casts each weight at use, as the JAX
trainer does. Not ported yet, though the constructor keeps their names:
checkpoints (`save_model_every`), experiment trackers, the device mesh, the
profiler window, bf16 moments, an EMA and bf16 live parameters
(`param_dtype`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models.cfm import ConditionalFlowMatcherWrapper, resolve_device
from .data import AlignedPairedDataLoader, DataLoader, random_split
from .optimizer import clip_by_global_norm_f32, get_optimizer, warmup_cosine_schedule

__all__ = ["VoiceBoxTrainer"]


class VoiceBoxTrainer:
    def __init__(
        self,
        cfm_wrapper: ConditionalFlowMatcherWrapper,
        *,
        batch_size: int,
        dataset,
        num_train_steps: Optional[int] = None,
        num_warmup_steps: Optional[int] = None,
        num_epochs: Optional[int] = None,
        lr: float = 3e-4,
        initial_lr: float = 1e-5,
        grad_accum_every: int = 1,
        wd: float = 0.0,
        max_grad_norm: Optional[float] = 0.5,
        valid_frac: float = 0.05,
        random_split_seed: int = 42,
        log_every: int = 10,
        save_results_every: int = 100,
        results_folder: Optional[str] = None,
        seed: int = 0,
        bucket_multiple: int = 256,
        max_length: Optional[int] = None,
        bucket_offset: Optional[int] = None,  # None: the register count
        drop_last: bool = False,
        device="cuda",
        save_model_every: Optional[int] = None,
        moment_dtype=None,
        param_dtype=None,
        ema_decay: Optional[float] = None,
        mesh=None,
        profile_dir: Optional[str] = None,
        trackers: tuple = (),
    ):
        unported = dict(save_model_every=save_model_every, moment_dtype=moment_dtype,
                        param_dtype=param_dtype, ema_decay=ema_decay, mesh=mesh,
                        profile_dir=profile_dir, trackers=trackers or None)
        given = sorted(k for k, v in unported.items() if v is not None)
        if given:
            raise NotImplementedError(
                f"{', '.join(given)}: not ported yet (ROADMAP Queue 1, item 7)"
            )
        self.device = resolve_device(device)
        self.cfm_wrapper = cfm_wrapper.to(self.device)
        self.batch_size = batch_size
        self.grad_accum_every = grad_accum_every
        self.max_grad_norm = max_grad_norm
        self.log_every = log_every
        self.save_results_every = save_results_every

        self.ds, self.valid_ds = dataset, dataset
        if valid_frac > 0:
            self.ds, self.valid_ds = random_split(dataset, valid_frac, random_split_seed)
        if min(len(self.ds), len(self.valid_ds)) < batch_size:
            raise ValueError(
                f"the training and validation splits ({len(self.ds)} and "
                f"{len(self.valid_ds)} items) must each hold a batch of {batch_size}"
            )
        if num_train_steps is None and num_epochs is None:
            raise ValueError("either num_train_steps or num_epochs must be specified")
        if num_epochs is not None:
            # one epoch is one pass over the training split
            num_train_steps = max(1, len(self.ds) // (batch_size * grad_accum_every)) * num_epochs
        self.num_train_steps = num_train_steps
        self.num_warmup_steps = num_warmup_steps or 0

        vb = cfm_wrapper.voicebox
        self.named_params = [(n, p) for n, p in vb.named_parameters() if p.requires_grad]
        wrong = [n for n, p in self.named_params if p.dtype != torch.float32]
        if wrong:
            raise ValueError(
                f"the trainer needs fp32 parameters (build VoiceBox with "
                f"param_dtype=torch.float32); got {wrong[:3]}..."
            )
        self.params = [p for _, p in self.named_params]
        self.optimizer = get_optimizer(self.named_params, lr=lr, wd=wd)
        self.scheduler = warmup_cosine_schedule(
            self.optimizer, lr, initial_lr, self.num_warmup_steps, self.num_train_steps
        )

        probe = dataset[0]
        self._paired = isinstance(probe, tuple) and len(probe) == 2
        if bucket_offset is None:
            bucket_offset = vb.transformer.num_register_tokens
        loader = AlignedPairedDataLoader if self._paired else DataLoader
        kw = dict(bucket_multiple=bucket_multiple, max_length=max_length, drop_last=drop_last,
                  bucket_offset=bucket_offset)
        self.dl_iter = loader(self.ds, batch_size * grad_accum_every, seed=seed, **kw).cycle()
        self.valid_dl_iter = loader(self.valid_ds, batch_size, seed=seed + 1, **kw).cycle()

        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.steps = 0
        self.metrics: list = []
        self._metrics_path = None
        if results_folder is not None:
            Path(results_folder).mkdir(parents=True, exist_ok=True)
            self._metrics_path = Path(results_folder) / "metrics.jsonl"
        self._loss_buffer: list = []

    # ------------------------------------------------------------------

    def print(self, msg):
        print(msg, flush=True)

    def _log_metrics(self, record: dict, step: Optional[int] = None):
        record = dict(record, step=self.steps if step is None else step)
        self.metrics.append(record)
        if self._metrics_path is not None:
            with open(self._metrics_path, "a") as f:
                f.write(json.dumps(record) + "\n")

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

    def _next_batch(self, iterator):
        """(latents, mask, ids or None) as tensors on the device."""
        item = next(iterator)
        if self._paired:
            (x, mask), (ids, _) = item
        else:
            (x, mask), ids = item, None
        x = torch.from_numpy(np.asarray(x, np.float32)).to(self.device)
        mask = torch.from_numpy(mask).to(self.device)
        if ids is not None:
            ids = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
        return x, mask, ids

    def _loss(self, x, mask, ids, **randomness):
        return self.cfm_wrapper.loss_fn(x, mask=mask, cond_token_ids=ids, **randomness)

    def train_step(self, **draws):
        """One optimizer step. `draws` (`noise`, `times`, `cond_mask`,
        `cond_drop_mask`, each for the whole step's batch) replace the
        generator's draws, to replay a run. Returns {"loss", "grad_norm"} as
        tensors on the device."""
        steps = self.steps
        x, mask, ids = self._next_batch(self.dl_iter)
        self.cfm_wrapper.train()
        accum = self.grad_accum_every
        micro = x.shape[0] // accum
        loss_sum = torch.zeros((), device=self.device)
        for i in range(accum):
            sl = slice(i * micro, (i + 1) * micro)
            loss = self._loss(x[sl], mask[sl], None if ids is None else ids[sl],
                              generator=self.generator, **{k: v[sl] for k, v in draws.items()})
            loss.backward()
            loss_sum += loss.detach()
        for p in self.params:  # an unused parameter still decays, as under optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if accum > 1:  # the fp32 .grad buffers are the accumulator
            torch._foreach_div_(grads, accum)
        grad_norm = None
        if self.max_grad_norm is not None:
            grad_norm = clip_by_global_norm_f32(grads, self.max_grad_norm)
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        loss = loss_sum / accum

        self._loss_buffer.append((steps, loss))
        if steps % self.log_every == 0:
            self.print(f"{steps}: loss: {self._flush_losses():0.3f}")
        if steps % self.save_results_every == 0:
            x, mask, ids = self._next_batch(self.valid_dl_iter)
            gen = torch.Generator(device=self.device).manual_seed(steps)
            with torch.no_grad():
                valid_loss = float(self._loss(x, mask, ids, generator=gen))
            self.print(f"{steps}: valid loss {valid_loss:0.3f}")
            self._log_metrics({"valid_loss": valid_loss})
        self.steps += 1
        return {"loss": loss, "grad_norm": grad_norm}

    def train(self):
        try:
            while self.steps < self.num_train_steps:
                self.train_step()
        finally:
            self._flush_losses()
        self.print("training complete")
