"""The trainers' shared core: optimizer and schedule, accumulation and the
fp32 clip, the EMA, metrics and trackers, checkpoints, the validation loop,
and data parallelism over processes.

Counterpart of `voicebox_tpu/training/base.py`:

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
  `_prepare_batch(fields)` (loader fields -> tensors on the device),
  `_loss(batch, generator, **draws)` and, for a loss that is a mean over
  tokens rather than rows, `_loss_weight(batch)` (its token count).

Data parallelism (`_setup_parallel`, the counterpart of JAX's
`_setup_data_mesh` and `_put_batch`): under a process group of more than
one process a ("data", "model") mesh is built by default (`use_mesh`, as
JAX builds one over more than one device), or passed as `mesh`.
`batch_size` is the global batch (`split_batches=False`, the reference's
per-process batch, raises). Every rank runs the same seeded loader and
keeps its rank-block of each micro-batch's rows; it draws the loss's
random numbers at the global micro-batch's shape and keeps its rows
(`ops/masks.py::batch_rows`), so the run equals the single-process one on
the same global batch. A token-mean loss is weighted by each rank's share
of the all-reduced count. The gradients and the loss are reduced once a
step (`parallel/data_parallel.py`; "replicated", "fsdp", and for
`VoiceBoxTrainer` "tp" and "fsdp+tp" over a "model" axis, and sequence
parallelism over a "seq" axis: `seq_parallel`). Only rank 0
prints, logs, writes metrics and writes "msgpack" checkpoints; every rank
runs the validation loss on its rows and takes the mean over ranks. The
port's `VoiceBoxTrainer` keeps its own set-up and step on this class's
logging, EMA view, reduction and checkpoints. Metrics and checkpoints are
written only when a `results_folder` is given, and a checkpoint's `steps`
counts the optimizer steps it holds.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.cfm import resolve_device
from ..parallel.data_parallel import DataParallel, check_mode
from ..parallel.distributed import is_multihost
from ..parallel.mesh import SEQ_AXIS, make_mesh
from ..parallel.sequence_parallel import shard_draws
from .checkpoint import (ShardedCheckpointer, check_backend, load_trainer_checkpoint,
                         save_trainer_checkpoint)
from .data import PairedDataLoader, PrefetchLoader, TokenizedTextDataset, random_split
from .optimizer import (AdamLowPrecisionMoments, ParamsEMA, adam_state, clip_by_global_norm_f32,
                        get_optimizer, restore_adam_state, warmup_cosine_schedule)

__all__ = ["StageTrainer", "TrainerBase"]


class TrainerBase:
    project_name = "voicebox"
    state_prefix = "model."

    @staticmethod
    def _steps_from_epochs(num_epochs: int, dataset_len: int, batch_size: int,
                           grad_accum_every: int, valid_frac: float) -> int:
        n_train = int((1 - valid_frac) * dataset_len) if valid_frac > 0 else dataset_len
        return max(1, n_train // (batch_size * grad_accum_every)) * num_epochs

    def _setup_parallel(self, *, mesh, use_mesh: bool, split_batches: Optional[bool],
                        batch_size: int, param_sharding: str = "replicated",
                        min_fsdp_size: int = 2 ** 16, seq_parallel: int = 1) -> None:
        """The mesh and the parameters' layout over it (module doc). Needs
        `self.module`, `self.named_params` and `self.device`; sets the
        tensors the optimizer steps, `self.opt_params` (and, under a "model"
        axis, `self.named_params` / `self.params` to this rank's pieces)."""
        check_mode(param_sharding)
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError("mesh must be a DeviceMesh (parallel.mesh.make_mesh), got "
                            f"{type(mesh).__name__}")
        multi = is_multihost()
        if split_batches is False and multi:
            raise ValueError(
                "split_batches=False: the reference's per-process batch_size is not this "
                "trainer's; batch_size is the global batch, split over the processes")
        self.seq_parallel = int(seq_parallel)
        mesh_seq = mesh is not None and SEQ_AXIS in (mesh.mesh_dim_names or ())
        if (self.seq_parallel > 1 or mesh_seq) and param_sharding != "replicated":
            raise ValueError("sequence parallelism keeps the parameters replicated "
                             f"(param_sharding='replicated'), got {param_sharding!r}")
        if mesh_seq:
            if self.seq_parallel not in (1, mesh[SEQ_AXIS].size()):
                raise ValueError(f"seq_parallel={seq_parallel} against the mesh's "
                                 f"{mesh[SEQ_AXIS].size()} 'seq' ranks")
            self.seq_parallel = mesh[SEQ_AXIS].size()
        elif self.seq_parallel > 1:
            # a ("data", "seq") mesh: the batch over "data", the time axis over "seq"
            if mesh is not None or not use_mesh:
                raise ValueError("seq_parallel > 1 builds its own mesh (or pass one with a "
                                 "'seq' axis, make_mesh(seq_parallel=)) and needs use_mesh")
            mesh = make_mesh(seq_parallel=self.seq_parallel, device_type=self.device.type)
        if mesh is None and use_mesh and multi:
            mesh = make_mesh(device_type=self.device.type)
        elif mesh is None and multi:
            warnings.warn("a multi-process run without a mesh: every process trains its own "
                          "replica with no gradient reduction", stacklevel=3)
        self.mesh = mesh
        self.data_parallel = None
        self.rank, self.world = 0, 1
        # the one process that prints, logs and writes (ranks of other axes share a data rank)
        self.is_first = not multi or torch.distributed.get_rank() == 0
        self.opt_params = self.params
        self.seq_group = mesh.get_group(SEQ_AXIS) if self.seq_parallel > 1 else None
        if mesh is not None:
            dp = self.data_parallel = DataParallel(mesh, self.module, self.named_params,
                                                   param_sharding, min_fsdp_size)
            self.named_params, self.params = dp.named_params, dp.params
            self.rank, self.world = dp.rank, dp.world
            if batch_size % self.world:
                raise ValueError(f"batch_size {batch_size} does not split over {self.world} "
                                 "processes")
            self.opt_params = dp.shards
        self._shard = None if mesh is None else (self.rank, self.world)

    @property
    def _fsdp(self) -> bool:
        return self.data_parallel is not None and "fsdp" in self.data_parallel.mode


    def _setup_results(self, *, results_folder, force_clear_prev_results: bool,
                       checkpoint_backend: str, save_model_every: Optional[int], trackers: tuple):
        check_backend(checkpoint_backend)
        if (save_model_every is not None or checkpoint_backend == "orbax") and \
                results_folder is None:
            raise ValueError("save_model_every and checkpoint_backend='orbax' need a "
                             "results_folder to write to")
        self.checkpoint_backend = checkpoint_backend
        self.metrics: list = []
        self._metrics_path = self.results_folder = self.checkpointer = None
        if results_folder is not None:
            self.results_folder = Path(results_folder)
            if force_clear_prev_results and self.results_folder.exists() and self.is_first:
                shutil.rmtree(self.results_folder)
            self.results_folder.mkdir(parents=True, exist_ok=True)
            self._metrics_path = self.results_folder / "metrics.jsonl"
            if checkpoint_backend == "orbax":
                self.checkpointer = ShardedCheckpointer(self.results_folder / "orbax")
        self._trackers = tuple(trackers) if self.is_first else ()
        self._loss_buffer: list = []

    def _setup_core(self, *, module: torch.nn.Module, num_train_steps: int,
                    num_warmup_steps: Optional[int], lr: float, initial_lr: float, wd: float,
                    max_grad_norm: Optional[float], moment_dtype, ema_decay: Optional[float],
                    ema_dtype, log_every: int, save_results_every: int,
                    save_model_every: Optional[int], results_folder,
                    force_clear_prev_results: bool, checkpoint_backend: str, trackers: tuple,
                    seed: int, device, batch_size: int, mesh=None, use_mesh: bool = True,
                    split_batches: Optional[bool] = None):
        check_backend(checkpoint_backend)
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.steps = 0
        self.num_train_steps = num_train_steps
        self.num_warmup_steps = num_warmup_steps or 0
        self.lr, self.initial_lr, self.wd = lr, initial_lr, wd
        self.max_grad_norm = max_grad_norm
        self.named_params = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
        self.params = [p for _, p in self.named_params]
        self._setup_parallel(mesh=mesh, use_mesh=use_mesh, split_batches=split_batches,
                             batch_size=batch_size)
        self._setup_optimizer(moment_dtype=moment_dtype, ema_decay=ema_decay,
                              ema_dtype=ema_dtype)
        self.log_every = log_every
        self.save_results_every = save_results_every
        self.save_model_every = save_model_every
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._setup_results(results_folder=results_folder,
                            force_clear_prev_results=force_clear_prev_results,
                            checkpoint_backend=checkpoint_backend,
                            save_model_every=save_model_every, trackers=trackers)

    def _setup_optimizer(self, *, moment_dtype, ema_decay: Optional[float], ema_dtype) -> None:
        """AdamW and its schedule, and the EMA, over `self.opt_params`."""
        named = [(n, p) for (n, _), p in zip(self.named_params, self.opt_params)]
        self.optimizer = get_optimizer(named, lr=self.lr, wd=self.wd, moment_dtype=moment_dtype)
        self.scheduler = warmup_cosine_schedule(self.optimizer, self.lr, self.initial_lr,
                                                self.num_warmup_steps, self.num_train_steps)
        self.ema = (None if ema_decay is None
                    else ParamsEMA(self.opt_params, ema_decay, ema_dtype))

    # ------------------------------------------------------------------
    # data parallelism

    def _rows(self, micro: int, frames: Optional[int] = None):
        """The block a micro-batch's loss runs in: under a mesh, its draws
        at the global micro-batch's shape, this rank's rows kept; under
        sequence parallelism (`frames`: the rank's) also this rank's frames,
        the denoiser on its shard."""
        if self.data_parallel is None:
            return contextlib.nullcontext()
        return shard_draws(self.seq_group, frames,
                           (self.rank * micro, micro, micro * self.world))

    def _draw_rows(self, i: int, micro: int) -> slice:
        """This rank's rows of micro-batch i in a step's global draws."""
        start = (i * self.world + self.rank) * micro
        return slice(start, start + micro)

    def _apply_gradients(self, loss: torch.Tensor, grads: list) -> tuple:
        """Reduce over the data axis (once a step), clip, step the
        optimizer, the schedule and the EMA; under "fsdp" rebuild the
        module's whole weights. Returns (loss, grad_norm), the loss the
        global batch's. Under a mesh `grads` is emptied once reduced, so
        that the local gradients are freed before the update."""
        dp = self.data_parallel
        if dp is not None:
            reduced, rest = dp.reduce(grads, loss.reshape(1))
            grads.clear()
            for p in self.params:
                p.grad = None
            grads, loss = reduced, rest[0]
        grad_norm = None
        if self.max_grad_norm is not None:
            group = None if dp is None else dp.clip_group()
            grad_norm = clip_by_global_norm_f32(
                grads, self.max_grad_norm, group=group,
                counted=None if group is None else dp.counted)
        if isinstance(self.optimizer, AdamLowPrecisionMoments):
            self.optimizer.step(dict(zip(self.opt_params, grads)))
        else:
            for p, g in zip(self.opt_params, grads):
                p.grad = g if g.dtype == p.dtype else g.float()
            self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        for p in self.params:
            p.grad = None
        grads = None  # the reduced gradients, freed before the all-gather
        if dp is not None:
            dp.gather_params()
        if self.ema is not None:
            self.ema.update()
        return loss, grad_norm

    # ------------------------------------------------------------------
    # logging

    def print(self, msg):
        if getattr(self, "is_first", True):
            print(msg, flush=True)

    def _log_metrics(self, record: dict, step: Optional[int] = None):
        if not getattr(self, "is_first", True):
            return
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

    def save(self, path=None, extra_model_state: Optional[dict] = None):
        """Write the run (fp32 weights, moments, step, EMA): "msgpack" to
        `path` in the reference trainer's layout, by rank 0 (returns the
        checkpoint there, None elsewhere); "orbax" to
        `results_folder/orbax/<steps>`, every rank its shards (returns the
        directory). Every rank calls it."""
        self._flush_losses()
        if self.checkpoint_backend == "orbax":
            return self.checkpointer.save(self.steps, self._sharded_state())
        mus, nus, count = adam_state(self.optimizer, self.opt_params)
        ema = None if self.ema is None else self.ema.shadow
        state = None
        dp = self.data_parallel
        if dp is not None and ("fsdp" in dp.mode or dp.splits):  # shards or pieces
            whole = self.data_parallel.whole
            if all(m is not None for m in mus):
                mus, nus = whole(mus), whole(nus)
            ema = None if ema is None else whole(ema)
            state = self.data_parallel.module_state(self.module)
        if not self.is_first:
            return None
        return save_trainer_checkpoint(
            path, module=self.module, state_dict=state, named_params=self.named_params,
            optimizer=self.optimizer,
            steps=self.steps, lr=self.lr, wd=self.wd, moments=(mus, nus, count),
            ema_tensors=ema, extra_model_state=extra_model_state, prefix=self.state_prefix)

    def _save_every(self, steps: int, prefix: str) -> None:
        """The `save_model_every` checkpoint after step `steps`: "msgpack" to
        `results_folder/{prefix}.{steps}.pt`, "orbax" to its step directory."""
        path = self.results_folder / f"{prefix}.{steps}.pt"
        saved = self.save(path)
        self.print(f"{steps}: saving model to "
                   f"{saved if self.checkpoint_backend == 'orbax' else path}")

    def _sharded_state(self) -> dict:
        """The run as `torch.distributed.checkpoint` state: the tensors the
        optimizer steps, both moments and the EMA per parameter (an FSDP
        shard as a `DTensor`), the module's other state, the step counts.
        Under tensor parallelism every tensor is gathered whole (the
        reference layout, written once) and `self._unsplit` keeps, for a
        load, where each whole tensor's pieces go back."""
        dp = self.data_parallel
        wrap = (lambda i, t: t) if dp is None else dp.dtensor
        mus, nus, count = adam_state(self.optimizer, self.opt_params)
        if any(m is None for m in mus):  # no step yet: zero moments, as a first step sees
            restore_adam_state(self.optimizer, self.opt_params,
                               [torch.zeros_like(p) for p in self.opt_params],
                               [torch.zeros_like(p) for p in self.opt_params], count)
        kinds = {"model": [p.detach() for p in self.opt_params],
                 "exp_avg": [self.optimizer.state[p]["exp_avg"] for p in self.opt_params],
                 "exp_avg_sq": [self.optimizer.state[p]["exp_avg_sq"] for p in self.opt_params]}
        if self.ema is not None:
            kinds["ema"] = list(self.ema.shadow)
        self._unsplit = []
        if dp is not None and dp.splits:  # the pieces' wholes, and where they go back
            for kind, tensors in kinds.items():
                wholes = dp.whole(tensors)
                self._unsplit += [(i, t, w) for i, (t, w) in enumerate(zip(tensors, wholes))]
                kinds[kind] = wholes
            wrap = (lambda i, t: t)
        state = {"steps": torch.tensor(self.steps), "optim_count": torch.tensor(count)}
        for i, (name, _) in enumerate(self.named_params):
            state[f"model.{name}"] = wrap(i, kinds["model"][i])
            state[f"optim.{name}.exp_avg"] = wrap(i, kinds["exp_avg"][i])
            state[f"optim.{name}.exp_avg_sq"] = wrap(i, kinds["exp_avg_sq"][i])
            if self.ema is not None:
                state[f"ema.{name}"] = wrap(i, kinds["ema"][i])
        trained = {n for n, _ in self.named_params}
        for name, t in self.module.state_dict().items():
            if name not in trained:
                state[f"module.{name}"] = t
        return state

    def _set_step(self, steps: int) -> None:
        """The step count, and the schedule at it as if it had stepped there."""
        self.steps = steps
        sched = self.scheduler
        sched.last_epoch = steps
        for group, base, factor in zip(self.optimizer.param_groups, sched.base_lrs,
                                       sched.lr_lambdas):
            group["lr"] = base * factor(steps)
        sched._last_lr = [g["lr"] for g in self.optimizer.param_groups]

    def _module_state(self, model: dict) -> dict:
        """The module's state dict out of a checkpoint's `model` dict."""
        n = len(self.state_prefix)
        return {k[n:]: v for k, v in model.items() if k.startswith(self.state_prefix)}

    def load(self, path=None) -> None:
        """Resume from a checkpoint written by `save`: weights, moments, step
        count (and so the learning rate), EMA. "msgpack": every rank reads
        the file at `path`; "orbax": `path` is a step (int), a step
        directory or None / "latest". Every rank calls it."""
        dp = self.data_parallel
        if self.checkpoint_backend == "orbax":
            state = self._sharded_state()
            self.checkpointer.load(path, state)
            with torch.no_grad():
                for i, target, whole in self._unsplit:  # each rank's pieces of the wholes
                    target.copy_(dp.shard_of(i, whole))
            restore_adam_state(self.optimizer, self.opt_params,
                               [self.optimizer.state[p]["exp_avg"] for p in self.opt_params],
                               [self.optimizer.state[p]["exp_avg_sq"] for p in self.opt_params],
                               int(state["optim_count"]))
            if dp is not None:
                dp.gather_params()
            self._set_step(int(state["steps"]))
            return
        steps = load_trainer_checkpoint(
            path, module=self.module, named_params=self.named_params, optimizer=self.optimizer,
            ema=self.ema, prefix=self.state_prefix, module_state=self._module_state,
            opt_params=self.opt_params, shard=None if dp is None else dp.shard_of,
            localize=None if dp is None or not dp.splits else dp.local_state)
        if self._fsdp:  # the masters from the loaded whole weights
            with torch.no_grad():
                for i, (p, s) in enumerate(zip(self.params, self.opt_params)):
                    if s is not p:
                        s.copy_(dp.local(p.detach(), dp.axes[i]))
        self._set_step(steps)

    @property
    def ema_params(self) -> Optional[dict]:
        """{name: EMA tensor} (None without `ema_decay`); whole tensors (an
        FSDP run gathers them: every rank reads it)."""
        if self.ema is None:
            return None
        shadow = self.data_parallel.gather(self.ema.shadow) if self._fsdp else self.ema.shadow
        return {n: e for (n, _), e in zip(self.named_params, shadow)}

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
                  max_lengths=tuple(max_lengths), shard=self._shard)
        # micro-batch groups of batch_size rows: a rank keeps its block of each
        dl = PairedDataLoader(self.ds, batch_size * grad_accum_every, seed=seed,
                              shard_group_size=batch_size, **kw)
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

    def _loss_weight(self, batch: dict) -> Optional[torch.Tensor]:
        """The count a token-mean loss divides by, or None for a mean over
        rows (equal on every rank, so a plain mean over ranks is right)."""
        return None

    def _rank_weights(self, micro_batches) -> Optional[list]:
        """Under a mesh, each micro-batch loss's factor world * count /
        (the count over ranks): the mean over ranks of the weighted losses
        is the token mean over the global micro-batch."""
        if self.data_parallel is None:
            return None
        counts = [self._loss_weight(mb) for mb in micro_batches]
        if counts[0] is None:
            return None
        counts = torch.stack(counts).float()
        return list(counts * self.world / self.data_parallel.total(counts))

    def _gradients(self, batch: dict, draws: dict):
        """(mean loss, gradients): the loss and its backward per micro-batch,
        the gradients summed in the parameters' `.grad` and averaged."""
        accum = self.grad_accum_every
        micro = next(iter(batch.values())).shape[0] // accum
        slices = [slice(i * micro, (i + 1) * micro) for i in range(accum)]
        micro_batches = [{k: v[sl] for k, v in batch.items()} for sl in slices]
        weights = self._rank_weights(micro_batches)
        loss_sum = torch.zeros((), device=self.device)
        for i, mb in enumerate(micro_batches):
            rows = self._draw_rows(i, micro)
            with self._rows(micro):
                loss = self._loss(mb, self.generator, **{k: v[rows] for k, v in draws.items()})
            if weights is not None:
                loss = loss * weights[i]
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
        loss, grad_norm = self._apply_gradients(loss, grads)

        self._loss_buffer.append((steps, loss))
        if steps % self.log_every == 0:
            self.print(f"{steps}: loss: {self._flush_losses():0.3f}")
        if steps % self.save_results_every == 0:
            batch = self._prepare_batch(next(self.valid_dl_iter))
            gen = torch.Generator(device=self.device).manual_seed(steps)
            with torch.no_grad(), self._rows(next(iter(batch.values())).shape[0]):
                valid_loss = self._loss(batch, gen)
            weights = self._rank_weights([batch])
            if weights is not None:
                valid_loss = valid_loss * weights[0]
            if self.data_parallel is not None:
                valid_loss = self.data_parallel.mean(valid_loss)
            valid_loss = float(valid_loss)
            self.print(f"{steps}: valid loss {valid_loss:0.3f}")
            self._log_metrics({"valid_loss": valid_loss})
        self.steps += 1
        if self.save_model_every is not None and steps % self.save_model_every == 0:
            self._save_every(steps, self.ckpt_prefix)
        return {"loss": loss, "grad_norm": grad_norm}
