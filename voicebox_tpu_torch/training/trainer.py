"""The VoiceBox trainer: CFM loss, gradient accumulation, fp32 global-norm
clip, AdamW and the warmup -> cosine schedule, on latent datasets.

Counterpart of `voicebox_tpu/training/trainer.py::VoiceBoxTrainer`. A step
takes `batch_size * grad_accum_every` items, runs the loss and its backward
per micro-batch (on the card: K1 forward, K2 + K3 backward in every
attention layer), averages the gradients, clips, steps the optimizer and
then the schedule. Losses stay on the device between log boundaries and
are fetched together. Every `save_results_every` steps a validation batch
gives a loss, with the span and CFG masks drawn from a generator seeded by
the step.

Data parallelism over processes (`training/base.py`): `mesh` (a
`parallel.mesh.make_mesh` DeviceMesh; by default one is built under a
process group of more than one process, unless `use_mesh=False`),
`split_batches` (None or True: `batch_size` is the global batch),
`param_sharding` ("replicated"; "fsdp": the parameters of at least
`min_fsdp_size` elements, their moments and EMA split over "data"; "tp":
attention's heads and the feed-forward's columns split over the mesh's
"model" axis, `make_mesh(model_parallel=m)`; "fsdp+tp": both; see
`parallel/data_parallel.py` and `parallel/tensor_parallel.py`) and
`seq_parallel` (> 1: a ("data", "seq") mesh over the process group, each
rank training on its block of every batch's frames through ring
attention, `parallel/sequence_parallel.py`; the bucket length must divide
by it, and the parameters stay replicated). Each rank decodes its rows
only (the loaders' `shard`; the ranks of one "data" row decode the same
rows and keep their frames), draws at the global micro-batch's shape and
keeps its rows and frames, and the gradients are reduced once a step, so a
run equals the single-process one on the same global batch.

The JAX trainer's single-device options:

* `moment_dtype` (bf16): Adam moments stored in bf16
  (`optimizer.AdamLowPrecisionMoments`); None keeps `torch.optim.AdamW`;
* `param_dtype` (bf16): bf16 live parameters over the fp32 master. The
  module's parameters hold the fp32 master between steps; a step swaps the
  bf16 live copies in for its forward and backward, so the gradients are
  bf16 (accumulated in fp32 when `grad_accum_every > 1`), the clip norm
  sums in fp32, the update lands on the master and the live copies are
  recast from it (`mixed_step`). Validation, `generate` and checkpoints use
  the master;
* `ema_decay` / `ema_dtype`: an EMA of the post-step parameters
  (`ema_params`, `generate(use_ema=True)`);
* checkpoints in the reference trainer's `.pt` layout (`training/
  checkpoint.py`): `save` / `load`, `save_torch` / `load_torch`, and every
  `save_model_every` steps `results_folder/voicebox.{step}.pt`;
* `trackers`, `metrics.jsonl` (records as the JAX trainer writes them),
  `prefetch_batches` (a background thread collates, into pinned memory on
  the card), the `torch.profiler` window `profile_dir` / `profile_steps`.

Datasets hold latents (n, d), (latents (n, d), frame-aligned ids (n,))
pairs or raw waves (n,) (`training.data.ArrayDataset`, or the files of
`training.data.AudioDataset`). Waves go through
the denoiser's frozen codec (`MelVoco` or `EncodecVoco`) on the device,
without gradient, and their frame masks come from `ceil(len / ds)` with
ds = samples / frames, as the JAX trainer computes them; a text-conditioned
denoiser takes their semantic ids from the frozen wav2vec of the wrapper's
`TextToSemantic`, resampled to its rate; their buckets are
in samples, `(registers + frame_offset) * downsample` below a multiple of
`128 * downsample`, so frames + registers land on the 128 grid (a 10 s wave
of 240 000 samples, 938 mel frames at hop 256, pads to 257 792 samples =
1008 frames + 16 registers). Checkpoints are "msgpack" (the reference's
`.pt`) or "orbax" (sharded, `training/checkpoint.py`). The module's
parameters must be fp32: the
denoiser computes in its `dtype` (bf16 on the card) and casts each weight
at use, as the JAX trainer does. Unlike the JAX trainer, metrics and
checkpoints are written only when a `results_folder` is given, and a
checkpoint's `steps` counts the optimizer steps it holds.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models.cfm import ConditionalFlowMatcherWrapper, resolve_device
from ..models.codec import frame_mask
from ..utils.convert import denoiser_state
from .base import TrainerBase
from .checkpoint import check_backend
from .data import AlignedPairedDataLoader, DataLoader, PrefetchLoader, random_split

__all__ = ["VoiceBoxTrainer"]


@contextlib.contextmanager
def swapped(params, tensors):
    """Let `params` hold `tensors` (any dtype) inside the block."""
    saved = [p.data for p in params]
    for p, t in zip(params, tensors):
        p.data = t
    try:
        yield
    finally:
        for p, t in zip(params, saved):
            p.data = t


class VoiceBoxTrainer(TrainerBase):
    """Its own set-up and step on `TrainerBase`'s logging, EMA view and
    checkpoints (the denoiser's state under `voicebox.`)."""

    state_prefix = "voicebox."

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
        moment_dtype=None,
        param_dtype=None,
        ema_decay: Optional[float] = None,
        ema_dtype=None,
        max_grad_norm: Optional[float] = 0.5,
        valid_frac: float = 0.05,
        random_split_seed: int = 42,
        log_every: int = 10,
        save_results_every: int = 100,
        save_model_every: Optional[int] = None,
        results_folder: Optional[str] = None,
        force_clear_prev_results: bool = False,
        split_batches: Optional[bool] = None,
        mesh=None,
        use_mesh: bool = True,
        param_sharding: str = "replicated",  # replicated | fsdp | tp | fsdp+tp
        seq_parallel: int = 1,
        min_fsdp_size: int = 2 ** 16,
        seed: int = 0,
        bucket_multiple: int = 256,
        max_length: Optional[int] = None,
        bucket_offset: Optional[int] = None,  # None: the register count
        drop_last: bool = False,
        prefetch_batches: int = 2,  # 0: collate on the calling thread
        profile_dir: Optional[str] = None,
        profile_steps: tuple = (10, 15),
        checkpoint_backend: str = "msgpack",
        # each a callable tracker(record, step) for every metrics record, or
        # an object with any of init_trackers(project, config) / log(values,
        # step) / finish()
        trackers: tuple = (),
        device="cuda",
    ):
        check_backend(checkpoint_backend)
        self.device = resolve_device(device)
        self.cfm_wrapper = cfm_wrapper.to(self.device)
        self.batch_size = batch_size
        self.grad_accum_every = grad_accum_every
        self.max_grad_norm = max_grad_norm
        self.log_every = log_every
        self.save_results_every = save_results_every
        self.save_model_every = save_model_every
        self.lr, self.initial_lr, self.wd = lr, initial_lr, wd

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

        vb = self.module = cfm_wrapper.voicebox
        self.named_params = [(n, p) for n, p in vb.named_parameters() if p.requires_grad]
        wrong = [n for n, p in self.named_params if p.dtype != torch.float32]
        if wrong:
            raise ValueError(
                f"the trainer needs fp32 parameters (build VoiceBox with "
                f"param_dtype=torch.float32); got {wrong[:3]}..."
            )
        self.params = [p for _, p in self.named_params]
        self._setup_parallel(mesh=mesh, use_mesh=use_mesh, split_batches=split_batches,
                             batch_size=batch_size, param_sharding=param_sharding,
                             min_fsdp_size=min_fsdp_size, seq_parallel=seq_parallel)
        self._setup_optimizer(moment_dtype=moment_dtype, ema_decay=ema_decay,
                              ema_dtype=ema_dtype)
        self.param_dtype = param_dtype
        self._live = None
        if param_dtype is not None:
            self._live = [p.detach().to(param_dtype) for p in self.params]

        probe = dataset[0]
        self._paired = isinstance(probe, tuple) and len(probe) == 2
        self._raw_audio = not self._paired and np.asarray(probe).ndim == 1
        if self._raw_audio and vb.audio_enc_dec is None:
            raise ValueError("a dataset of raw waves needs an audio_enc_dec on the VoiceBox")
        # raw waves for a text-conditioned denoiser: ids through the frozen
        # wav2vec of the wrapper's TextToSemantic, as the JAX trainer derives them
        self._derive_ids = self._raw_audio and vb.condition_on_text
        if self._derive_ids and getattr(cfm_wrapper.text_to_semantic, "wav2vec", None) is None:
            raise ValueError("raw waves for a text-conditioned VoiceBox need a TextToSemantic "
                             "with a wav2vec on the wrapper to derive the semantic ids")
        align_multiple = 128
        if bucket_offset is None:
            bucket_offset = vb.transformer.num_register_tokens
            if self._raw_audio:  # the same grid in samples
                codec = vb.audio_enc_dec
                ds_factor = int(codec.downsample_factor)
                bucket_offset = (bucket_offset + int(codec.frame_offset)) * ds_factor
                align_multiple = 128 * ds_factor
                if bucket_multiple % align_multiple != 0:
                    bucket_multiple = align_multiple
        loader = AlignedPairedDataLoader if self._paired else DataLoader
        kw = dict(bucket_multiple=bucket_multiple, max_length=max_length, drop_last=drop_last,
                  bucket_offset=bucket_offset, align_multiple=align_multiple, shard=self._shard)
        # micro-batch groups of batch_size rows: a rank keeps its block of each
        dl = loader(self.ds, batch_size * grad_accum_every, seed=seed,
                    shard_group_size=batch_size, **kw)
        valid_dl = loader(self.valid_ds, batch_size, seed=seed + 1, **kw)
        if prefetch_batches > 0:
            pin = self._pinned if self.device.type == "cuda" else None
            self.dl_iter = PrefetchLoader(dl, prefetch_batches, pin).cycle()
            self.valid_dl_iter = PrefetchLoader(valid_dl, 1, pin).cycle()
        else:
            self.dl_iter, self.valid_dl_iter = dl.cycle(), valid_dl.cycle()

        self.profile_dir, self.profile_steps = profile_dir, tuple(profile_steps)
        self._profiler = None
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.steps = 0
        self._setup_results(results_folder=results_folder,
                            force_clear_prev_results=force_clear_prev_results,
                            checkpoint_backend=checkpoint_backend,
                            save_model_every=save_model_every, trackers=trackers)
        self._log_init_hps()

    # ------------------------------------------------------------------
    # data

    @staticmethod
    def _pinned(item):
        """A loader item as tensors in pinned host memory, made on the
        prefetch thread, so the copy to the card is asynchronous."""
        def one(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).pin_memory()

        if isinstance(item[0], tuple):  # (latents, mask), (ids, ids mask)
            (x, mask), (ids, ids_mask) = item
            return (one(x, torch.float32), one(mask, torch.bool)), (one(ids, torch.int64),
                                                                   ids_mask)
        x, mask = item
        return one(x, torch.float32), one(mask, torch.bool)

    def _next_batch(self, iterator):
        """(latents, mask, ids or None) as tensors on the device; waves are
        encoded by the frozen codec. Under sequence parallelism the latents
        and the mask are this rank's frames, the ids whole."""
        x, mask, ids = self._whole_batch(iterator)
        if self.seq_group is None:
            return x, mask, ids
        n, size = x.shape[1], self.seq_parallel
        if n % size:
            raise ValueError(f"bucket length {n} does not divide by seq_parallel={size}: pick "
                             "bucket_multiple / bucket_offset so that every bucket does")
        frames = self._frames(n)
        return x[:, frames], mask[:, frames], ids

    def _frames(self, n: int) -> slice:
        """This rank's frames of a sequence of `n` (sequence parallelism)."""
        local = n // self.seq_parallel
        start = torch.distributed.get_rank(self.seq_group) * local
        return slice(start, start + local)

    def _whole_batch(self, iterator):
        item = next(iterator)
        if self._paired:
            (x, mask), (ids, _) = item
        else:
            (x, mask), ids = item, None

        def put(a, dtype):
            if not torch.is_tensor(a):
                a = torch.from_numpy(np.ascontiguousarray(a))
            return a.to(self.device, dtype, non_blocking=True)

        x, mask = put(x, torch.float32), put(mask, torch.bool)
        if self._raw_audio:
            wave = x
            with torch.no_grad():
                x = self.cfm_wrapper.voicebox.audio_enc_dec.encode(wave)
            mask = frame_mask(mask, x.shape[1])
            if self._derive_ids:
                return x, mask, self.cfm_wrapper._wav2vec_ids(wave, None)
        return x, mask, None if ids is None else put(ids, torch.int64)

    # ------------------------------------------------------------------
    # checkpoints

    def _module_state(self, model: dict) -> dict:
        return denoiser_state(model)

    def load(self, path=None) -> None:
        """Resume from a checkpoint written by `save`, by the JAX package's
        `save_torch` or by the reference trainer: weights, moments, step
        count (and so the learning rate), EMA; the bf16 live copies are
        recast from the loaded weights. With "orbax", `path` is a step, a
        step directory or None (the newest)."""
        super().load(path)
        if self._live is not None:
            torch._foreach_copy_(self._live, [p.detach() for p in self.params])

    # the reference trainer's names: the same file
    save_torch = TrainerBase.save
    load_torch = load

    def generate(self, *args, use_ema: bool = False, **kwargs):
        """`cfm_wrapper.sample` with the fp32 weights, or the EMA's (an FSDP
        run gathers them: every rank calls it)."""
        if not use_ema:
            return self.cfm_wrapper.sample(*args, **kwargs)
        if self.ema is None:
            raise ValueError("use_ema=True needs VoiceBoxTrainer(ema_decay=...)")
        with swapped(self.params, list(self.ema_params.values())):
            return self.cfm_wrapper.sample(*args, **kwargs)

    # ------------------------------------------------------------------
    # training

    def _loss(self, x, mask, ids, **randomness):
        return self.cfm_wrapper.loss_fn(x, mask=mask, cond_token_ids=ids, **randomness)

    def _gradients(self, x, mask, ids, draws):
        """(mean loss, gradients per parameter): fp32 in the parameters'
        `.grad` for fp32 parameters; for bf16 live parameters, bf16 with one
        micro-batch, else summed in fp32."""
        accum = self.grad_accum_every
        micro = x.shape[0] // accum
        loss_sum = torch.zeros((), device=self.device)
        acc = None
        for i in range(accum):
            sl, rows = slice(i * micro, (i + 1) * micro), self._draw_rows(i, micro)
            with self._rows(micro, x.shape[1]):
                loss = self._loss(x[sl], mask[sl], None if ids is None else ids[sl],
                                  generator=self.generator,
                                  **{k: self._draw_part(v[rows]) for k, v in draws.items()})
            loss.backward()
            loss_sum += loss.detach()
            if self._live is not None:
                grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
                for p in self.params:
                    p.grad = None
                if accum > 1:
                    grads = [g.float() for g in grads]
                    if acc is None:
                        acc = grads
                    else:
                        torch._foreach_add_(acc, grads)
                else:
                    acc = grads
        if acc is None:  # fp32 parameters: .grad is the accumulator
            for p in self.params:  # an unused parameter still decays, as under optax
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            acc = [p.grad for p in self.params]
        if accum > 1:
            torch._foreach_div_(acc, accum)
        return loss_sum / accum, acc

    def _draw_part(self, draw: torch.Tensor) -> torch.Tensor:
        """An explicit draw's part for this rank: its frames under sequence
        parallelism (a draw of the whole sequence's frames on axis 1)."""
        if self.seq_group is None or draw.dim() < 2:
            return draw
        return draw[:, self._frames(draw.shape[1])]

    def _profile_window(self, steps: int) -> None:
        if self.profile_dir is None:
            return
        if steps == self.profile_steps[0]:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.start()
        elif steps == self.profile_steps[1] and self._profiler is not None:
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        prof, self._profiler = self._profiler, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        Path(self.profile_dir).mkdir(parents=True, exist_ok=True)
        path = Path(self.profile_dir) / f"trace_{self.profile_steps[0]}_{self.steps}.json"
        prof.export_chrome_trace(str(path))
        self.print(f"{self.steps}: profiler trace written to {path}")

    def train_step(self, **draws):
        """One optimizer step. `draws` (`noise`, `times`, `cond_mask`,
        `cond_drop_mask`, each for the whole step's batch) replace the
        generator's draws, to replay a run. Returns {"loss", "grad_norm"} as
        tensors on the device."""
        steps = self.steps
        self._profile_window(steps)
        x, mask, ids = self._next_batch(self.dl_iter)
        self.cfm_wrapper.train()
        if self._live is None:
            loss, grads = self._gradients(x, mask, ids, draws)
        else:
            with swapped(self.params, self._live):
                loss, grads = self._gradients(x, mask, ids, draws)
        loss, grad_norm = self._apply_gradients(loss, grads)
        if self._live is not None:  # the next step's live copies
            torch._foreach_copy_(self._live, [p.detach() for p in self.params])

        self._loss_buffer.append((steps, loss))
        if steps % self.log_every == 0:
            self.print(f"{steps}: loss: {self._flush_losses():0.3f}")
        if steps % self.save_results_every == 0:
            x, mask, ids = self._next_batch(self.valid_dl_iter)
            gen = torch.Generator(device=self.device).manual_seed(steps)
            with torch.no_grad(), self._rows(x.shape[0], x.shape[1]):
                valid_loss = self._loss(x, mask, ids, generator=gen)
            if self.data_parallel is not None:  # equal rows: the mean of the ranks' means
                valid_loss = self.data_parallel.mean(valid_loss)
            valid_loss = float(valid_loss)
            self.print(f"{steps}: valid loss {valid_loss:0.3f}")
            self._log_metrics({"valid_loss": valid_loss})
        self.steps += 1
        if self.save_model_every is not None and steps % self.save_model_every == 0:
            self._save_every(steps, "voicebox")
        return {"loss": loss, "grad_norm": grad_norm}

    def train(self):
        try:
            while self.steps < self.num_train_steps:
                self.train_step()
        finally:
            self._flush_losses()
            if self._profiler is not None:
                self._stop_profiler()
        self.print("training complete")
        for tracker in self._trackers:
            if hasattr(tracker, "finish"):
                tracker.finish()
