"""Batched synthesis engine for serving: semantic mode and duration mode.

Counterpart of `voicebox_tpu/serving.py`. Semantic mode (a `TextToSemantic`
attached to the wrapper): texts -> the seq2seq's tokenizer's ids, padded
onto a grid of (batch, text-length) buckets -> `max_semantic_token_ids`
semantic ids from the seq2seq (speculative decode with `spec_decode`) ->
one sampling call whose attention mask is the ids' mask -> audio, with
lengths from that mask. Duration mode (a `DurationPredictor` attached):
texts -> phoneme ids, padded onto a grid of
(batch, text-length) buckets -> predicted durations (one predictor forward
per bucket group, read back to the host) -> phoneme ids at the frame rate,
aligned on the host at a frame horizon from a fixed grid (`frame_buckets`,
by default `frames_per_token` x each text bucket, re-bucketed up when the
predicted speech is longer, with a warning past the largest bucket) -> one
sampling call (CFG, optionally quantized: `quantize="w8a16"` runs the
denoiser's transformer matmuls through K4) -> audio.

On the card the grid keeps the device work to a few shapes, so `warmup()`
(one run per bucket) builds the kernels, makes cuFFT's plans, fills the
allocator and makes the quantized copy of the denoiser before the first
request. Randomness comes from a `torch.Generator`, split once per bucket
group (where the JAX engine splits its key).

    engine = TTSEngine(cfm_wrapper, text_buckets=(32, 64), batch_buckets=(1, 4))
    engine.warmup()
    audio, lengths = engine.synthesize(["hello"], return_lengths=True)
    clips = engine.synthesize(["hello"], trim=True)   # list of trimmed tensors

`DynamicBatcher` coalesces single requests from many threads into bucket
groups on one worker thread.

Not ported yet, and raising NotImplementedError: texts longer than the
largest text bucket and `long_window_frames` / `long_overlap_frames` other
than their defaults (long-form windowed sampling, item 12), voice cloning
(`clone`, `clone_stream`, `DynamicBatcher.submit_clone`, which ride the
long-form sampler, item 12), raw-audio prompt buckets
(`prompt_seconds_buckets`, which only cloning reads, item 12) and
`compilation_cache_dir` (item 12).
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from .models.duration import masked_frame_durations

__all__ = ["DynamicBatcher", "TTSEngine", "split_generator"]

_LONG_FORM = (
    "texts longer than the largest text bucket are served by long-form windowed "
    "sampling (sample_long_stream), not ported yet (ROADMAP Queue 1, item 12)"
)
_CLONING = (
    "voice cloning rides the long-form window sampler (sample_long_stream), not "
    "ported yet (ROADMAP Queue 1, item 12)"
)


def split_generator(generator: torch.Generator, device) -> torch.Generator:
    """A new generator on `device`, seeded by one draw from `generator`: the
    deterministic counterpart of `jax.random.split` for one child."""
    seed = torch.randint(0, 2**62, (1,), generator=generator, device=generator.device)
    return torch.Generator(device=device).manual_seed(int(seed.item()))


class TTSEngine:
    def __init__(
        self,
        cfm_wrapper,
        *,
        text_buckets: Sequence[int] = (32, 64, 128, 256),
        batch_buckets: Sequence[int] = (1, 2, 4, 8),
        steps: int = 3,
        cond_scale: float = 1.3,
        max_semantic_token_ids: int = 1024,
        spec_decode: bool = True,
        decode_to_audio: bool = True,
        frames_per_token: int = 8,
        frame_buckets: Optional[Sequence[int]] = None,
        quantize: Optional[str] = None,
        param_store_dtype: Optional[torch.dtype] = None,
        long_window_frames: int = 768,
        long_overlap_frames: int = 128,
        enable_long_form: bool = True,
        prompt_seconds_buckets: Optional[Sequence[float]] = None,
        warm_overflow_buckets: bool = False,
        compilation_cache_dir: Optional[str] = None,
    ):
        if compilation_cache_dir is not None:
            raise NotImplementedError(
                "compilation_cache_dir persists XLA programs, which the port does not "
                "compile; its kernels cache by source hash in build/kernels/ (ROADMAP "
                "Queue 1, item 12)"
            )
        if prompt_seconds_buckets:
            raise NotImplementedError(
                "prompt_seconds_buckets buckets the raw-audio prompts of voice "
                "cloning, which is not ported yet (ROADMAP Queue 1, item 12)"
            )
        if (long_window_frames, long_overlap_frames) != (768, 128):
            raise NotImplementedError(
                "long_window_frames and long_overlap_frames set long-form windowed "
                "sampling (sample_long_stream), not ported yet (ROADMAP Queue 1, item 12)"
            )
        if cfm_wrapper.text_to_semantic is None and cfm_wrapper.duration_predictor is None:
            raise ValueError(
                "TTSEngine needs a conditioning pipeline: attach a TextToSemantic "
                "(text -> semantic) or a DurationPredictor to the wrapper"
            )
        self.wrapper = cfm_wrapper
        self.mode = "semantic" if cfm_wrapper.text_to_semantic is not None else "duration"
        self.max_semantic_token_ids = max_semantic_token_ids
        self.spec_decode = spec_decode
        self.device = next(cfm_wrapper.voicebox.parameters()).device
        self.text_buckets = tuple(sorted(text_buckets))
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.steps = steps
        self.cond_scale = cond_scale
        self.decode_to_audio = decode_to_audio
        self.frames_per_token = frames_per_token
        self.quantize = quantize
        self.param_store_dtype = param_store_dtype
        if frame_buckets is None:
            frame_buckets = tuple(b * frames_per_token for b in self.text_buckets)
        self.frame_buckets = tuple(sorted(frame_buckets))
        self.enable_long_form = enable_long_form
        self.prompt_seconds_buckets = None
        self.warm_overflow_buckets = warm_overflow_buckets
        self._warm = False

    # ------------------------------------------------------------------

    @property
    def _outputs_audio(self) -> bool:
        """True when outputs are waveforms (time on the LAST axis); a
        codec-less wrapper returns latents (time on axis 1)."""
        return self.decode_to_audio and self.wrapper.voicebox.audio_enc_dec is not None

    def _tokenizer(self):
        if self.mode == "semantic":
            return self.wrapper.text_to_semantic.tokenizer
        return self.wrapper.duration_predictor.tokenizer

    @staticmethod
    def _bucket(value: int, buckets: Sequence[int]) -> int:
        for b in buckets:
            if value <= b:
                return b
        return buckets[-1]

    @staticmethod
    def _pad_ids(ids: np.ndarray, batch: int, length: int) -> np.ndarray:
        out = np.full((batch, length), -1, dtype=np.int32)
        b = min(ids.shape[0], batch)
        n = min(ids.shape[1], length)
        out[:b, :n] = ids[:b, :n]
        return out

    def _sample_kwargs(self, ids: np.ndarray) -> dict:
        """Semantic mode's conditioning keywords of `wrapper.sample`."""
        return {"text_token_ids": torch.from_numpy(ids).long(),
                "max_semantic_token_ids": self.max_semantic_token_ids,
                "spec_decode": self.spec_decode}

    def _semantic_sample(self, ids: np.ndarray, generator: Optional[torch.Generator]):
        """One semantic-mode bucket group: generate the ids, sample under
        their mask. Returns (output tensor on the device, per-row lengths as
        numpy int64)."""
        out, lens = self.wrapper.sample(
            **self._sample_kwargs(ids), steps=self.steps, cond_scale=self.cond_scale,
            decode_to_audio=self.decode_to_audio, return_lengths=True,
            quantize=self.quantize, param_store_dtype=self.param_store_dtype,
            generator=generator,
        )
        return out, lens.cpu().numpy().astype(np.int64)

    def _group_sample(self, ids: np.ndarray, generator: Optional[torch.Generator]):
        if self.mode == "semantic":
            return self._semantic_sample(ids, generator)
        return self._duration_sample(ids, generator)

    def _predict_durations(self, ids: np.ndarray) -> np.ndarray:
        """(batch, length) bucket-padded phoneme ids -> integer frames per
        position on the host, clipped >= 1 and zeroed at pads: one
        predictor forward (no voice prompt: zero cond, fully dropped)."""
        dp = self.wrapper.duration_predictor
        durations = dp.forward_with_cond_scale(cond=None, phoneme_ids=torch.from_numpy(ids))
        return masked_frame_durations(ids, durations.float().cpu().numpy())

    @staticmethod
    def _align_ids_np(ids: np.ndarray, per_pos: np.ndarray, total_length: int) -> np.ndarray:
        """Host-side alignment: each id repeated by its (pad-zeroed)
        duration, the tail filled with 0."""
        out = np.zeros((ids.shape[0], total_length), dtype=ids.dtype)
        for j in range(ids.shape[0]):
            rep = np.repeat(ids[j], per_pos[j])[:total_length]
            out[j, : rep.shape[0]] = rep
        return out

    def _duration_sample(self, ids: np.ndarray, generator: Optional[torch.Generator]):
        """One bucket group: predict durations, take the frame horizon from
        the text bucket, re-bucketed up the frame grid when the masked
        duration sum is longer (a warning and a clamp past the largest
        bucket: never a silent cut), align on the host and sample. Returns
        (output tensor on the device, per-row lengths as numpy int64)."""
        per = self._predict_durations(ids)
        n_valid = np.maximum(per.sum(axis=1), 1)
        frame_length = self._bucket(ids.shape[1] * self.frames_per_token, self.frame_buckets)
        needed = int(n_valid.max())
        if needed > frame_length:
            frame_length = self._bucket(needed, self.frame_buckets)
        if needed > self.frame_buckets[-1]:
            warnings.warn(
                f"predicted speech span of {needed} frames exceeds the largest frame "
                f"bucket {self.frame_buckets[-1]}; output is clipped to the bucket: raise "
                "frame_buckets/frames_per_token or split the text",
                stacklevel=3,
            )
            n_valid = np.minimum(n_valid, frame_length)
        aligned = self._align_ids_np(ids, per, frame_length)
        out = self.wrapper.sample(
            semantic_token_ids=torch.from_numpy(aligned).long(),
            ids_at_frame_rate=True,
            steps=self.steps,
            cond_scale=self.cond_scale,
            decode_to_audio=self.decode_to_audio,
            quantize=self.quantize,
            param_store_dtype=self.param_store_dtype,
            generator=generator,
        )
        if self._outputs_audio:
            lens = n_valid * self.wrapper.voicebox.audio_enc_dec.downsample_factor
        else:
            lens = n_valid
        return out, lens.astype(np.int64)

    # ------------------------------------------------------------------

    def synthesize(
        self,
        texts: List[str],
        generator: Optional[torch.Generator] = None,
        return_lengths: bool = False,
        trim: bool = False,
    ):
        """texts -> audio (or latents when decode_to_audio=False) padded to
        the enclosing (batch, text-length) bucket and trimmed back along the
        batch. Requests beyond the largest batch bucket run in successive
        groups. The time axis spans the group's frame horizon;
        `return_lengths=True` also returns per-request valid lengths
        (samples of audio, frames of latents) as int32, and `trim=True`
        returns a LIST of per-request tensors cut to those lengths. Texts
        longer than the largest text bucket raise: NotImplementedError
        (long-form serving is not ported yet), or ValueError with
        `enable_long_form=False`, as the JAX engine does."""
        tok = self._tokenizer()
        ids_all = np.asarray(tok.texts_to_tensor_ids(list(texts)))
        valid = (ids_all >= 0).sum(axis=1)
        max_bucket = self.text_buckets[-1]
        long_rows = [i for i in range(len(texts)) if valid[i] > max_bucket]
        if long_rows:
            if not self.enable_long_form:
                raise ValueError(
                    f"text of {int(valid[long_rows[0]])} tokens exceeds the largest text "
                    f"bucket {max_bucket} and long-form serving is disabled; raise "
                    "text_buckets or split the text"
                )
            raise NotImplementedError(_LONG_FORM)

        ids_all = ids_all[:, : max(1, int(valid.max()))]
        length = self._bucket(ids_all.shape[1], self.text_buckets)
        max_batch = self.batch_buckets[-1]
        results = []  # (tensor with batch dim 1, length)
        for start in range(0, len(texts), max_batch):
            chunk = ids_all[start : start + max_batch]
            ids = self._pad_ids(chunk, self._bucket(chunk.shape[0], self.batch_buckets), length)
            chunk_gen = None if generator is None else split_generator(generator, self.device)
            out, out_lens = self._group_sample(ids, chunk_gen)
            results += [(out[j : j + 1], int(out_lens[j])) for j in range(chunk.shape[0])]

        if trim:
            if self._outputs_audio:  # audio: time is the last axis
                return [o[0][..., :n] for o, n in results]
            return [o[0][:n] for o, n in results]  # latents (n, d)
        time_axis = results[0][0].dim() - 1 if self._outputs_audio else 1
        horizon = max(o.shape[time_axis] for o, _ in results)
        stacked = []
        for o, _ in results:
            pad = horizon - o.shape[time_axis]
            if pad:
                widths = [0, 0] * (o.dim() - 1 - time_axis) + [0, pad]
                o = torch.nn.functional.pad(o, widths)
            stacked.append(o)
        out = torch.cat(stacked, dim=0)
        if return_lengths:
            return out, torch.tensor([n for _, n in results], dtype=torch.int32)
        return out

    def synthesize_stream(self, text: str, generator: Optional[torch.Generator] = None):
        """Single-text streaming: an in-bucket text yields its trimmed
        one-shot result as one chunk. Over-bucket texts (windowed
        infilling) are not ported yet and raise."""
        ids = np.asarray(self._tokenizer().texts_to_tensor_ids([text]))
        if int((ids[0] >= 0).sum()) > self.text_buckets[-1]:
            raise NotImplementedError(_LONG_FORM)
        yield self.synthesize([text], generator=generator, trim=True)[0]

    def clone(self, text: str, prompt, *, prompt_ids=None, prompt_text=None, generator=None):
        raise NotImplementedError(_CLONING)

    def clone_stream(self, text: str, prompt, *, prompt_ids=None, prompt_text=None,
                     generator=None):
        raise NotImplementedError(_CLONING)

    def warmup(self, verbose: bool = False) -> float:
        """Run every (batch, text-length) bucket once, and with
        `warm_overflow_buckets` the sampler at every frame bucket only an
        overflow reaches; returns seconds. On the card this builds the
        kernels, plans cuFFT, fills the allocator and makes the quantized
        copy of the denoiser."""
        t0 = time.perf_counter()
        for batch in self.batch_buckets:
            for length in self.text_buckets:
                ids = self._pad_ids(self._tokenizer().texts_to_tensor_ids(["a"] * batch),
                                    batch, length)
                self._group_sample(ids, None)
                if verbose:
                    print(f"warm bucket batch={batch} len={length}", flush=True)
        if self.mode == "duration" and self.warm_overflow_buckets:
            covered = {self._bucket(n * self.frames_per_token, self.frame_buckets)
                       for n in self.text_buckets}
            for batch in self.batch_buckets:
                for fb in self.frame_buckets:
                    if fb in covered:
                        continue
                    self.wrapper.sample(
                        semantic_token_ids=torch.zeros(batch, fb, dtype=torch.long),
                        ids_at_frame_rate=True, steps=self.steps, cond_scale=self.cond_scale,
                        decode_to_audio=self.decode_to_audio, quantize=self.quantize,
                        param_store_dtype=self.param_store_dtype,
                    )
                    if verbose:
                        print(f"warm overflow bucket batch={batch} frames={fb}", flush=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm = True
        return time.perf_counter() - t0


class DynamicBatcher:
    """Request-level dynamic batching over a `TTSEngine`.

    `submit(text)` returns a `concurrent.futures.Future` at once; one worker
    thread drains the queue for up to `max_wait_ms` after the first pending
    request, groups what it collected by text bucket and makes one
    `engine.synthesize(..., trim=True)` call per group. All device work
    happens on that thread; submitters block only in `Future.result()`.

        engine.warmup()
        with DynamicBatcher(engine, max_wait_ms=8.0) as batcher:
            futures = [batcher.submit(t) for t in texts]   # from any thread
            clips = [f.result() for f in futures]
    """

    _SENTINEL = object()

    def __init__(self, engine: TTSEngine, *, max_wait_ms: float = 8.0,
                 max_batch: Optional[int] = None, seed: int = 0, autostart: bool = True):
        self.engine = engine
        self.max_wait_s = max_wait_ms / 1000.0
        self.max_batch = int(max_batch or engine.batch_buckets[-1])
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._queue: "queue.Queue" = queue.Queue()
        self._generator = torch.Generator().manual_seed(seed)
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # serialises submit() against close(): a submit that passed the
        # closed check must not enqueue behind the shutdown sentinel
        self._submit_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "occupancy_sum": 0}

        if autostart:
            self.start()

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, name="DynamicBatcher",
                                            daemon=True)
            self._thread.start()
        return self

    def submit(self, text: str) -> Future:
        """Enqueue one request; the Future resolves to its trimmed output
        (audio (1, t) or latents (n, d), the engine's `trim=True` layout)."""
        fut: Future = Future()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.put((text, fut))
        return fut

    def submit_clone(self, text: str, prompt, *, prompt_ids=None, prompt_text=None) -> Future:
        raise NotImplementedError(_CLONING)

    def synthesize(self, text: str, timeout: Optional[float] = None):
        """Blocking convenience wrapper around `submit`."""
        return self.submit(text).result(timeout)

    def close(self, timeout: Optional[float] = 30.0):
        """Drain outstanding requests and stop the worker."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(self._SENTINEL)
        worker_alive = False
        if self._thread is not None:
            self._thread.join(timeout)
            worker_alive = self._thread.is_alive()
        # whatever is still queued (a join that timed out mid-batch, or no
        # worker at all) fails rather than leaving a caller blocked
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is self._SENTINEL:
                if worker_alive:  # the live worker still needs it to stop
                    self._queue.put(item)
                    break
                continue
            _, fut = item
            if fut.set_running_or_notify_cancel():
                fut.set_exception(RuntimeError("DynamicBatcher closed"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    @property
    def mean_occupancy(self) -> float:
        b = self.stats["batches"]
        return self.stats["occupancy_sum"] / b if b else 0.0

    def _collect(self):
        """Block for the first request, then drain until `max_batch` are in
        hand or `max_wait_ms` has passed. None means shutdown."""
        first = self._queue.get()
        if first is self._SENTINEL:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                item = (self._queue.get_nowait() if remaining <= 0
                        else self._queue.get(timeout=remaining))
            except queue.Empty:
                break
            if item is self._SENTINEL:
                self._queue.put(self._SENTINEL)  # the next _collect shuts down
                break
            batch.append(item)
        return batch

    def _bucket_key(self, text: str, tok) -> int:
        ids = np.asarray(tok.texts_to_tensor_ids([text]))
        n = int((ids[0] >= 0).sum())
        if n > self.engine.text_buckets[-1]:
            return -1  # over-bucket texts form their own group (and raise)
        return self.engine._bucket(n, self.engine.text_buckets)

    def _worker(self):
        tok = self.engine._tokenizer()
        while True:
            batch = self._collect()
            if batch is None:
                return
            groups: dict = {}
            for text, fut in batch:
                # False: cancelled while queued; once running it can no
                # longer be cancelled, so setting its result cannot raise
                if not fut.set_running_or_notify_cancel():
                    continue
                try:
                    key = self._bucket_key(text, tok)
                except Exception as e:  # a tokenizer failure fails that request
                    fut.set_exception(e)
                    continue
                groups.setdefault(key, []).append((text, fut))
            for items in groups.values():
                call_gen = split_generator(self._generator, self.engine.device)
                try:
                    clips = self.engine.synthesize([t for t, _ in items], generator=call_gen,
                                                   trim=True)
                except Exception as e:  # the worker keeps serving; the group fails
                    for _, fut in items:
                        fut.set_exception(e)
                    continue
                self.stats["requests"] += len(items)
                self.stats["batches"] += 1
                self.stats["occupancy_sum"] += len(items)
                for (_, fut), clip in zip(items, clips):
                    fut.set_result(clip)
