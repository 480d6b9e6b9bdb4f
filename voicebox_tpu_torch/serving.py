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

Texts longer than the largest text bucket are served by long-form
windowed infilling (`ConditionalFlowMatcherWrapper.sample_long_stream`):
the text is cut into segments of the largest bucket, same-bucket segments
go through one predictor forward (or one seq2seq decode) together, their
frame-rate ids are joined on the host, and one window program of
`long_window_frames` with `long_overlap_frames` of overlap runs over the
whole stream, its horizon snapped up to window + k x hop.
`synthesize_stream` yields such a text window by window. Voice cloning
(`clone`, `clone_stream`) rides the same windows: the prompt's latents fill
the first window's kept span and its ids lead the id stream; the stream
holds only the continuation. A raw-audio prompt is zero-padded onto
`prompt_seconds_buckets` before the codec encodes it (and, in semantic
mode, before the wav2vec reads it); in duration mode the prompt's ids come
from its transcript (`prompt_text`), the predictor conditioned on the
prompt's latents.

    audio = engine.clone("text to say", prompt_wave, prompt_text="what the prompt says")
    for chunk in engine.synthesize_stream(long_text):  # one chunk per window
        play(chunk)

`DynamicBatcher` coalesces single requests from many threads into bucket
groups on one worker thread; over-bucket texts form their own group, and
clones (`submit_clone`) run one at a time on the same thread.
`compilation_cache_dir` moves the kernels' build directory (the
counterpart of JAX's persistent compilation cache).
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

from . import kernels
from .models.duration import masked_frame_durations
from .ops.interp import curtail_or_pad
from .ops.masks import split_generator
from .ops.stft import resample

__all__ = ["DynamicBatcher", "TTSEngine", "split_generator"]


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
            kernels.set_build_dir(compilation_cache_dir)
        if not 0 < long_overlap_frames < long_window_frames:
            raise ValueError(f"need 0 < long_overlap_frames ({long_overlap_frames}) < "
                             f"long_window_frames ({long_window_frames})")
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
        self.long_window_frames = long_window_frames
        self.long_overlap_frames = long_overlap_frames
        self.enable_long_form = enable_long_form
        self.prompt_seconds_buckets = (tuple(sorted(prompt_seconds_buckets))
                                       if prompt_seconds_buckets else None)
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

    def _predict_durations(self, ids: np.ndarray, cond=None) -> np.ndarray:
        """(batch, length) bucket-padded phoneme ids -> integer frames per
        position on the host, clipped >= 1 and zeroed at pads: one
        predictor forward. Without `cond` (no voice prompt) the cond is zero
        and fully dropped; prompt latents `cond` (1, p, d) are cut or
        zero-padded on the host to the phoneme length and broadcast over
        the batch, so the forward keeps its bucket's shape."""
        dp = self.wrapper.duration_predictor
        if cond is not None:
            cond = curtail_or_pad(torch.as_tensor(cond, dtype=torch.float32).cpu(), ids.shape[1])
            cond = cond.expand(ids.shape[0], -1, -1)
        durations = dp.forward_with_cond_scale(cond=cond, phoneme_ids=torch.from_numpy(ids))
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
        groups. Texts longer than the largest text bucket go through
        long-form windowed infilling (`_stream_long`), one at a time, each
        with its own split generator; with `enable_long_form=False` they
        raise ValueError. The time axis spans the longest horizon (outputs
        of other horizons zero-padded to it); `return_lengths=True` also
        returns per-request valid lengths (samples of audio, frames of
        latents) as int32, and `trim=True` returns a LIST of per-request
        tensors cut to those lengths."""
        tok = self._tokenizer()
        ids_all = np.asarray(tok.texts_to_tensor_ids(list(texts)))
        valid = (ids_all >= 0).sum(axis=1)
        max_bucket = self.text_buckets[-1]
        long_rows = [i for i in range(len(texts)) if valid[i] > max_bucket]
        if long_rows and not self.enable_long_form:
            raise ValueError(
                f"text of {int(valid[long_rows[0]])} tokens exceeds the largest text "
                f"bucket {max_bucket} and long-form serving is disabled; raise "
                "text_buckets, split the text, or construct the engine with "
                "enable_long_form=True"
            )
        short_rows = [i for i in range(len(texts)) if i not in set(long_rows)]

        results = {}  # row -> (tensor with batch dim 1, length)
        if short_rows:
            ids_short = ids_all[short_rows]
            ids_short = ids_short[:, : max(1, int(valid[short_rows].max()))]
            length = self._bucket(ids_short.shape[1], self.text_buckets)
            max_batch = self.batch_buckets[-1]
            for start in range(0, len(short_rows), max_batch):
                rows = short_rows[start : start + max_batch]
                chunk = ids_short[start : start + max_batch]
                ids = self._pad_ids(chunk, self._bucket(chunk.shape[0], self.batch_buckets),
                                    length)
                chunk_gen = None if generator is None else split_generator(generator,
                                                                           self.device)
                out, out_lens = self._group_sample(ids, chunk_gen)
                for j, row in enumerate(rows):
                    results[row] = (out[j : j + 1], int(out_lens[j]))
        time_axis = -1 if self._outputs_audio else 1
        for row in long_rows:
            row_gen = None if generator is None else split_generator(generator, self.device)
            full = torch.cat(list(self._stream_long(ids_all[row : row + 1, : int(valid[row])],
                                                    generator=row_gen)), dim=time_axis)
            results[row] = (full, full.shape[time_axis])

        ordered = [results[i] for i in range(len(texts))]
        if trim:
            if self._outputs_audio:  # audio: time is the last axis
                return [o[0][..., :n] for o, n in ordered]
            return [o[0][:n] for o, n in ordered]  # latents (n, d)
        time_axis = ordered[0][0].dim() - 1 if self._outputs_audio else 1
        horizon = max(o.shape[time_axis] for o, _ in ordered)
        stacked = []
        for o, _ in ordered:
            pad = horizon - o.shape[time_axis]
            if pad:
                widths = [0, 0] * (o.dim() - 1 - time_axis) + [0, pad]
                o = torch.nn.functional.pad(o, widths)
            stacked.append(o)
        out = torch.cat(stacked, dim=0)
        if return_lengths:
            return out, torch.tensor([n for _, n in ordered], dtype=torch.int32)
        return out

    # ------------------------------------------------------------------
    # long-form (over-bucket) serving

    def synthesize_stream(self, text: str, generator: Optional[torch.Generator] = None):
        """Single-text streaming: a generator of audio (or latent) chunks.
        An over-bucket text streams by windowed infilling, its first chunk
        after one window; an in-bucket text yields its trimmed one-shot
        result as one chunk."""
        ids = np.asarray(self._tokenizer().texts_to_tensor_ids([text]))
        n_tokens = int((ids[0] >= 0).sum())
        if n_tokens <= self.text_buckets[-1]:
            yield self.synthesize([text], generator=generator, trim=True)[0]
            return
        if not self.enable_long_form:
            raise ValueError("text exceeds the largest text bucket and enable_long_form=False")
        yield from self._stream_long(ids[:, :n_tokens], generator=generator)

    def _long_ratio(self) -> float:
        """Latent frames per conditioning id on the long path: the wrapper's
        wav2vec / codec rate ratio in semantic mode; 1.0 in duration mode,
        whose aligned ids are at the frame rate."""
        if self.mode == "semantic":
            return self.wrapper.frames_per_semantic_token()
        return 1.0

    def _segment_groups(self, ids_row: np.ndarray):
        """Cut an over-bucket id row (1, n) into segments of the largest text
        bucket and stack same-bucket segments into groups of at most the
        largest batch bucket. Returns (number of segments, [(segment
        indices, (batch, length) padded ids), ...])."""
        seg = self.text_buckets[-1]
        items = []  # (bucket length, (1, length) padded row)
        for s in range(0, ids_row.shape[1], seg):
            chunk = ids_row[:, s : s + seg]
            length = self._bucket(chunk.shape[1], self.text_buckets)
            items.append((length, self._pad_ids(chunk, 1, length)))
        by_len: dict = {}
        for i, (length, _) in enumerate(items):
            by_len.setdefault(length, []).append(i)
        max_batch = self.batch_buckets[-1]
        groups = []
        for length, idxs in by_len.items():
            for start in range(0, len(idxs), max_batch):
                sel = idxs[start : start + max_batch]
                batch = self._bucket(len(sel), self.batch_buckets)
                stacked = self._pad_ids(np.concatenate([items[i][1] for i in sel], axis=0),
                                        batch, length)
                groups.append((sel, stacked))
        return len(items), groups

    def _long_frame_ids(self, ids_row: np.ndarray, cond=None):
        """(1, n_tokens) over-bucket ids -> (conditioning ids (1, m) on the
        host, exact frames). Each segment group runs one bucket forward: the
        seq2seq decode (its valid ids kept, at least one), or the duration
        predictor (under the prompt latents `cond`, duration mode) and the
        host alignment at each segment's exact duration sum, so the long
        path never clamps a predicted span."""
        n_segments, groups = self._segment_groups(ids_row)
        parts = [None] * n_segments
        if self.mode == "semantic":
            t2s = self.wrapper.text_to_semantic
            for sel, stacked in groups:
                sem, mask = t2s.generate(torch.from_numpy(stacked).long(),
                                         max_length=self.max_semantic_token_ids,
                                         return_target_mask=True, spec_decode=self.spec_decode)
                sem, n_valid = sem.cpu().numpy(), mask.sum(dim=1).cpu().numpy()
                for j, i in enumerate(sel):
                    parts[i] = sem[j : j + 1, : max(int(n_valid[j]), 1)]
        else:
            for sel, stacked in groups:
                per = self._predict_durations(stacked, cond=cond)
                for j, i in enumerate(sel):
                    parts[i] = self._align_ids_np(stacked[j : j + 1], per[j : j + 1],
                                                  max(int(per[j].sum()), 1))
        cond_ids = np.concatenate(parts, axis=1)
        return cond_ids, int(np.ceil(cond_ids.shape[1] * self._long_ratio()))

    def _stream_long(self, ids_row: np.ndarray, generator=None):
        """An over-bucket request -> its chunks (`_drive_long`)."""
        cond_ids, exact = self._long_frame_ids(ids_row)
        yield from self._drive_long(cond_ids, exact, generator=generator)

    def _drive_long(self, cond_ids: np.ndarray, exact: int, generator=None, prompt=None,
                    skip_frames: int = 0):
        """Stream `cond_ids` over `exact` latent frames through
        `sample_long_stream`, the first window conditioned on `prompt`
        (latents aligned with the first `skip_frames` ids). The horizon is
        snapped up to window + k x hop (the ids padded with their last id),
        so every request runs the shapes warmup ran; the prompt's span and
        the grid's tail are trimmed off the emitted stream by a host-side
        budget."""
        window, overlap = self.long_window_frames, self.long_overlap_frames
        hop = window - overlap
        total = window + int(np.ceil(max(exact - window, 0) / hop)) * hop
        n_pad_ids = int(np.ceil(total / self._long_ratio()))
        if n_pad_ids > cond_ids.shape[1]:
            cond_ids = np.concatenate(
                [cond_ids, np.repeat(cond_ids[:, -1:], n_pad_ids - cond_ids.shape[1], axis=1)],
                axis=1)
        as_audio = self._outputs_audio
        per_frame = self.wrapper.voicebox.audio_enc_dec.downsample_factor if as_audio else 1
        # emit frames [skip_frames, exact)
        budget = (exact - skip_frames) * per_frame
        skip = skip_frames * per_frame
        time_axis = -1 if as_audio else 1
        for chunk in self.wrapper.sample_long_stream(
            semantic_token_ids=torch.from_numpy(np.ascontiguousarray(cond_ids)).long(),
            total_frames=total, window_frames=window, overlap_frames=overlap, prompt=prompt,
            steps=self.steps, cond_scale=self.cond_scale, decode_to_audio=self.decode_to_audio,
            quantize=self.quantize, param_store_dtype=self.param_store_dtype,
            generator=generator,
        ):
            n = chunk.shape[time_axis]
            lo = min(skip, n)
            hi = min(lo + budget, n)
            skip -= lo
            budget -= hi - lo
            if hi > lo:
                yield chunk if (lo, hi) == (0, n) else chunk.narrow(time_axis, lo, hi - lo)
            if budget == 0:
                return

    # ------------------------------------------------------------------
    # in-context voice cloning

    def _duration_prompt_ids(self, prompt_lat, prompt_text: str) -> np.ndarray:
        """Frame-rate phoneme ids (1, p) of a duration-mode prompt of p
        latent frames: the transcript's durations under the prompt latents,
        scaled by cumulative rounding (float64 on the host) to sum to
        exactly p."""
        tok = self._tokenizer()
        ids = np.asarray(tok.texts_to_tensor_ids([prompt_text]))
        n = int((ids[0] >= 0).sum())
        if n == 0:
            raise ValueError("empty prompt_text")
        if n > self.text_buckets[-1]:
            raise ValueError(f"prompt transcript of {n} tokens exceeds the largest text "
                             f"bucket {self.text_buckets[-1]}")
        ids_b = self._pad_ids(ids[:, :n], 1, self._bucket(n, self.text_buckets))
        per = self._predict_durations(ids_b, cond=prompt_lat)[0]
        p = int(prompt_lat.shape[1])
        scaled = per.astype(np.float64) * (p / max(int(per.sum()), 1))
        cum = np.round(np.cumsum(scaled)).astype(np.int64)
        aligned = np.repeat(ids_b[0], np.diff(np.concatenate([[0], cum])))
        assert aligned.shape[0] == p, (aligned.shape, p)
        return aligned[None, :]

    def _prepare_prompt(self, prompt, prompt_ids, prompt_text=None):
        """A voice prompt -> (latents (1, p, d) on the device, ids (1, n_p) on
        the host). Raw audio (1, n_samples) at the codec's rate is
        zero-padded to a `prompt_seconds_buckets` bucket, encoded, and its
        valid frames (and, in semantic mode, the wav2vec's valid ids) are
        sliced back. Without `prompt_ids`, duration mode derives them from
        `prompt_text` (`_duration_prompt_ids`) and semantic mode from the
        audio through the wav2vec."""
        codec = self.wrapper.voicebox.audio_enc_dec
        prompt = torch.as_tensor(prompt)
        if prompt.dim() == 2:  # raw audio (1, n_samples)
            if codec is None:
                raise ValueError("raw-audio prompts need an audio_enc_dec on the VoiceBox; "
                                 "pass prompt latents (1, p, dim) and prompt_ids instead")
            if not self.prompt_seconds_buckets:
                raise ValueError("raw-audio prompts need TTSEngine(prompt_seconds_buckets=...)"
                                 ", the grid their encode runs on")
            sr = codec.sampling_rate
            n = prompt.shape[1]
            buckets = [int(round(s * sr)) for s in self.prompt_seconds_buckets]
            if n > buckets[-1]:
                raise ValueError(f"prompt of {n / sr:.1f}s exceeds the largest prompt bucket "
                                 f"({self.prompt_seconds_buckets[-1]}s)")
            target = self._bucket(n, buckets)
            padded = torch.zeros(1, target, device=self.device)
            padded[:, :n] = prompt.to(self.device, torch.float32)
            with torch.no_grad():
                lat = codec.encode(padded)
            lat = lat[:, : int(np.ceil(n / (target / lat.shape[1])))]
            if prompt_ids is None:
                if self.mode == "duration":
                    if prompt_text is None:
                        raise ValueError("duration mode derives prompt_ids from the prompt's "
                                         "transcript: pass prompt_text= (or prompt_ids=)")
                    prompt_ids = self._duration_prompt_ids(lat, prompt_text)
                else:
                    w2v = self.wrapper.text_to_semantic.wav2vec
                    if w2v is None:
                        raise ValueError("prompt_ids come from audio only through a wav2vec; "
                                         "pass prompt_ids=")
                    with torch.no_grad():
                        ids = w2v(resample(padded, sr, w2v.target_sample_hz))
                    n_p = int(np.ceil(n / (target / ids.shape[1])))
                    prompt_ids = ids[:, : max(n_p, 1)].cpu().numpy()
            return lat, np.asarray(prompt_ids)
        if prompt.dim() != 3:
            raise ValueError("prompt must be raw audio (1, n_samples) or latents (1, p, dim)")
        prompt = prompt.to(self.device)
        if prompt_ids is None and self.mode == "duration" and prompt_text:
            prompt_ids = self._duration_prompt_ids(prompt, prompt_text)
        if prompt_ids is None:
            raise ValueError("latent prompts need prompt_ids (the ids of the prompt span: "
                             "wav2vec ids of its audio, or prompt_text= in duration mode)")
        return prompt, np.asarray(prompt_ids)

    def clone_stream(self, text: str, prompt, *, prompt_ids=None, prompt_text=None,
                     generator: Optional[torch.Generator] = None):
        """In-context voice cloning: `text` spoken in the voice of `prompt`,
        yielded as audio (or latent) chunks, window by window. The prompt
        fills the first window's kept span (its length is data, not a
        shape) and the stream holds only the continuation. `prompt` is raw
        audio (1, n_samples) at the codec's rate, or latents (1, p, dim)
        with `prompt_ids`; in duration mode `prompt_text` (its transcript)
        can stand for `prompt_ids`, and the continuation's durations are
        also conditioned on the prompt."""
        if not self.enable_long_form:
            raise ValueError("cloning rides the long-form path; construct the engine with "
                             "enable_long_form=True")
        ids_row = np.asarray(self._tokenizer().texts_to_tensor_ids([text]))
        n_tokens = int((ids_row[0] >= 0).sum())
        if n_tokens == 0:
            raise ValueError("empty text")
        prompt_lat, p_ids = self._prepare_prompt(prompt, prompt_ids, prompt_text)
        p_frames = int(prompt_lat.shape[1])
        if p_frames > self.long_window_frames - 1:
            raise ValueError(f"prompt spans {p_frames} frames, must be < long_window_frames="
                             f"{self.long_window_frames}")
        gen_ids, gen_exact = self._long_frame_ids(
            ids_row[:, :n_tokens], cond=prompt_lat if self.mode == "duration" else None)
        cond_ids = np.concatenate([np.asarray(p_ids).astype(gen_ids.dtype), gen_ids], axis=1)
        yield from self._drive_long(cond_ids, p_frames + gen_exact, generator=generator,
                                    prompt=prompt_lat, skip_frames=p_frames)

    def clone(self, text: str, prompt, *, prompt_ids=None, prompt_text=None,
              generator: Optional[torch.Generator] = None):
        """One-shot voice cloning: the whole continuation, audio (1, 1,
        samples) or latents (1, frames, dim)."""
        chunks = list(self.clone_stream(text, prompt, prompt_ids=prompt_ids,
                                        prompt_text=prompt_text, generator=generator))
        return torch.cat(chunks, dim=-1 if self._outputs_audio else 1)

    def warmup(self, verbose: bool = False) -> float:
        """Run every (batch, text-length) bucket once, and with
        `warm_overflow_buckets` the sampler at every frame bucket only an
        overflow reaches; then, with long-form on, one two-window stream
        (window + one hop: the window sampler and every decode shape of the
        stream), one codec encode (and, in semantic mode, one wav2vec) per
        prompt bucket, and in duration mode one predictor forward under a
        prompt per (batch, text) bucket. Returns seconds. On the card this
        builds the kernels, plans cuFFT, fills the allocator and makes the
        quantized copy of the denoiser before the first request."""
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
        if self.enable_long_form:
            window, overlap = self.long_window_frames, self.long_overlap_frames
            total = 2 * window - overlap
            n_ids = int(np.ceil(total / self._long_ratio()))
            for _ in self.wrapper.sample_long_stream(
                semantic_token_ids=torch.zeros(1, n_ids, dtype=torch.long), total_frames=total,
                window_frames=window, overlap_frames=overlap, steps=self.steps,
                cond_scale=self.cond_scale, decode_to_audio=self.decode_to_audio,
                quantize=self.quantize, param_store_dtype=self.param_store_dtype,
            ):
                pass
            if verbose:
                print(f"warm long-form window={window} overlap={overlap}", flush=True)
        codec = self.wrapper.voicebox.audio_enc_dec
        if self.enable_long_form and self.prompt_seconds_buckets and codec is not None:
            sr = codec.sampling_rate
            w2v = self.wrapper.text_to_semantic.wav2vec if self.mode == "semantic" else None
            for secs in self.prompt_seconds_buckets:
                dummy = torch.zeros(1, int(round(secs * sr)), device=self.device)
                with torch.no_grad():
                    codec.encode(dummy)
                    if w2v is not None:
                        w2v(resample(dummy, sr, w2v.target_sample_hz))
                if verbose:
                    print(f"warm prompt bucket {secs}s", flush=True)
        if self.enable_long_form and self.mode == "duration":
            # the prompt-conditioned predictor; its cond width is the
            # predictor's own (its codec's latent width, else its dim)
            d = self.wrapper.duration_predictor.cond_dim
            for batch in self.batch_buckets:
                for length in self.text_buckets:
                    ids = np.full((batch, length), -1, dtype=np.int32)
                    ids[:, 0] = 0
                    self._predict_durations(ids, cond=np.zeros((1, length, d), np.float32))
            if verbose:
                print("warm prompt-conditioned duration predictor", flush=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm = True
        return time.perf_counter() - t0


class DynamicBatcher:
    """Request-level dynamic batching over a `TTSEngine`.

    `submit(text)` returns a `concurrent.futures.Future` at once; one worker
    thread drains the queue for up to `max_wait_ms` after the first pending
    request, groups what it collected by text bucket (over-bucket texts in a
    group of their own, served by the long-form path) and makes one
    `engine.synthesize(..., trim=True)` call per group. `submit_clone`
    queues a voice clone (`engine.clone`); clones run one at a time, each
    with its own split generator. All device work happens on that thread;
    submitters block only in `Future.result()`.

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
            self._queue.put(("synth", text, fut))
        return fut

    def submit_clone(self, text: str, prompt, *, prompt_ids=None, prompt_text=None) -> Future:
        """Enqueue one voice clone; the Future resolves to `engine.clone`'s
        output (the whole trimmed continuation)."""
        fut: Future = Future()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.put(("clone", (text, prompt, prompt_ids, prompt_text), fut))
        return fut

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
            *_, fut = item
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
            return -1  # over-bucket texts form their own (long-form) group
        return self.engine._bucket(n, self.engine.text_buckets)

    def _worker(self):
        tok = self.engine._tokenizer()
        while True:
            batch = self._collect()
            if batch is None:
                return
            groups: dict = {}
            clones = []
            for kind, payload, fut in batch:
                # False: cancelled while queued; once running it can no
                # longer be cancelled, so setting its result cannot raise
                if not fut.set_running_or_notify_cancel():
                    continue
                if kind == "clone":
                    clones.append((payload, fut))
                    continue
                try:
                    key = self._bucket_key(payload, tok)
                except Exception as e:  # a tokenizer failure fails that request
                    fut.set_exception(e)
                    continue
                groups.setdefault(key, []).append((payload, fut))
            for (text, prompt, prompt_ids, prompt_text), fut in clones:
                call_gen = split_generator(self._generator, self.engine.device)
                try:
                    fut.set_result(self.engine.clone(text, prompt, prompt_ids=prompt_ids,
                                                     prompt_text=prompt_text,
                                                     generator=call_gen))
                    self.stats["requests"] += 1
                except Exception as e:  # the worker keeps serving; the clone fails
                    fut.set_exception(e)
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
