"""Conditional flow matching wrapper: the training loss and the sampler.

Counterpart of `voicebox_tpu/models/cfm.py::ConditionalFlowMatcherWrapper`
on latents:

* `loss_fn` / calling the wrapper: the CFM objective, x0 ~ N(0, I) and
  t ~ U(0, 1) per sample, w = (1 - (1 - sigma) t) x0 + t x1, flow =
  x1 - (1 - sigma) x0, and the VoiceBox masked MSE of its prediction at w
  against flow, with the random span and CFG masks. Every random draw comes
  from `generator=` or is passed in (`noise=`, `times=`, `cond_mask=`,
  `cond_drop_mask=`);
* `sample`: an ODE from noise y0 over the VoiceBox vector field, on a fixed
  grid (midpoint by default; `torchdiffeq_ode_method` or `ode_method` picks
  euler, rk4 or tsit5) or, with `use_torchode=True`, adaptive Tsit5 at
  `ode_atol` / `ode_rtol` (the reference's torchode path; the steps it took
  are left in `ode_steps_taken`). Classifier-free guidance runs as ONE
  forward at batch 2b (`null + (cond - null) * cond_scale`), then the
  codec's decode (RVQ -> Vocos -> iSTFT) in the same call. y0 comes from
  `noise=` or from `generator=`. The conditioning ids are
  `semantic_token_ids`, or, with a `DurationPredictor` attached, phonemes
  (`phoneme_ids=` or `texts=`) aligned to the frame rate by the predicted
  durations, or, with a `TextToSemantic` attached, semantic ids that it
  generates from `texts=` / `text_token_ids=` (its mask becomes the
  denoiser's attention mask and sets `return_lengths`). Without text
  conditioning, `duration_seconds` sets the length: of `batch_size` rows of
  zero cond, or of the given cond, cut or padded;
* quantized serving: `sample(quantize="w8a16" | "int8",
  param_store_dtype=...)` samples through a copy of the denoiser whose
  parameters are cast first, then whose transformer matmuls are quantized
  (`ops/quant.py`; "w8a16" runs K4 on the card). The copy is made once per
  weights version (each parameter's storage and version counter), so an
  update of the weights is always served.

* checkpoints in the reference trainer's layout (`torch.save({'model',
  'optim', 'scheduler'})`, the denoiser's keys under `voicebox.`):
  `save_torch` writes one, `load_torch` / `load` read the denoiser from one
  (a reference, JAX-package or port trainer checkpoint).

Raw audio, (b, n) or (b, 1, n) by its shape, goes through the attached
codec (`MelVoco` or `EncodecVoco`): `x1` and `cond` of the loss are
resampled from `input_sampling_rate` when it differs and encoded without
gradient, `sample(cond=<wave>)` encodes its prompt, and the sampled latents
decode back to audio through the same codec.

With a `TextToSemantic` attached, the loss takes semantic ids from raw
audio when none are given: its `wav2vec` (HuBERT + k-means) reads `x1`
resampled to its rate.

The wrapper is an nn.Module holding `voicebox`, the frozen codec, the
duration predictor or the TextToSemantic (with its wav2vec), and it moves
them to `device` when it is built: the card unless the caller asks for the
CPU.

Long-form sampling (`sample_long`, `sample_long_stream`) generates any
length by windowed infilling: the ids are stretched to the frame rate, the
horizon is cut into windows of `window_frames` that overlap by
`overlap_frames`, and each window is one `sample(cond=, cond_mask=,
ids_at_frame_rate=True)` whose first frames keep the previous window's tail
(or an optional voice prompt, in the first window). The latent buffer, the
overlap copy and the kept span stay on the device, so a window costs no
host read; the stream decodes what each window finalizes with a left
context and a right guard of already-sampled frames.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.interp import curtail_or_pad
from ..ops.masks import normal, split_generator, uniform
from ..ops.ode import cfm_interpolant, odeint, odeint_tsit5_adaptive
from ..ops.quant import QUANT_MODES, cast_float_params, quantize_voicebox
from ..ops.stft import resample
from ..parallel.distributed import is_multihost, local_cuda_device
from ..utils.convert import denoiser_state
from .duration import masked_frame_durations
from .voicebox import VoiceBox

__all__ = ["ConditionalFlowMatcherWrapper", "is_probably_audio_from_shape", "resolve_device"]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. "cuda" (the default of every entry
    point) needs a card and raises without one: the port never falls back to
    the CPU on its own. Under a multi-process group, "cuda" without an index
    is this process's card (`parallel.distributed.local_cuda_device`)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on an NVIDIA GPU by default; pass "
            "device='cpu' to run on the CPU"
        )
    if device.type == "cuda" and device.index is None and is_multihost():
        return local_cuda_device()
    return device


def is_probably_audio_from_shape(t) -> bool:
    """Raw audio is (b, n) or (b, 1, n)."""
    return t is not None and (t.dim() == 2 or (t.dim() == 3 and t.shape[1] == 1))


class ConditionalFlowMatcherWrapper(nn.Module):
    def __init__(
        self,
        voicebox: VoiceBox,
        text_to_semantic=None,
        duration_predictor=None,
        sigma: float = 0.0,
        ode_method: str = "midpoint",
        cond_drop_prob: float = 0.0,
        # the reference's names: torchdiffeq's method, or torchode's adaptive
        # Tsit5, which honours the tolerances
        ode_atol: float = 1e-5,
        ode_rtol: float = 1e-5,
        use_torchode: bool = False,
        torchdiffeq_ode_method: Optional[str] = None,
        device="cuda",
    ):
        super().__init__()
        if torchdiffeq_ode_method is not None:
            ode_method = torchdiffeq_ode_method
        if use_torchode:
            ode_method = "tsit5_adaptive"
        if text_to_semantic is not None and not voicebox.condition_on_text:
            raise ValueError("TextToSemantic should not be passed in if not conditioning on text")
        if text_to_semantic is not None and duration_predictor is not None:
            raise ValueError("use either TextToSemantic or DurationPredictor, not both")
        self.voicebox = voicebox
        self.codec = voicebox.audio_enc_dec  # registered: moves with .to()
        self.text_to_semantic = text_to_semantic
        self.duration_predictor = duration_predictor
        self.sigma = sigma
        self.ode_method = ode_method
        self.ode_atol, self.ode_rtol = ode_atol, ode_rtol
        self.ode_steps_taken: Optional[int] = None  # of the last adaptive solve
        self.cond_drop_prob = cond_drop_prob
        self.condition_on_text = voicebox.condition_on_text
        self._serving_copy = None  # (weights key, cast and/or quantized VoiceBox)
        self.to(resolve_device(device))

    @property
    def audio_enc_dec(self):
        return self.voicebox.audio_enc_dec

    # ------------------------------------------------------------------
    # checkpoints in the reference trainer's layout

    def load_torch(self, path, strict: bool = True) -> dict:
        """Load the denoiser from a reference-layout checkpoint (reference
        trainer.py:191-197: `pkg['model']` is the wrapper's state dict, the
        denoiser under `voicebox.`), written by the reference trainer, the
        JAX package's `save_torch` or this package. Frozen `audio_enc_dec.*`
        codec weights are skipped. Returns the checkpoint."""
        pkg = torch.load(path, map_location="cpu", weights_only=False)
        sd = pkg["model"] if isinstance(pkg, dict) and "model" in pkg else pkg
        self.voicebox.load_state_dict(denoiser_state(sd), strict=strict)
        return pkg

    def load(self, path, strict: bool = True) -> dict:
        """Restore the denoiser from a trainer checkpoint and return the
        checkpoint, so a trainer can restore the rest (the port's trainer
        writes the reference layout, so this is `load_torch`)."""
        return self.load_torch(path, strict=strict)

    def save_torch(self, path, extra_model_state: Optional[dict] = None) -> dict:
        """Write the denoiser as a reference-layout checkpoint that the
        reference's `ConditionalFlowMatcherWrapper.load` reads: fp32 weights
        under `voicebox.`, an empty optimizer and scheduler.
        `extra_model_state` entries (e.g. the frozen codec's
        `voicebox.audio_enc_dec.*` weights) are merged in. Returns the
        checkpoint."""
        model = {f"voicebox.{k}": v.detach().to("cpu", torch.float32, copy=True)
                 for k, v in self.voicebox.state_dict().items()}
        model.update(extra_model_state or {})
        pkg = {"model": model, "optim": {}, "scheduler": {}}
        torch.save(pkg, str(path))
        return pkg

    def loss_fn(
        self,
        x1: torch.Tensor,  # (b, n, latent_dim) latents
        *,
        mask: Optional[torch.Tensor] = None,  # (b, n) bool, False = padding
        cond_token_ids: Optional[torch.Tensor] = None,
        cond: Optional[torch.Tensor] = None,
        cond_mask: Optional[torch.Tensor] = None,
        cond_drop_mask: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        times: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The CFM training loss on latents, a scalar fp32 tensor. x0 is
        `noise` or a standard normal draw, t is `times` or U(0, 1) per sample;
        the span and CFG masks are `cond_mask` / `cond_drop_mask` or drawn by
        VoiceBox, all from `generator`."""
        batch = x1.shape[0]
        if noise is None:
            noise = normal(x1.shape, generator, x1.device, x1.dtype)
        if times is None:
            times = uniform((batch,), generator, x1.device)
        w, flow = cfm_interpolant(x1, noise, times, self.sigma)
        return self.voicebox(
            w, times=times, cond_token_ids=cond_token_ids, self_attn_mask=mask,
            cond_drop_prob=self.cond_drop_prob, cond_drop_mask=cond_drop_mask,
            target=flow, cond=cond, cond_mask=cond_mask, train=True, generator=generator,
        )

    def forward(
        self,
        x1: torch.Tensor,
        *,
        mask: Optional[torch.Tensor] = None,
        semantic_token_ids: Optional[torch.Tensor] = None,
        phoneme_ids: Optional[torch.Tensor] = None,
        cond: Optional[torch.Tensor] = None,
        cond_mask: Optional[torch.Tensor] = None,
        input_sampling_rate: Optional[int] = None,
        **randomness,
    ) -> torch.Tensor:
        """`wrapper(x1, ...)`: the CFM training loss on latents (b, n, d) or
        raw audio (b, n) / (b, 1, n), conditioned on semantic or phoneme ids.
        Raw audio (`x1` or `cond`) is resampled from `input_sampling_rate`
        when it differs from the codec's and encoded by the frozen codec;
        `mask` is then at the latent frame rate. With a TextToSemantic
        attached and no ids given, the ids come from raw `x1` through its
        wav2vec. `randomness` is `generator=` or the draws themselves, as
        `loss_fn` takes them."""
        if (self.condition_on_text and self.text_to_semantic is not None
                and semantic_token_ids is None and phoneme_ids is None):
            semantic_token_ids = self._wav2vec_ids(x1, input_sampling_rate)
        x1, cond = self._encode_raw_audio(x1, cond, input_sampling_rate)
        if self.condition_on_text and (semantic_token_ids is None) == (phoneme_ids is None):
            raise ValueError("pass one of semantic_token_ids or phoneme_ids")
        if not self.condition_on_text and (semantic_token_ids is not None
                                           or phoneme_ids is not None):
            raise ValueError(
                "semantic or phoneme ids should not be passed in if not conditioning on text"
            )
        cond_token_ids = semantic_token_ids if phoneme_ids is None else phoneme_ids
        return self.loss_fn(x1, mask=mask, cond_token_ids=cond_token_ids, cond=cond,
                            cond_mask=cond_mask, **randomness)

    def _wav2vec_ids(self, x1, input_sampling_rate: Optional[int]) -> torch.Tensor:
        """Semantic ids of raw audio x1 ((b, n) or (b, 1, n), at
        `input_sampling_rate`, by default the codec's rate) through the
        TextToSemantic's wav2vec, at its rate."""
        if not is_probably_audio_from_shape(x1):
            raise ValueError("semantic ids from a TextToSemantic's wav2vec need raw audio x1 "
                             "(b, n); pass semantic_token_ids with latents")
        wav2vec = self.text_to_semantic.wav2vec
        codec = self.audio_enc_dec
        sr = input_sampling_rate or (codec.sampling_rate if codec is not None
                                     else wav2vec.target_sample_hz)
        audio = x1.reshape(x1.shape[0], -1)
        with torch.no_grad():
            return wav2vec(resample(audio, sr, wav2vec.target_sample_hz))

    def frames_per_semantic_token(self) -> float:
        """Latent frames per semantic id: the wav2vec / codec rate ratio of
        the sampler's length algebra, 1.0 when either is absent."""
        codec = self.audio_enc_dec
        t2s = self.text_to_semantic
        if t2s is None or codec is None or t2s.wav2vec is None:
            return 1.0
        w2v = t2s.wav2vec
        return (w2v.target_sample_hz / w2v.downsample_factor) / (
            codec.sampling_rate / codec.downsample_factor)

    def _encode_raw_audio(self, x1, cond, input_sampling_rate: Optional[int] = None):
        """(x1, cond) with each raw-audio tensor ((b, n) or (b, 1, n)),
        resampled to the codec's rate when `input_sampling_rate` differs,
        replaced by the codec's latents, computed without gradient."""
        raw = [t is not None and is_probably_audio_from_shape(t) for t in (x1, cond)]
        if not any(raw):
            return x1, cond
        codec = self.audio_enc_dec
        if codec is None:
            raise ValueError("audio_enc_dec must be set on VoiceBox to train on raw audio")
        sr = input_sampling_rate or codec.sampling_rate

        def encode(audio):
            with torch.no_grad():
                return codec.encode(resample(audio, sr, codec.sampling_rate))

        return (encode(x1) if raw[0] else x1), (encode(cond) if raw[1] else cond)

    def _serving_voicebox(self, quantize: Optional[str], param_store_dtype) -> VoiceBox:
        """The denoiser that `sample` runs: the wrapper's own, or a copy with
        its parameters cast to `param_store_dtype` and then its transformer
        matmuls quantized for `quantize` (the JAX package's order). The copy
        is cached per weights version: each parameter's storage and in-place
        version counter, so a load or an optimizer step makes a new one."""
        if quantize is None and param_store_dtype is None:
            return self.voicebox
        if quantize is not None and quantize not in QUANT_MODES:
            raise ValueError(f"unknown quantize mode {quantize!r} (use one of {QUANT_MODES})")
        vb = self.voicebox
        key = (quantize, param_store_dtype,
               tuple((p.data_ptr(), p._version) for p in vb.parameters()))
        if self._serving_copy is not None and self._serving_copy[0] == key:
            return self._serving_copy[1]
        self._serving_copy = None  # drop the stale copy before building the next
        served = vb if param_store_dtype is None else cast_float_params(vb, param_store_dtype)
        if quantize is not None:
            served = quantize_voicebox(served, quantize)
        self._serving_copy = (key, served.eval())
        return served

    @staticmethod
    def _vector_field(vb, t, x, cond, cond_token_ids, cond_scale, self_attn_mask=None,
                      cond_mask=None):
        b = x.shape[0]
        if cond_scale == 1.0:
            drop = torch.zeros(b, dtype=torch.bool, device=x.device)
            out = vb(x, times=t, cond=cond, cond_token_ids=cond_token_ids, cond_drop_mask=drop,
                     self_attn_mask=self_attn_mask, cond_mask=cond_mask)
            return out.to(x.dtype)
        # CFG: the conditioned half and the null half as one 2b forward

        def twice(a):
            return None if a is None else torch.cat([a, a])

        drop2 = torch.arange(2 * b, device=x.device) >= b
        out2 = vb(
            torch.cat([x, x]), times=t.reshape(1).expand(2 * b),
            cond=torch.cat([cond, cond]), cond_token_ids=twice(cond_token_ids),
            cond_drop_mask=drop2, self_attn_mask=twice(self_attn_mask),
            cond_mask=twice(cond_mask),
        ).to(x.dtype)
        logits, null_logits = out2[:b], out2[b:]
        return null_logits + (logits - null_logits) * cond_scale

    def _duration_ids(self, cond, texts, phoneme_ids, frame_length, device):
        """Frame-rate ids from the duration predictor and each row's speech
        span in frames (the masked duration sum)."""
        dp = self.duration_predictor
        if phoneme_ids is None:
            if texts is None:
                raise ValueError("pass texts, phoneme_ids or semantic_token_ids")
            phoneme_ids = dp.tokenizer.texts_to_tensor_ids(texts)
        if not torch.is_tensor(phoneme_ids):
            phoneme_ids = torch.from_numpy(np.asarray(phoneme_ids))
        phoneme_ids = phoneme_ids.to(device).long()
        durations, aligned = dp.forward_with_cond_scale(
            cond=cond, phoneme_ids=phoneme_ids, return_aligned_phoneme_ids=True,
            total_length=frame_length,
        )
        return aligned, masked_frame_durations(phoneme_ids, durations).sum(dim=-1)

    @torch.no_grad()
    def sample(
        self,
        *,
        cond: Optional[torch.Tensor] = None,
        texts=None,
        text_token_ids=None,
        semantic_token_ids: Optional[torch.Tensor] = None,
        phoneme_ids=None,
        cond_mask: Optional[torch.Tensor] = None,
        steps: int = 3,
        cond_scale: float = 1.0,
        decode_to_audio: bool = True,
        decode_to_codes: bool = False,
        max_semantic_token_ids: int = 2048,
        spec_decode: bool = False,
        spec_decode_gamma: int = 5,
        return_lengths: bool = False,
        frame_length: Optional[int] = None,
        duration_seconds: Optional[float] = None,
        batch_size: int = 1,
        quantize: Optional[str] = None,
        param_store_dtype: Optional[torch.dtype] = None,
        ids_at_frame_rate: bool = False,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Sample latents by integrating the ODE from y0, then decode them to
        audio when a codec is attached and `decode_to_audio` (`(b, 1, n *
        320)` through EncodecVoco, `(b, n * hop)` through MelVoco), or, with
        `decode_to_codes` (which takes precedence), to the codec's RVQ codes
        (`EncodecVoco.decode_to_codes`: `(b, q, n)`). y0 is `noise` if
        given, else a standard normal draw from `generator`. `cond` is
        latents, or raw audio that the codec encodes. `cond_mask` ((b, n)
        bool, True = generate) keeps the cond where it is False (speech
        editing); by default every frame is generated. Under CFG it goes to
        both halves of the batch.

        Conditioning: `semantic_token_ids`; with a duration predictor
        `phoneme_ids` / `texts`, aligned at the predicted durations over
        `frame_length` frames (default: the longest row's span;
        `duration_seconds` sets it; a `frame_length` that cuts a predicted
        span warns); with a TextToSemantic `texts` / `text_token_ids`, from
        which it generates `max_semantic_token_ids` ids (speculatively with
        `spec_decode`, `spec_decode_gamma` draft tokens a round), their mask
        becoming the denoiser's attention mask. With a TextToSemantic, a
        codec and `cond`, the cond's length follows the ids at the wav2vec /
        codec rate ratio, unless `ids_at_frame_rate` says the ids are
        already one per latent frame.

        Without text conditioning, `duration_seconds` is the length in
        seconds (a codec defines the frame rate): `cond` is cut or padded to
        it, or, with no `cond`, `batch_size` rows of zero cond are
        generated whole from noise.

        `quantize` ("w8a16" or "int8") and `param_store_dtype` serve from a
        cached cast and quantized copy of the denoiser. With
        `return_lengths` also returns per-sample valid lengths (samples of
        audio, or frames of latents): the masked duration sum, clamped to
        the horizon, in the duration branch; the generated ids' count (at
        the rate ratio with a codec), clamped, in the TextToSemantic branch;
        the whole horizon otherwise."""
        t2s = self.text_to_semantic
        if (texts is not None or text_token_ids is not None) and (
                self.duration_predictor is None and t2s is None):
            raise NotImplementedError(
                "sampling from text needs a DurationPredictor or a TextToSemantic attached")
        if text_token_ids is not None and t2s is None:
            raise NotImplementedError("text_token_ids need a TextToSemantic attached; pass "
                                      "phoneme_ids or texts to the duration branch")
        if phoneme_ids is not None and self.duration_predictor is None:
            raise NotImplementedError(
                "phoneme_ids need a DurationPredictor attached (duration_predictor=)")
        if sum(x is not None for x in (texts, text_token_ids, semantic_token_ids,
                                       phoneme_ids)) > 1:
            raise ValueError("pass one of texts, text_token_ids, semantic_token_ids or "
                             "phoneme_ids")
        codec = self.audio_enc_dec
        vb = self.voicebox
        device = next(vb.parameters()).device
        if cond is not None:
            cond = torch.as_tensor(cond, device=device)
            if is_probably_audio_from_shape(cond):
                if codec is None:
                    raise ValueError("cond as raw audio needs an audio_enc_dec to encode it")
                cond = codec.encode(cond)
        want_frames = None
        if duration_seconds is not None:
            if codec is None:
                raise ValueError(
                    "duration_seconds needs an audio_enc_dec to define seconds per "
                    "frame; pass cond latents of the desired length instead"
                )
            want_frames = codec.frames_for_seconds(duration_seconds)

        cond_token_ids, dp_frames, self_attn_mask = None, None, None
        if self.condition_on_text:
            if semantic_token_ids is not None or t2s is not None:
                if want_frames is not None:
                    raise ValueError(
                        "duration_seconds conflicts with semantic-token conditioning: "
                        "the latent length follows the token count"
                    )
                if semantic_token_ids is None:
                    if texts is None and text_token_ids is None:
                        raise ValueError("pass texts, text_token_ids or semantic_token_ids")
                    semantic_token_ids, self_attn_mask = t2s.generate(
                        text_token_ids if text_token_ids is not None else texts,
                        max_length=max_semantic_token_ids, return_target_mask=True,
                        spec_decode=spec_decode, spec_decode_gamma=spec_decode_gamma)
                cond_token_ids = torch.as_tensor(semantic_token_ids, device=device)
            elif self.duration_predictor is not None:
                if want_frames is not None and frame_length is None:
                    frame_length = want_frames
                cond_token_ids, dp_frames = self._duration_ids(cond, texts, phoneme_ids,
                                                               frame_length, device)
            else:
                raise ValueError(
                    "semantic_token_ids required (or attach a DurationPredictor and pass "
                    "texts or phoneme_ids)"
                )
            n_frames = cond_token_ids.shape[-1]
            if cond is not None:
                if (t2s is not None and t2s.wav2vec is not None and codec is not None
                        and not ids_at_frame_rate):
                    # the wav2vec / codec sample-rate algebra, in the JAX
                    # package's order of operations (ceil of an exact ratio)
                    w2v = t2s.wav2vec
                    n_frames = math.ceil((n_frames * w2v.target_sample_hz
                                          / w2v.downsample_factor)
                                         / (codec.sampling_rate / codec.downsample_factor))
                cond = curtail_or_pad(cond, n_frames)
            else:
                cond = torch.zeros(cond_token_ids.shape[0], n_frames, vb.latent_dim,
                                   device=device)
        else:
            if semantic_token_ids is not None:
                raise ValueError(
                    "no conditioning ids should be given if not conditioning on text"
                )
            if want_frames is not None:
                # length-specified generation: zero cond, and the default
                # all-True sampling span regenerates all of it
                if cond is None:
                    cond = torch.zeros(batch_size, want_frames, vb.latent_dim, device=device)
                else:
                    cond = curtail_or_pad(cond, want_frames)
            if cond is None:
                raise ValueError(
                    "cond latents (or duration_seconds with a codec) required to sample"
                )

        if noise is not None:
            y0 = torch.as_tensor(noise, device=device, dtype=cond.dtype)
            assert y0.shape == cond.shape, f"noise {tuple(y0.shape)} != cond {tuple(cond.shape)}"
        else:
            y0 = normal(cond.shape, generator, device, cond.dtype)

        served = self._serving_voicebox(quantize, param_store_dtype)
        if cond_mask is not None:
            cond_mask = torch.as_tensor(cond_mask, device=device).bool()

        def field(t, x):
            return self._vector_field(served, t, x, cond, cond_token_ids, cond_scale,
                                      self_attn_mask, cond_mask)

        if self.ode_method == "tsit5_adaptive":
            latents, self.ode_steps_taken = odeint_tsit5_adaptive(
                field, y0, 0.0, 1.0, atol=self.ode_atol, rtol=self.ode_rtol)
        else:
            times = torch.linspace(0.0, 1.0, steps, device=device)
            latents, _ = odeint(field, y0, times, method=self.ode_method)

        if dp_frames is not None and frame_length is not None:
            # a static horizon that cuts the predicted speech is never silent
            over = int((dp_frames - cond.shape[1]).max())
            if over > 0:
                warnings.warn(
                    f"predicted durations span up to {over} frames beyond "
                    f"frame_length={cond.shape[1]}; the generated speech is truncated: "
                    "raise frame_length",
                    stacklevel=2,
                )

        out_is_audio = decode_to_audio and not decode_to_codes and codec is not None
        if decode_to_codes and codec is not None:
            out = codec.decode_to_codes(latents)
        else:
            out = codec.decode(latents) if out_is_audio else latents
        if not return_lengths:
            return out
        n_frames = cond.shape[1]
        if self_attn_mask is not None:
            valid = self_attn_mask.sum(dim=-1)
            if t2s is not None and codec is not None and t2s.wav2vec is not None:
                valid = torch.ceil(valid * self.frames_per_semantic_token())
            frames = valid.clamp(max=n_frames).to(torch.int32)
        elif dp_frames is not None:
            frames = dp_frames.clamp(max=n_frames).to(torch.int32)
        else:
            frames = torch.full((out.shape[0],), n_frames, dtype=torch.int32, device=device)
        if out_is_audio:
            return out, frames * codec.downsample_factor
        return out, frames

    # ------------------------------------------------------------------
    # long-form sampling by windowed infilling

    def _long_total_frames(self, n_ids: int, total_frames: Optional[int]) -> int:
        """The default long-form horizon: the id count at the wav2vec / codec
        rate ratio (`sample`'s cond length for the same ids)."""
        if total_frames is not None:
            return int(total_frames)
        return math.ceil(n_ids * self.frames_per_semantic_token())

    @staticmethod
    def _validate_long_args(total_frames: int, window_frames: int, overlap_frames: int) -> None:
        if not 0 < overlap_frames < window_frames:
            raise ValueError(f"need 0 < overlap_frames ({overlap_frames}) < window_frames "
                             f"({window_frames})")
        if total_frames < window_frames:
            raise ValueError(f"total_frames {total_frames} < window_frames {window_frames}: "
                             "use sample() directly for short outputs")

    def sample_long(self, *, semantic_token_ids, total_frames: Optional[int] = None,
                    window_frames: int = 768, overlap_frames: int = 128, prompt=None,
                    steps: int = 3, cond_scale: float = 1.0, decode_to_audio: bool = True,
                    quantize: Optional[str] = None,
                    param_store_dtype: Optional[torch.dtype] = None,
                    generator: Optional[torch.Generator] = None):
        """Any length by windowed infilling: `semantic_token_ids` (b, n_ids)
        condition the whole output of `total_frames` frames (default: the id
        count at the rate ratio). Window k + 1 keeps window k's last
        `overlap_frames` (cond_mask False there) and generates the rest; an
        optional `prompt` ((b, p, d) latents or (b, n) raw audio, p <
        `window_frames`) fills the first window's kept span. Every window has
        the same shape. Returns the decoded audio, or the (b, total_frames,
        d) latents; `sample_long_stream` runs the same window loop."""
        chunks = list(self._sample_long_chunks(
            semantic_token_ids=semantic_token_ids, total_frames=total_frames,
            window_frames=window_frames, overlap_frames=overlap_frames, prompt=prompt,
            steps=steps, cond_scale=cond_scale, quantize=quantize,
            param_store_dtype=param_store_dtype, generator=generator))
        out = torch.cat(chunks, dim=1)
        codec = self.audio_enc_dec
        if decode_to_audio and codec is not None:
            with torch.no_grad():
                return codec.decode(out)
        return out

    def sample_long_stream(self, *, semantic_token_ids, total_frames: Optional[int] = None,
                           window_frames: int = 768, overlap_frames: int = 128, prompt=None,
                           steps: int = 3, cond_scale: float = 1.0,
                           decode_to_audio: bool = True, decode_ctx_frames: Optional[int] = None,
                           quantize: Optional[str] = None,
                           param_store_dtype: Optional[torch.dtype] = None,
                           generator: Optional[torch.Generator] = None):
        """`sample_long` as a stream: returns an iterator of audio (or latent)
        chunks, one as each window is sampled, so playback starts after one
        window. The arguments are checked here, at the call. Latent chunks
        concatenate to `sample_long(decode_to_audio=False)` under the same
        generator. With decoding, each drain decodes the buffered latents
        with `decode_ctx_frames` (default `overlap_frames`) frames of
        already-emitted left context and a right guard of as many frames not
        yet emitted, and yields only the new samples; the last drain yields
        the rest."""
        total = self._long_total_frames(torch.as_tensor(semantic_token_ids).shape[1],
                                        total_frames)
        self._validate_long_args(total, window_frames, overlap_frames)
        ctx = overlap_frames if decode_ctx_frames is None else decode_ctx_frames
        if ctx < 0:
            raise ValueError(f"decode_ctx_frames must be >= 0, got {ctx}")
        chunks = self._sample_long_chunks(
            semantic_token_ids=semantic_token_ids, total_frames=total,
            window_frames=window_frames, overlap_frames=overlap_frames, prompt=prompt,
            steps=steps, cond_scale=cond_scale, quantize=quantize,
            param_store_dtype=param_store_dtype, generator=generator)
        return self._stream_decode(chunks, self.audio_enc_dec, decode_to_audio, ctx)

    @staticmethod
    def _stream_decode(chunks, codec, decode_to_audio: bool, ctx: int):
        """Decode latent chunks as they come: the buffer holds frames
        [next to emit - left, received); a drain decodes it and emits the
        samples of frames [left, n - ctx) (all of them on the last drain),
        then keeps `ctx` frames of left context."""
        if not decode_to_audio or codec is None:
            yield from chunks
            return
        spf = codec.downsample_factor
        buf, left = None, 0

        def drain(final: bool):
            nonlocal buf, left
            n = buf.shape[1]
            emit_hi = n if final else n - ctx
            if emit_hi <= left:
                return None
            with torch.no_grad():
                audio = codec.decode(buf)
            out = audio[..., left * spf: emit_hi * spf].contiguous()
            keep_from = max(emit_hi - ctx, 0)
            left = emit_hi - keep_from
            buf = buf[:, keep_from:]
            return out

        for chunk in chunks:
            buf = chunk if buf is None else torch.cat([buf, chunk], dim=1)
            out = drain(final=False)
            if out is not None:
                yield out
        out = drain(final=True)
        if out is not None:
            yield out

    def _sample_long_chunks(self, *, semantic_token_ids, total_frames, window_frames,
                            overlap_frames, prompt, steps, cond_scale, quantize,
                            param_store_dtype, generator):
        """The window loop of `sample_long` / `sample_long_stream`: yields
        each window's newly final latent frames (the first window's
        `window_frames`, then a hop of window - overlap each; together the
        (b, total_frames, d) stream) as fp32 device tensors. A frame is final
        once its window is sampled: the next window keeps its overlap as it
        is."""
        device = next(self.voicebox.parameters()).device
        ids = torch.as_tensor(semantic_token_ids).to(device).long()
        b, n_ids = ids.shape
        total_frames = self._long_total_frames(n_ids, total_frames)
        self._validate_long_args(total_frames, window_frames, overlap_frames)
        codec = self.audio_enc_dec
        dim = self.voicebox.latent_dim
        if prompt is not None:
            prompt = torch.as_tensor(prompt, device=device)
            if is_probably_audio_from_shape(prompt):
                if codec is None:
                    raise ValueError("a raw-audio prompt needs an audio_enc_dec to encode it")
                with torch.no_grad():
                    prompt = codec.encode(prompt)
            if prompt.shape[1] > window_frames - 1:
                raise ValueError(f"prompt of {prompt.shape[1]} frames is longer than a window "
                                 f"less one ({window_frames - 1}): raise window_frames")
            prompt = prompt.float()
        if generator is not None and generator.device.type != "cpu":
            # one read of the card's generator; each window's seed is then a
            # host draw, so the window loop never waits for the device
            generator = split_generator(generator, "cpu")

        # ids at the latent frame rate (nearest neighbour), the tail window
        # padded with the last id
        idx = torch.clamp(torch.arange(total_frames) * n_ids // total_frames, max=n_ids - 1)
        frame_ids = ids[:, idx.to(device)]
        hop = window_frames - overlap_frames
        n_windows = 1 + max(0, -(-(total_frames - window_frames) // hop))
        padded_total = window_frames + (n_windows - 1) * hop
        if padded_total > total_frames:
            frame_ids = torch.cat(
                [frame_ids, frame_ids[:, -1:].expand(b, padded_total - total_frames)], dim=1)

        latents = torch.zeros(b, padded_total, dim, device=device)
        arange_w = torch.arange(window_frames, device=device)
        no_keep = torch.zeros(window_frames, dtype=torch.bool, device=device)
        done = 0  # frames yielded so far
        for w in range(n_windows):
            start = w * hop
            cond_w = torch.zeros(b, window_frames, dim, device=device)
            keep = no_keep
            if w == 0:
                if prompt is not None:
                    p_len = prompt.shape[1]
                    cond_w[:, :p_len] = prompt
                    keep = arange_w < p_len
            else:
                cond_w[:, :overlap_frames] = latents[:, start:start + overlap_frames]
                keep = arange_w < overlap_frames
            sub = None if generator is None else split_generator(generator, device)
            out_w = self.sample(
                cond=cond_w, semantic_token_ids=frame_ids[:, start:start + window_frames],
                ids_at_frame_rate=True, cond_mask=(~keep).expand(b, window_frames),
                steps=steps, cond_scale=cond_scale, decode_to_audio=False, quantize=quantize,
                param_store_dtype=param_store_dtype, generator=sub,
            ).float()
            # the kept span stays as committed (the prompt, or the overlap)
            committed = cond_w if w == 0 else latents[:, start:start + window_frames]
            latents[:, start:start + window_frames] = torch.where(keep[None, :, None],
                                                                  committed, out_w)
            fin = min(start + window_frames, total_frames)
            if fin > done:
                yield latents[:, done:fin].clone()
                done = fin
