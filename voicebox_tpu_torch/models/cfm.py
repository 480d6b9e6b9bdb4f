"""Conditional flow matching wrapper: the training loss and the sampler.

Counterpart of `voicebox_tpu/models/cfm.py::ConditionalFlowMatcherWrapper`
on latents, with precomputed semantic (or phoneme) token ids:

* `loss_fn` / calling the wrapper: the CFM objective, x0 ~ N(0, I) and
  t ~ U(0, 1) per sample, w = (1 - (1 - sigma) t) x0 + t x1, flow =
  x1 - (1 - sigma) x0, and the VoiceBox masked MSE of its prediction at w
  against flow, with the random span and CFG masks. Every random draw comes
  from `generator=` or is passed in (`noise=`, `times=`, `cond_mask=`,
  `cond_drop_mask=`);
* `sample`: a fixed-grid midpoint ODE from noise y0 over the VoiceBox vector
  field, classifier-free guidance as ONE forward at batch 2b
  (`null + (cond - null) * cond_scale`), then the codec's decode
  (RVQ -> Vocos -> iSTFT) in the same call. y0 comes from `noise=` or from
  `generator=`.

The wrapper is an nn.Module holding `voicebox` and the frozen codec, and it
moves both to `device` when it is built: the card unless the caller asks for
the CPU. Not ported yet: raw audio in (the SEANet encoder), the text /
TextToSemantic / duration branches, Tsit5, quantized serving, long-form
sampling.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.interp import curtail_or_pad
from ..ops.masks import normal, uniform
from ..ops.ode import cfm_interpolant, odeint
from .voicebox import VoiceBox

__all__ = ["ConditionalFlowMatcherWrapper", "is_probably_audio_from_shape", "resolve_device"]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. "cuda" (the default of every entry
    point) needs a card and raises without one: the port never falls back to
    the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on an NVIDIA GPU by default; pass "
            "device='cpu' to run on the CPU"
        )
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
        device="cuda",
    ):
        super().__init__()
        if text_to_semantic is not None or duration_predictor is not None:
            raise NotImplementedError(
                "TextToSemantic and DurationPredictor front ends are not ported "
                "yet (ROADMAP Queue 1: item 10 the duration branch, item 11 the "
                "semantic stack); pass semantic_token_ids to sample()"
            )
        self.voicebox = voicebox
        self.codec = voicebox.audio_enc_dec  # registered: moves with .to()
        self.sigma = sigma
        self.ode_method = ode_method
        self.cond_drop_prob = cond_drop_prob
        self.condition_on_text = voicebox.condition_on_text
        self.to(resolve_device(device))

    @property
    def audio_enc_dec(self):
        return self.voicebox.audio_enc_dec

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
        **randomness,
    ) -> torch.Tensor:
        """`wrapper(x1, ...)`: the CFM training loss on latents (b, n, d),
        conditioned on semantic or phoneme ids. `randomness` is `generator=`
        or the draws themselves, as `loss_fn` takes them."""
        if is_probably_audio_from_shape(x1) or is_probably_audio_from_shape(cond):
            raise NotImplementedError(
                "training on raw audio needs the codec's encoder (SEANet), not "
                "ported yet (ROADMAP Queue 1, item 9); pass latents (b, n, latent_dim)"
            )
        if self.condition_on_text and (semantic_token_ids is None) == (phoneme_ids is None):
            raise ValueError(
                "pass one of semantic_token_ids or phoneme_ids (the text front ends "
                "are not ported yet)"
            )
        if not self.condition_on_text and (semantic_token_ids is not None
                                           or phoneme_ids is not None):
            raise ValueError(
                "semantic or phoneme ids should not be passed in if not conditioning on text"
            )
        cond_token_ids = semantic_token_ids if phoneme_ids is None else phoneme_ids
        return self.loss_fn(x1, mask=mask, cond_token_ids=cond_token_ids, cond=cond,
                            cond_mask=cond_mask, **randomness)

    def _vector_field(self, t, x, cond, cond_token_ids, cond_scale):
        b = x.shape[0]
        if cond_scale == 1.0:
            drop = torch.zeros(b, dtype=torch.bool, device=x.device)
            out = self.voicebox(x, times=t, cond=cond, cond_token_ids=cond_token_ids,
                                cond_drop_mask=drop)
            return out.to(x.dtype)
        # CFG: the conditioned half and the null half as one 2b forward
        ids2 = None if cond_token_ids is None else torch.cat([cond_token_ids] * 2)
        drop2 = torch.arange(2 * b, device=x.device) >= b
        out2 = self.voicebox(
            torch.cat([x, x]), times=t.reshape(1).expand(2 * b),
            cond=torch.cat([cond, cond]), cond_token_ids=ids2, cond_drop_mask=drop2,
        ).to(x.dtype)
        logits, null_logits = out2[:b], out2[b:]
        return null_logits + (logits - null_logits) * cond_scale

    @torch.no_grad()
    def sample(
        self,
        *,
        cond: Optional[torch.Tensor] = None,
        texts=None,
        text_token_ids=None,
        semantic_token_ids: Optional[torch.Tensor] = None,
        phoneme_ids=None,
        steps: int = 3,
        cond_scale: float = 1.0,
        decode_to_audio: bool = True,
        return_lengths: bool = False,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Sample latents by integrating the ODE from y0, then decode them to
        audio `(b, 1, n * downsample_factor)` when a codec is attached and
        `decode_to_audio`. y0 is `noise` if given, else a standard normal
        draw from `generator`. With `return_lengths` also returns per-sample
        valid lengths (samples of audio, or frames of latents)."""
        if texts is not None or text_token_ids is not None or phoneme_ids is not None:
            raise NotImplementedError(
                "sampling from text or phonemes needs the TextToSemantic or "
                "duration front end, not ported yet (ROADMAP Queue 1, items 10 "
                "and 11); pass semantic_token_ids"
            )
        codec = self.audio_enc_dec
        vb = self.voicebox
        device = next(vb.parameters()).device
        if cond is not None:
            cond = torch.as_tensor(cond, device=device)
            if is_probably_audio_from_shape(cond):
                raise NotImplementedError(
                    "cond as raw audio needs the codec's encoder (SEANet), not "
                    "ported yet (ROADMAP Queue 1, item 9); pass cond latents "
                    "(b, n, latent_dim)"
                )

        cond_token_ids = None
        if self.condition_on_text:
            assert semantic_token_ids is not None, (
                "semantic_token_ids required (the text front ends are not ported yet)"
            )
            cond_token_ids = torch.as_tensor(semantic_token_ids, device=device)
            n_frames = cond_token_ids.shape[-1]
            if cond is not None:
                cond = curtail_or_pad(cond, n_frames)
            else:
                cond = torch.zeros(cond_token_ids.shape[0], n_frames, vb.latent_dim,
                                   device=device)
        else:
            assert semantic_token_ids is None, (
                "no conditioning ids should be given if not conditioning on text"
            )
            assert cond is not None, "cond latents required to sample"

        if noise is not None:
            y0 = torch.as_tensor(noise, device=device, dtype=cond.dtype)
            assert y0.shape == cond.shape, f"noise {tuple(y0.shape)} != cond {tuple(cond.shape)}"
        else:
            y0 = normal(cond.shape, generator, device, cond.dtype)

        times = torch.linspace(0.0, 1.0, steps, device=device)
        latents, _ = odeint(
            lambda t, x: self._vector_field(t, x, cond, cond_token_ids, cond_scale),
            y0, times, method=self.ode_method,
        )

        out_is_audio = decode_to_audio and codec is not None
        out = codec.decode(latents) if out_is_audio else latents
        if not return_lengths:
            return out
        frames = torch.full((out.shape[0],), cond.shape[1], dtype=torch.int32, device=device)
        if out_is_audio:
            return out, frames * codec.downsample_factor
        return out, frames
