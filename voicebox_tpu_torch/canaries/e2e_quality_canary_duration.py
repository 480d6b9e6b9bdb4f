"""End-to-end quality canary for the duration-predictor pipeline.

The port's copy of `benchmarks/e2e_quality_canary_duration.py`, the sibling
of `e2e_quality_canary.py` for BASELINE config 4's conditioning branch:

    text -> grapheme ids -> DurationPredictor (trained with the NS2 aligner,
    MAS durations and the forward-sum loss) -> per-phoneme durations ->
    aligned ids at the frame rate -> CFM denoiser -> log-mel latents

on the same four melodies, sampled from text alone through
`sample(texts=, frame_length=)`, the serving entry point, and scored by
mel-spectral distance beside the untrained and cross-utterance anchors.

Run on the card: `python3 -m
voicebox_tpu_torch.canaries.e2e_quality_canary_duration` (`--device cpu`
for the CPU).
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np
import torch

from ..models.cfm import ConditionalFlowMatcherWrapper, resolve_device
from ..models.duration import DurationPredictor
from ..utils.tokenizer import GraphemeTokenizer
from .e2e_quality_canary import (
    SAMPLE_SEED,
    TEXTS,
    _denoiser,
    cross_utterance,
    log_mel_latents,
    mel_msd,
    seeded,
    synth,
    train_steps,
    untrained_cfm,
)

__all__ = ["build_and_train_duration", "duration_predictor", "main", "sample_from_text_duration",
           "train_duration_pipeline"]


def duration_predictor(tok, n_mels: int, seed: int) -> DurationPredictor:
    """The canary's predictor. The corpus mel is both the aligner's input
    and the conditioning latents; the codec is a stub that gives only its
    latent width."""
    return seeded(lambda: DurationPredictor(
        tokenizer=tok, dim=64, depth=2, dim_phoneme_emb=64, dim_head=16, heads=4,
        aligner_dim_in=n_mels, aligner_attn_channels=n_mels,
        audio_enc_dec=SimpleNamespace(latent_dim=n_mels),
    ), seed)


def train_duration_pipeline(texts, gt, dp_steps: int, cfm_steps: int, seed: int, device,
                            verbose=print) -> dict:
    """Train a DurationPredictor on (texts, gt latents), then a CFM on the
    trained predictor's aligned ids (the conditioning stream that sampling
    will produce). Returns the pipeline dict."""
    b, n_frames, n_mels = gt.shape
    tok = GraphemeTokenizer()
    phoneme_ids = torch.from_numpy(tok.texts_to_tensor_ids(texts)).to(device).long()
    dp = duration_predictor(tok, n_mels, seed).to(device)
    ph_mask = phoneme_ids != -1
    mel_mask = torch.ones(b, n_frames, dtype=torch.bool, device=device)
    ph_len = ph_mask.sum(-1)
    mel_len = torch.full((b,), n_frames, dtype=torch.long, device=device)
    gen = torch.Generator(device).manual_seed(seed + 1)
    dl, _, dp_s = train_steps(
        lambda: dp.loss_fn(cond=gt, phoneme_ids=phoneme_ids, mel=gt, phoneme_len=ph_len,
                           mel_len=mel_len, phoneme_mask=ph_mask, mel_mask=mel_mask,
                           generator=gen),
        dp.parameters(), 2e-3, dp_steps, device)
    verbose(f"duration-predictor loss after {dp_steps} steps: {dl:.4f} "
            f"({dp_steps / dp_s:.1f} steps/s)")

    _, aligned = dp.forward_with_cond_scale(cond=None, phoneme_ids=phoneme_ids,
                                            return_aligned_phoneme_ids=True,
                                            total_length=n_frames)
    verbose(f"aligned ids: {tuple(aligned.shape)}, {len(torch.unique(aligned))} distinct")

    vb = _denoiser(n_mels, tok.vocab_size, seed + 2)
    cfm = ConditionalFlowMatcherWrapper(vb, duration_predictor=dp, cond_drop_prob=0.1,
                                        device=device)
    gen = torch.Generator(device).manual_seed(seed + 3)
    cl, _, cfm_s = train_steps(
        lambda: cfm.loss_fn(gt, cond_token_ids=aligned, generator=gen), vb.parameters(), 1e-3,
        cfm_steps, device)
    verbose(f"cfm loss after {cfm_steps} steps: {cl:.4f} ({cfm_steps / cfm_s:.1f} steps/s)")
    return {"cfm": cfm, "dp": dp, "tok": tok, "n_frames": n_frames, "n_mels": n_mels,
            "device": device, "train": {"dp": (dp_steps, dp_s, dl), "cfm": (cfm_steps, cfm_s, cl)}}


def build_and_train_duration(dp_steps: int = 400, cfm_steps: int = 2000, seed: int = 0,
                             device="cuda", verbose=print):
    """Returns (pipeline dict, gt latents): a trained DurationPredictor and
    CFM on the four melodies."""
    device = resolve_device(device)
    wav24 = np.stack([synth(t, 24000) for t in TEXTS])
    gt = log_mel_latents(torch.from_numpy(wav24).to(device))  # (4, frames, 40)
    return train_duration_pipeline(TEXTS, gt, dp_steps, cfm_steps, seed, device, verbose), gt


def sample_from_text_duration(pipe, cfm=None, texts=TEXTS, steps: int = 16,
                              cond_scale: float = 1.0, generator=None, quantize=None):
    """TEXT -> log-mel latents through `sample(texts=, frame_length=)`
    (predicted durations -> aligned ids -> ODE), one batched call: the
    serving path itself. `cfm` replaces the pipeline's denoiser."""
    cfm = cfm if cfm is not None else pipe["cfm"]
    if generator is None:
        generator = torch.Generator(pipe["device"]).manual_seed(SAMPLE_SEED)
    return cfm.sample(texts=list(texts), frame_length=pipe["n_frames"], steps=steps,
                      cond_scale=cond_scale, decode_to_audio=False, generator=generator,
                      quantize=quantize)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    pipe, gt = build_and_train_duration(device=args.device)
    msd = mel_msd(sample_from_text_duration(pipe), gt)
    msd0 = mel_msd(sample_from_text_duration(pipe, cfm=untrained_cfm(pipe)), gt)
    cross = cross_utterance(gt)
    print(f"mel-spectral distance, trained duration pipeline (text->durations->speech): "
          f"{msd:.2f} dB/frame")
    print(f"  untrained anchor: {msd0:.2f}   cross-utterance anchor: {cross:.2f}")
    result = {"metric": "e2e_mel_spectral_distance_duration", "value": msd,
              "unit": "dB L2/frame", "untrained": msd0, "cross_utterance": cross,
              "device": str(pipe["device"])}
    print(result)
    return result


if __name__ == "__main__":
    main()
