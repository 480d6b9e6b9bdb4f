"""Synthesis of any length with a voice prompt (`sample_long`).

The reference generates one fixed horizon per call, its memory and latency
growing with the utterance. Here Voicebox's infilling objective continues
in context: each window is conditioned on the previous window's tail, every
window has the same shapes, and memory stays that of one window. The
denoiser computes in bf16 on the card. Counterpart of
`examples/long_form_tts.py`.

    python3 -m voicebox_tpu_torch.examples.long_form_tts [--device cpu]
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    from ..models.cfm import ConditionalFlowMatcherWrapper, resolve_device
    from ..models.voicebox import VoiceBox

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.manual_seed(0)
    model = VoiceBox(
        num_cond_tokens=500, dim_in=128, dim_cond_emb=512, dim=512, depth=8, dim_head=128,
        heads=4, num_register_tokens=16, condition_on_text=True,
        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
    )
    cfm = ConditionalFlowMatcherWrapper(model, cond_drop_prob=0.2, device=device).eval()

    # semantic ids for ~40 s of audio at the Encodec frame rate (75 Hz); in
    # production they come from TextToSemantic.generate or a duration
    # pipeline, random here (untrained weights)
    gen = torch.Generator(device=device).manual_seed(1)
    total_frames = 3000
    ids = torch.randint(0, 500, (1, total_frames), generator=gen, device=device)
    # a 2 s voice prompt (latents; raw audio works too when a codec is attached)
    prompt = torch.randn(1, 150, 128, generator=gen, device=device) * 0.1

    latents = cfm.sample_long(
        semantic_token_ids=ids, total_frames=total_frames,
        window_frames=768,  # ~10 s windows
        overlap_frames=128,  # ~1.7 s of continuation context
        prompt=prompt, steps=3, cond_scale=1.3, generator=gen,
        decode_to_audio=False,  # attach EncodecVoco / MelVoco for waveforms
    )
    print("latents:", tuple(latents.shape), "finite:", bool(torch.isfinite(latents).all()))


if __name__ == "__main__":
    main()
