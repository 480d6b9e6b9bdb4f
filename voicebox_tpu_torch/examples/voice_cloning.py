"""Served in-context voice cloning, the Voicebox headline capability.

A 3 s voice prompt conditions the first infilling window (`cond_mask`
False over the prompt span), and the text's semantic ids continue from
there, so the speech carries the prompt's voice (paper section 3.2;
the reference's `sample(cond=prompt_audio, texts=...)`,
voicebox_pytorch.py:1175-1201). The raw prompt is zero-padded onto the
engine's `prompt_seconds_buckets`, so every prompt below 4 s runs the shapes
`warmup()` ran. The engine is `serve_http`'s at batch 1 and 256 semantic
ids. Counterpart of `examples/voice_cloning.py`.

    python3 -m voicebox_tpu_torch.examples.voice_cloning [--device cpu]

The weights are random: load trained checkpoints into the wrapper for
cloned speech.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    from .serve_http import build_engine

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    engine = build_engine(args.device, batch_buckets=(1,), max_semantic_token_ids=256)
    print(f"warmup (buckets + long-form + prompt grid): {engine.warmup():.1f}s")

    sr = engine.wrapper.voicebox.audio_enc_dec.sampling_rate
    t = np.arange(int(3.0 * sr))
    prompt = (0.2 * np.sin(2 * np.pi * 180.0 * t / sr)).astype(np.float32)[None]

    gen = torch.Generator(device=engine.device).manual_seed(2)
    wav = engine.clone("this sentence continues in the voice of the three second prompt",
                       prompt, generator=gen)
    print("cloned continuation:", tuple(wav.shape), f"({wav.shape[-1] / sr:.1f}s of audio)",
          "finite:", bool(torch.isfinite(wav).all()))

    gen = torch.Generator(device=engine.device).manual_seed(3)
    chunks = list(engine.clone_stream(
        "streaming variant: audio chunks arrive while later windows still sample, so "
        "playback starts after one window", prompt, generator=gen))
    print(f"streamed {len(chunks)} chunks,",
          f"{sum(c.shape[-1] for c in chunks) / sr:.1f}s total")


if __name__ == "__main__":
    main()
