"""LoRA voice adaptation: fine-tune rank-r adapters on a frozen base
VoiceBox, then fold them into plain weights for serving without overhead.
Counterpart of `examples/lora_finetune.py`, on one card: bf16 compute over
fp32 weights, Adam on the adapters only.

    python3 -m voicebox_tpu_torch.examples.lora_finetune [--device cpu] [--steps 50]
"""

from __future__ import annotations

import argparse

import torch

LATENT_DIM, SEQ_LEN, BATCH = 64, 128, 4


def main(argv=None):
    from ..models.cfm import ConditionalFlowMatcherWrapper, resolve_device
    from ..models.voicebox import VoiceBox
    from ..ops.lora import (fold_lora, lora_dense, lora_init, lora_parameters, lora_scale,
                            merge_lora_params)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.manual_seed(0)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = VoiceBox(dim_in=LATENT_DIM, dim=256, depth=4, condition_on_text=False, dtype=dtype,
                     param_dtype=torch.float32)
    cfm = ConditionalFlowMatcherWrapper(model, device=device)
    # in practice: cfm.load_torch(...) a trained checkpoint, from this package,
    # the JAX package or the reference build

    rank, alpha = 8, 16
    scale = lora_scale(alpha, rank)
    gen = torch.Generator(device=device).manual_seed(1)
    lora = lora_init(model, rank=rank, generator=gen)
    n_lora = sum(p.numel() for p in lora_parameters(lora))
    n_base = sum(p.numel() for p in model.parameters())
    print(f"trainable adapter params: {n_lora:,} ({100 * n_lora / n_base:.1f}% of base)")

    # the new voice's dataset (latents); a random stand-in here
    voice = torch.randn(BATCH, SEQ_LEN, LATENT_DIM, generator=gen, device=device) * 0.1
    merge_lora_params(model, lora)  # the base stays frozen
    opt = torch.optim.Adam(lora_parameters(lora), lr=1e-3)  # state for the adapters only
    for i in range(args.steps):
        with lora_dense(scale):
            loss = cfm.loss_fn(voice, generator=gen)
            loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        if i % 10 == 0:
            print(f"step {i:3d}  loss {loss.item():.4f}")

    # deployment: the adapters baked in, a plain module that composes with
    # sample(quantize=, param_store_dtype=) and TTSEngine
    served = ConditionalFlowMatcherWrapper(fold_lora(model, lora, scale), device=device)
    out = served.sample(cond=voice, steps=3, generator=gen, decode_to_audio=False)
    print("adapted sample:", tuple(out.shape))
    return out


if __name__ == "__main__":
    main()
