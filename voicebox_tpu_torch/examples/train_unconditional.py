"""Train an unconditional VoiceBox on latents (the reference README's
unconditional training flow, README.md:102-137), on one card: bf16 compute
over fp32 parameters, AdamW under warmup -> cosine, then one sample.
Counterpart of `examples/train_unconditional.py`.

    python3 -m voicebox_tpu_torch.examples.train_unconditional [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

SEQ_LEN, LATENT_DIM = 256, 512


def build_trainer(device="cuda"):
    from ..models.cfm import ConditionalFlowMatcherWrapper, resolve_device
    from ..models.voicebox import VoiceBox
    from ..training.data import ArrayDataset
    from ..training.trainer import VoiceBoxTrainer

    device = resolve_device(device)
    torch.manual_seed(0)
    model = VoiceBox(dim_in=LATENT_DIM, dim=512, depth=8, condition_on_text=False,
                     dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
                     param_dtype=torch.float32)
    cfm_wrapper = ConditionalFlowMatcherWrapper(model, device=device)
    # a mock latent dataset (swap for MelVoco / EncodecVoco-encoded audio, or
    # train on waves: training.data.AudioDataset and a codec on the VoiceBox)
    rs = np.random.RandomState(0)
    dataset = ArrayDataset([rs.randn(SEQ_LEN, LATENT_DIM).astype(np.float32)
                            for _ in range(256)])
    return VoiceBoxTrainer(
        cfm_wrapper, batch_size=8, dataset=dataset, num_train_steps=200,
        num_warmup_steps=20, lr=3e-4, results_folder="./results/unconditional",
        bucket_multiple=SEQ_LEN, device=device,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    trainer = build_trainer(args.device)
    trainer.train()
    sampled = trainer.generate(cond=torch.zeros(1, SEQ_LEN, LATENT_DIM, device=trainer.device),
                               steps=3)
    print("sampled latents:", tuple(sampled.shape))


if __name__ == "__main__":
    main()
