"""Resume a reference (lucidrains/voicebox-pytorch) training run mid-stream:
the weights, AdamW's moments and the step count all load, so the loss curve
continues instead of the optimizer starting cold.

The reference trainer saves `results/voicebox.{steps}.pt` (reference
trainer.py:191-197) holding `model` and `optim` state dicts; the port's
`VoiceBoxTrainer.load_torch` reads that file (it is the layout the port's
own `save` writes), restores the moments and puts the warmup -> cosine
schedule at the loaded step. Counterpart of
`examples/resume_from_reference.py`.

    python3 -m voicebox_tpu_torch.examples.resume_from_reference \\
        path/to/voicebox.40000.pt [--device cpu]

The frozen `audio_enc_dec.*` codec weights inside a checkpoint are not the
denoiser's; load the codec through its own loader.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

SEQ_LEN, LATENT_DIM = 512, 512


def build_trainer(device="cuda"):
    """The reference run's architecture (its defaults: dim 1024, depth 24,
    16 x 64 heads, 16 registers, qk-norm, 500 semantic ids) and
    hyperparameters, on a mock latent dataset."""
    from ..models.cfm import ConditionalFlowMatcherWrapper, resolve_device
    from ..models.voicebox import VoiceBox
    from ..training.data import ArrayDataset
    from ..training.trainer import VoiceBoxTrainer

    device = resolve_device(device)
    torch.manual_seed(0)
    model = VoiceBox(
        dim_in=LATENT_DIM, dim=1024, depth=24, dim_head=64, heads=16, num_register_tokens=16,
        attn_qk_norm=True, condition_on_text=True, num_cond_tokens=500,
        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
        param_dtype=torch.float32,
    )
    cfm_wrapper = ConditionalFlowMatcherWrapper(model, cond_drop_prob=0.2, device=device)
    # swap for the corpus the reference run was training on: (latents,
    # frame-aligned ids) pairs here, since the model conditions on ids
    rs = np.random.RandomState(0)
    dataset = ArrayDataset([(rs.randn(SEQ_LEN, LATENT_DIM).astype(np.float32),
                             rs.randint(0, 500, SEQ_LEN)) for _ in range(64)])
    return VoiceBoxTrainer(
        cfm_wrapper, batch_size=8, dataset=dataset, num_train_steps=50_000,
        num_warmup_steps=5_000, lr=3e-4, valid_frac=0.125, results_folder="./results/resumed",
        bucket_multiple=SEQ_LEN, device=device,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", nargs="?", default="results/voicebox.40000.pt")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=None,
                    help="train this many steps past the checkpoint (default: to 50 000)")
    args = ap.parse_args(argv)
    trainer = build_trainer(args.device)
    trainer.load_torch(args.checkpoint)
    print(f"resumed at step {trainer.steps} (Adam moments and the learning-rate schedule "
          f"restored, not a cold restart)")
    if args.steps is not None:
        trainer.num_train_steps = trainer.steps + args.steps
    trainer.train()


if __name__ == "__main__":
    main()
