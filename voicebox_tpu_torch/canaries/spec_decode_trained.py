"""Speculative decoding on trained weights.

The port's copy of `benchmarks/spec_decode_trained.py`. It overfits the
full-width TextToSemantic (dim 512, 6 + 6 layers, 8 x 64 heads, fp32, 500
semantic ids, the JAX package's defaults) on a deterministic text ->
semantic mapping, then decodes a text plainly (greedy) and speculatively
(gamma 5, the first half of the decoder drafting): pattern accuracy, the
emitted length (the decode ends at eos), whether speculation equals greedy
token for token, wall time of each behind a warm-up, and the acceptance
share; then the same greedy decode under `quantize="w8a16"` (fp32 K4 on
every decoder matmul): its agreement with the float decode, pattern
accuracy and time.

Run on the card: `python3 -m voicebox_tpu_torch.canaries.spec_decode_trained`.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models.cfm import resolve_device
from ..models.text_to_semantic import TextToSemantic
from ..utils.tokenizer import GraphemeTokenizer
from .e2e_quality_canary import seeded, sync_device, train_steps

__all__ = ["GAMMA", "MAX_LENGTH", "SEM_VOCAB", "TARGET_LEN", "decode_report", "main",
           "make_data", "train"]

SEM_VOCAB = 500
TARGET_LEN = 200
N_VARIANTS = 8
MAX_LENGTH = 256
GAMMA = 5
FULL_WIDTH = dict(dim=512, source_depth=6, target_depth=6, heads=8, dim_head=64)


def make_data(tok):
    """(text ids (8, 16), semantic ids (8, 200)) numpy: random 16-character
    texts and a deterministic id pattern keyed off each text's index."""
    rs = np.random.RandomState(0)
    texts = [
        "".join(rs.choice(list("abcdefghijklmnopqrstuvwxyz "), 16))
        for _ in range(N_VARIANTS)
    ]
    text_ids = tok.texts_to_tensor_ids(texts)
    sem = np.stack(
        [(7 * v + 3 * np.arange(TARGET_LEN)) % (SEM_VOCAB - 1) for v in range(N_VARIANTS)]
    ).astype(np.int32)
    return text_ids, sem


def train(device="cuda", steps: int = 4000, seed: int = 0, verbose=print):
    """The full-width TextToSemantic trained with Adam 3e-4 on `make_data`,
    the loss read every 250 steps and training stopped once it is under
    5e-3. Returns (t2s, text ids, semantic ids, {loss, steps, seconds})."""
    device = resolve_device(device)
    tok = GraphemeTokenizer()
    text_np, sem_np = make_data(tok)
    text_ids = torch.from_numpy(text_np).to(device).long()
    sem_ids = torch.from_numpy(sem_np).to(device).long()
    t2s = seeded(lambda: TextToSemantic(tokenizer=tok, num_semantic_token_ids=SEM_VOCAB,
                                        device=device, **FULL_WIDTH), seed)
    loss, taken, seconds = train_steps(lambda: t2s.loss_fn(text_ids, sem_ids), t2s.parameters(),
                                       3e-4, steps, device, stop_below=5e-3, check_every=250,
                                       verbose=verbose)
    verbose(f"trained to loss {loss:.4f} in {taken} steps, {seconds:.0f} s")
    return t2s, text_ids, sem_ids, {"loss": loss, "steps": taken, "seconds": seconds}


def decode_report(t2s, text_ids, sem_ids, reps: int = 24, warm_variants: int = 4) -> dict:
    """Greedy, speculative and w8a16 decodes of the first text on the
    trained weights, and their times (mean over `reps` decodes cycling over
    `warm_variants` texts, each decoded once before timing)."""
    device = text_ids.device
    one = text_ids[:1]
    tok_g, mask_g = t2s.generate(one, max_length=MAX_LENGTH, return_target_mask=True)
    tok_s, mask_s = t2s.generate(one, max_length=MAX_LENGTH, return_target_mask=True,
                                 spec_decode=True, spec_decode_gamma=GAMMA)
    stats = dict(t2s.decode_stats)
    tok_q, mask_q = t2s.generate(one, max_length=MAX_LENGTH, return_target_mask=True,
                                 quantize="w8a16")
    target = sem_ids[0]
    report = {
        "pattern_accuracy": float((tok_g[0, :TARGET_LEN] == target).float().mean()),
        "emitted": int(mask_g.sum()),
        "spec_equals_greedy": bool(torch.equal(tok_g, tok_s) and torch.equal(mask_g, mask_s)),
        "acceptance": stats["accepted"] / max(stats["rounds"] * GAMMA, 1),
        "rounds": stats["rounds"],
        "w8a16_agreement": float((tok_q == tok_g).float().mean()),
        "w8a16_mask_equal": bool(torch.equal(mask_q, mask_g)),
        "w8a16_pattern_accuracy": float((tok_q[0, :TARGET_LEN] == target).float().mean()),
        "w8a16_emitted": int(mask_q.sum()),
    }
    variants = [text_ids[i:i + 1] for i in range(warm_variants)]

    def bench(**kw):
        for v in variants:  # warm every variant
            t2s.generate(v, max_length=MAX_LENGTH, **kw)
        sync_device(device)
        t0 = time.perf_counter()
        positions = 0
        for i in range(reps):
            t2s.generate(variants[i % len(variants)], max_length=MAX_LENGTH, **kw)
            positions += t2s.decode_stats["positions"]
        sync_device(device)
        dt = (time.perf_counter() - t0) * 1e3
        return dt / reps, dt / positions

    (report["greedy_ms"], report["greedy_ms_per_token"]) = bench()
    (report["spec_ms"], report["spec_ms_per_token"]) = bench(spec_decode=True,
                                                             spec_decode_gamma=GAMMA)
    (report["w8a16_ms"], report["w8a16_ms_per_token"]) = bench(quantize="w8a16")
    report["speedup"] = report["greedy_ms"] / report["spec_ms"]
    report["timed"] = f"host clock, mean of {reps} decodes over {warm_variants} warmed texts"
    return report


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    t2s, text_ids, sem_ids, trained = train(args.device)
    result = {"metric": "spec_decode_trained_speedup", **decode_report(t2s, text_ids, sem_ids),
              "final_loss": trained["loss"], "train_steps": trained["steps"], "gamma": GAMMA,
              "device": str(text_ids.device)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
