"""The multi-chip dry run: one training step of every parallel layout, on
tiny shapes, over n ranks.

Counterpart of `__graft_entry__.py::dryrun_multichip`, at its shapes and in
its order:

1. one "fsdp+tp" `VoiceBoxTrainer` step (model 2 where n is even, "fsdp"
   alone otherwise) with gradient accumulation 2, AdamW and clipping at
   0.5, on the tiny text-conditioned VoiceBox (dim 64, depth 2, 4 x 16
   heads, 4 registers) at 32 frames;
2. one data-parallel step each of `TextToSemanticTrainer` and
   `DurationPredictorTrainer`, over a "data" mesh of every rank (the
   port's stage trainers take no "model" axis; JAX's replicate over it);
3. the sequence-parallel CFM loss and its gradients (summed over the
   ranks), the time axis split over all n ranks at 8 frames a shard, with
   a kernel-7 ConvPositionEmbed;
4. the pipeline's loss and gradients over n stages
   (`parallel/pipeline.py`): a Transformer of dim 32, depth 2n, 4 x 8
   heads, U-Net skips, 2 registers, adaptive RMSNorm and qk-norm, max(2, n)
   microbatches of 1 x 16.

Every loss and gradient must be finite. `dryrun_multichip(n)` spawns the n
ranks as processes of this module: with n cards, one process a card over
NCCL; with fewer, gloo ranks sharing cuda:0; with `device="cpu"`, gloo
ranks on the CPU. Run it as `python3 -m voicebox_tpu_torch.dryrun N
[--device cpu]`.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["dryrun_multichip"]

VB = dict(num_cond_tokens=50, dim_in=32, dim_cond_emb=32, dim=64, depth=2, dim_head=16, heads=4,
          num_register_tokens=4, condition_on_text=True)
ACCUM, FRAMES = 2, 32
SP_FRAMES = 8  # a shard: at least the kernel-7 conv's halo
PP = dict(dim=32, dim_head=8, heads=4, num_register_tokens=2, use_unet_skip_connection=True,
          adaptive_rmsnorm=True, adaptive_rmsnorm_cond_dim_in=16, attn_qk_norm=True)


def _finite(name: str, *tensors) -> None:
    for t in tensors:
        if t is not None and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"dry run: non-finite {name}")


def _seeded(build, seed: int):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def _rank(rank: int, world: int, init_file: str, out: str, placement: str) -> None:
    """One rank of the dry run; writes rank{r}.json."""
    import torch.distributed as dist

    from . import (ArrayDataset, ConditionalFlowMatcherWrapper, DurationPredictor,
                   DurationPredictorTrainer, TextToSemantic, TextToSemanticTrainer, VoiceBox,
                   VoiceBoxTrainer)
    from .models.transformer import Transformer
    from .parallel import make_pp_forward
    from .parallel.collectives import all_reduce
    from .parallel.distributed import maybe_initialize_distributed
    from .parallel.mesh import make_mesh
    from .parallel.sequence_parallel import make_sp_loss_fn
    from .training.data import PairedDataset

    device = {"cpu": "cpu", "shared": "cuda:0", "nccl": f"cuda:{rank}"}[placement]
    if placement != "cpu":
        torch.cuda.set_device(torch.device(device))
    backend = "nccl" if placement == "nccl" else "gloo"
    assert maybe_initialize_distributed(f"file://{init_file}", world, rank, backend=backend)
    dev_type = torch.device(device).type
    res, t0 = {"rank": rank}, time.perf_counter()

    # 1. "fsdp+tp": model 2 where the ranks pair up
    model = 2 if world % 2 == 0 and world > 1 else 1
    data_n = world // model
    mesh = make_mesh(model_parallel=model, device_type=dev_type)
    rs = np.random.RandomState(0)
    items = [(rs.randn(FRAMES, VB["dim_in"]).astype(np.float32), np.zeros(FRAMES, np.int32))
             for _ in range(4 * ACCUM * data_n)]
    cfm = _seeded(lambda: ConditionalFlowMatcherWrapper(VoiceBox(**VB), cond_drop_prob=0.2,
                                                        device=device), 1)
    trainer = VoiceBoxTrainer(
        cfm, batch_size=data_n, dataset=ArrayDataset(items), num_train_steps=1,
        grad_accum_every=ACCUM, lr=1e-4, wd=1e-4, max_grad_norm=0.5, valid_frac=0.0,
        bucket_multiple=4, mesh=mesh, param_sharding="fsdp+tp" if model > 1 else "fsdp",
        min_fsdp_size=1024, prefetch_batches=0, log_every=10, device=device)
    logs = trainer.train_step()
    _finite("fsdp+tp loss", logs["loss"])
    _finite("fsdp+tp parameters", *trainer.params)
    res["fsdp_tp"] = {"loss": float(logs["loss"]), "mesh": [data_n, model]}
    del trainer, cfm

    # 2. the two stage trainers, data-parallel over every rank
    rs = np.random.RandomState(2)
    batch = max(world, 2)
    pairs = [(rs.randint(0, 30, 8).astype(np.int32), rs.randint(0, 24, 12).astype(np.int64))
             for _ in range(4 * batch)]
    t2s = _seeded(lambda: TextToSemantic(dim=32, num_text_token_ids=30, num_semantic_token_ids=24,
                                         source_depth=2, target_depth=1, heads=2, dim_head=16,
                                         device=device), 5)
    stage_kw = dict(batch_size=batch, num_train_steps=1, valid_frac=0.0,
                    mesh=make_mesh(device_type=dev_type), prefetch_batches=0, device=device)
    t2s_tr = TextToSemanticTrainer(t2s, dataset=PairedDataset(pairs), text_bucket_multiple=8,
                                   semantic_bucket_multiple=8, **stage_kw)
    t2s_loss = t2s_tr.train_step()["loss"]
    _finite("TextToSemanticTrainer loss", t2s_loss)

    class _Latents:
        latent_dim = 12

    dp = _seeded(lambda: DurationPredictor(
        num_phoneme_tokens=40, dim_phoneme_emb=16, dim=32, depth=2, dim_head=8, heads=2,
        aligner_dim_in=12, aligner_attn_channels=12, audio_enc_dec=_Latents()), 6)
    items = [(rs.randint(0, 40, 6).astype(np.int32), rs.randn(16, 12).astype(np.float32))
             for _ in range(4 * batch)]
    dur_tr = DurationPredictorTrainer(dp, dataset=PairedDataset(items),
                                      phoneme_bucket_multiple=4, frame_bucket_multiple=8,
                                      **stage_kw)
    dur_loss = dur_tr.train_step()["loss"]
    _finite("DurationPredictorTrainer loss", dur_loss)
    res["stages"] = {"text_to_semantic_loss": float(t2s_loss),
                     "duration_loss": float(dur_loss)}
    del t2s_tr, dur_tr, t2s, dp

    # 3. sequence parallelism over every rank, 8 frames a shard
    group = dist.group.WORLD
    vb = _seeded(lambda: VoiceBox(**VB, conv_pos_embed_kernel_size=7), 2)
    cfm = ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2, device=device)
    loss_fn = make_sp_loss_fn(cfm, group)
    gen = torch.Generator(device=device).manual_seed(1)
    x1 = torch.randn(2, SP_FRAMES * world, VB["dim_in"], generator=gen, device=device)
    frames = slice(rank * SP_FRAMES, (rank + 1) * SP_FRAMES)
    loss = loss_fn(x1[:, frames], cond_token_ids=torch.zeros(2, 17, dtype=torch.long,
                                                             device=device),
                   generator=torch.Generator(device=device).manual_seed(3))
    loss.backward()
    grads = [all_reduce(p.grad, group) for p in vb.parameters() if p.grad is not None]
    _finite("sequence-parallel loss and gradients", loss, *grads)
    res["sp"] = {"loss": float(loss), "frames": SP_FRAMES * world,
                 "grad_norm": math.sqrt(sum(float(g.float().square().sum()) for g in grads))}
    del cfm, vb, grads

    # 4. the pipeline over every rank
    tr = _seeded(lambda: Transformer(depth=2 * world, **PP), 4)
    M = max(2, world)
    gen = torch.Generator().manual_seed(4)  # the same draws on every rank
    xs, conds = torch.randn(M, 1, 16, 32, generator=gen), torch.randn(M, 1, 16, generator=gen)
    masks = torch.ones(M, 1, 16, dtype=torch.bool)
    fn = make_pp_forward(tr, group, num_microbatches=M, device=device)
    loss = fn(xs, masks, conds).square().mean()
    loss.backward()  # every rank; rank 0's loss is the model's
    grads = [p.grad for p in tr.parameters() if p.grad is not None]
    _finite("pipeline loss and gradients", loss, *grads)
    res["pp"] = {"stages": world, "microbatches": M, "loss": float(loss),
                 "grads_held": len(grads)}
    res["rank_seconds"] = time.perf_counter() - t0
    dist.barrier()
    Path(out, f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout: float = 600.0) -> dict:
    """Run the dry run over `n_devices` ranks (module doc); returns rank 0's
    results (every loss, `"rank_seconds"` from its group's start to its
    end) with `"placement"` and `"seconds"`, the wall time of the whole run,
    the spawns included. Raises if a rank fails."""
    if device == "cpu":
        placement = "cpu"
    else:
        from .models.cfm import resolve_device

        resolve_device(device)  # "cuda" without a card raises here
        placement = "nccl" if torch.cuda.device_count() >= n_devices else "shared"
    t0 = time.perf_counter()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(Path(__file__).resolve().parents[1]),
                                           os.environ.get("PYTHONPATH", "")]))
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(Path(tmp, f"rank{r}.log"), "w") for r in range(n_devices)]
        procs = [subprocess.Popen([sys.executable, "-m", "voicebox_tpu_torch.dryrun", "--rank",
                                   str(r), str(n_devices), str(Path(tmp, "init")), tmp,
                                   placement], env=env, stdout=logs[r],
                                  stderr=subprocess.STDOUT)
                 for r in range(n_devices)]
        try:
            for p in procs:
                p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"dry run rank {r} exited {p.returncode}:\n"
                                   + Path(tmp, f"rank{r}.log").read_text()[-4000:])
        res = json.loads(Path(tmp, "rank0.json").read_text())
    res.update(placement=placement, seconds=time.perf_counter() - t0)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.n_devices, args.device)))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:  # one rank, spawned by dryrun_multichip
        torch.set_num_threads(1)
        _rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
        sys.exit(0)
    sys.exit(main())
