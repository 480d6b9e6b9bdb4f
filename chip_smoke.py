#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`voicebox_tpu_torch`) on one NVIDIA GPU.

Run it from the root of a checkout: `python3 chip_smoke.py`. It needs one
Hopper card (compute capability 9.x), nvcc and PyTorch built for CUDA; it
imports nothing of JAX. Its phases print one line each or more:

1. device: the card's name and power limit (nvidia-smi); TF32 off for
   matmuls and cuDNN;
2. build: K1 (`csrc/flash_attention_fwd.cu`), K2 + K3
   (`csrc/flash_attention_bwd.cu`) and K4 (`csrc/w8a16_matmul.cu`) built by
   nvcc for sm_90a from the checkout, all at once, with the build time and
   ptxas's registers and spills (K1's, K2's and K3's per instantiation);
   fails unless every bf16 instantiation of K1, K2 and K3 was compiled to
   wgmma (`HGMMA`) and TMA loads (`UTMALDG`), counted in `cuobjdump -sass`
   of the built library, and spills no byte;
3. K1 check: K1 against its plain PyTorch version on the card, at the
   serving and training shapes, at the quantized engine's denoiser and
   duration-predictor shapes, on masked and ragged inputs and at the edges
   of K1's design (kv off the 128-key tile and off 8, a kv that wraps the
   K/V ring many times, masked keys inside a tile, n under one 64-row
   tile), each case with its tolerance; CUDA-event times of K1, the plain
   version and SDPA; bf16 K1 at each tile height it can take (the host's
   choice marked); the host time of one bf16 K1 call, and what encoding its
   tensor maps adds to it;
4. K2/K3 check: K2 and K3 against the plain backward and against autograd
   of the plain forward, by the largest error and by the error's norm, at
   the training shape (bf16 qk-normed and randn, fp32), the reference head
   split, ragged n/kv, a fully-masked batch element under qk-norm's scale
   10, and the edges of the bf16 design at head dims 64 and 128 (kv off the
   64-row tile and off 8, n under one tile, n and kv of 4100 that wrap the
   ring many times, masked runs inside tiles); a second launch on the same
   inputs must give bit-identical dq, dk and dv; CUDA-event times of K2,
   K3, the plain backward and SDPA's backward (each of the two gives dq, dk
   and dv together) and attention forward + backward through K1/K2/K3
   beside SDPA's, at the training shape and the reference head split (bf16
   K2 and K3 have one tile height, 64 owned rows a block);
5. K4 check: K4 against its plain version at the flagship's four quantized
   (k, n) with the engine's m = 544, 2112 and 8320 rows and m = 1532, in
   bf16 and fp32, and at ragged m;
   CUDA-event times of K4, the plain version, cuBLAS on the weight
   dequantized to bf16 ahead of time and, where it runs on CUDA,
   `torch._weight_int8pack_mm`;
6. slice, card vs CPU: a small fp32 configuration sampled on the card (K1)
   and on the CPU (the plain version) from the same weights and noise;
   latents, RVQ codes and audio compared; then the same sampled with
   `quantize="w8a16"` (K4 on the card);
7. train, card vs CPU: the same small fp32 denoiser takes 3 optimizer steps
   through `VoiceBoxTrainer` on the card (K1/K2/K3) and on the CPU, from
   the same weights, batches, noise, times and masks; losses and every
   parameter compared;
8. serve: the flagship geometry in bf16 (dim 512, depth 24, 4 x 128 heads,
   EncodecVoco with RVQ 8 x 1024 x 128 and the vocos-encodec-24khz
   geometry) answers requests of 750 frames (10 s of 24 kHz audio) at
   batch 1 and 2; each must give finite (b, 1, 240000) audio through
   exactly depth x 4 = 96 K1 launches;
9. engine: quantized duration-mode serving at full width: the flagship
   denoiser (its cond tokens the phoneme vocabulary) with the reference
   DurationPredictor (dim 512, depth 10, 8 x 64 heads, fp32) behind
   `TTSEngine(quantize="w8a16")` (text buckets 32/64/128, batch buckets
   1/2/4, 8 frames per token, 3 steps, CFG 1.3): `warmup()`, five requests
   at batch 1 and five at batch 2, then three rounds of four concurrent
   `DynamicBatcher.submit`s. Each bucket group (one predictor forward, one
   sampling call) makes exactly 4 x 24 x 4 = 384 K4 and 96 + 10 = 106 K1
   launches and gives finite audio whose lengths are the masked duration
   sums x 320; the shapes of every K1 and K4 launch are tallied, and each
   must be one that phases 3 and 5 checked and timed; latency and RTF (min
   and median), the predictor's share and a profiled idle share; each
   attention and feed-forward module of the quantized denoiser on the
   input its bf16 counterpart saw, against bf16 and beside the floor of
   bf16 against fp32; one whole forward at qk gains 0.5, for information;
10. train: the flagship geometry trains at full width (bf16 compute, fp32
   parameters and AdamW, batch 8 x 752 frames + 16 registers) through
   `VoiceBoxTrainer`: 2 warm-up steps, then timed steps, each with exactly
   24 K1, 24 K2 and 24 K3 launches and a finite loss and gradient norm;
   steps/s, the profiled idle share of one step and peak memory;
11. witness: the flagship's gradient on the trained weights through
   K1/K2/K3 against the plain attention on the card, same batch and draws,
   in bf16 and fp32 compute, with unit qk gains and gains of 0.25, beside
   the noise floor of the plain version against itself;
12. one JSON line for the kernels (one row per kernel and main path; on the
   quantized path, means per launch over the shapes it ran), then
   the last line `{"ok": true, "device": {...}}`.

Any failed check raises, so the process exits nonzero and prints no result.
Weights are random, made from a seed.
"""

from __future__ import annotations

import collections
import contextlib
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

import voicebox_tpu_torch as vbt
from voicebox_tpu_torch import kernels
from voicebox_tpu_torch.models import attention as attention_module
from voicebox_tpu_torch.models.codec import EncodecVoco
from voicebox_tpu_torch.models.encodec import ResidualVQ
from voicebox_tpu_torch.models.primitives import l2norm
from voicebox_tpu_torch.models.vocos import Vocos
from voicebox_tpu_torch.ops.flash_attention import (
    _launch_k1,
    attention_delta,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    k1_block_q,
    reference_attention,
    reference_attention_backward,
)
from voicebox_tpu_torch.ops.quant import QuantLinear, w8a16_matmul, w8a16_matmul_reference
from voicebox_tpu_torch.utils.tokenizer import GraphemeTokenizer

SEED = 0
SOURCES = {"k1": "voicebox_tpu_torch/csrc/flash_attention_fwd.cu",
           "k2": "voicebox_tpu_torch/csrc/flash_attention_bwd.cu",
           "k3": "voicebox_tpu_torch/csrc/flash_attention_bwd.cu",
           "k4": "voicebox_tpu_torch/csrc/w8a16_matmul.cu"}
REPLACES = {"k1": "voicebox_tpu/ops/flash_attention.py:105",
            "k2": "voicebox_tpu/ops/flash_attention.py:166",
            "k3": "voicebox_tpu/ops/flash_attention.py:215",
            "k4": "voicebox_tpu/ops/quant.py:145"}
NAMES = {"k1": "flash_attention_fwd", "k2": "flash_attention_bwd_dq",
         "k3": "flash_attention_bwd_dkv", "k4": "w8a16_matmul"}
WRAPPERS = {"k1": flash_attention, "k2": flash_attention_bwd_dq, "k3": flash_attention_bwd_dkv,
            "k4": w8a16_matmul}

# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): the bound of a call
# is the larger of its operations over the peak and its bytes over HBM's rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12

# (name, (b, h, n, kv, d), dtype, inputs, mask, atol, rtol). "qk": q and k
# qk-normed to norm sqrt(d) with scale 10, as the denoiser calls attention
# (logits up to 10 d); "randn": unit normals with scale d^-0.5, a softer
# softmax. bf16 tolerance: P and out are each rounded to bf16 (2^-8
# relative) on both sides, in another order. fp32 tolerance: logits up to
# 1280 carry ~1e-4 of summation-order rounding, which moves exp() by as much
# relative.
K1_CASES = [
    ("flagship_cfg_bf16", (2, 4, 766, 766, 128), torch.bfloat16, "qk", None, 1e-2, 1e-2),
    ("reference_split_bf16", (2, 16, 1040, 1040, 64), torch.bfloat16, "qk", None, 1e-2, 1e-2),
    ("train_bf16", (8, 4, 768, 768, 128), torch.bfloat16, "qk", "all", 1e-2, 1e-2),
    ("flagship_cfg_f32", (2, 4, 766, 766, 128), torch.float32, "qk", None, 1e-3, 1e-3),
    ("reference_split_f32", (2, 16, 1040, 1040, 64), torch.float32, "qk", None, 1e-3, 1e-3),
    ("mask_empty_row_bf16", (3, 4, 300, 300, 128), torch.bfloat16, "randn", "empty_row", 1e-2, 1e-2),
    ("mask_empty_row_f32", (3, 4, 300, 300, 64), torch.float32, "randn", "empty_row", 1e-5, 1e-5),
    ("ragged_257_bf16", (2, 4, 257, 257, 64), torch.bfloat16, "randn", "random", 1e-2, 1e-2),
    ("ragged_257_f32", (2, 4, 257, 200, 128), torch.float32, "randn", "random", 1e-5, 1e-5),
    # the quantized engine's denoiser (phase 9): batch bucket x 2 for CFG,
    # frame bucket 256 / 512 / 1024 + 16 registers, no mask
    ("engine_b1_bf16", (2, 4, 272, 272, 128), torch.bfloat16, "qk", None, 1e-2, 1e-2),
    ("engine_b2_bf16", (4, 4, 528, 528, 128), torch.bfloat16, "qk", None, 1e-2, 1e-2),
    ("engine_b4_bf16", (8, 4, 1040, 1040, 128), torch.bfloat16, "qk", None, 1e-2, 1e-2),
    # the engine's duration predictor: fp32, 8 x 64 heads, n = the text
    # bucket, text padding masked (a batch bucket's padding rows fully)
    ("dp_b1_f32", (1, 8, 32, 32, 64), torch.float32, "qk", "random", 1e-3, 1e-3),
    ("dp_b2_f32", (2, 8, 64, 64, 64), torch.float32, "qk", "random", 1e-3, 1e-3),
    ("dp_b4_f32", (4, 8, 128, 128, 64), torch.float32, "qk", "empty_row", 1e-3, 1e-3),
    # the edges of K1's design: kv off the 128-key tile and off 8 (TMA's zero
    # fill, a random mask); a kv that wraps the 2-stage K/V ring 17 times;
    # masked keys inside tiles under the two-warpgroup tile; n under one
    # 64-row tile
    ("ragged_tma_bf16", (2, 4, 257, 131, 128), torch.bfloat16, "randn", "random", 1e-2, 1e-2),
    ("long_kv_bf16", (1, 4, 4100, 4100, 128), torch.bfloat16, "qk", None, 1e-2, 1e-2),
    ("mid_tile_mask_bf16", (8, 4, 600, 600, 128), torch.bfloat16, "qk", "middle", 1e-2, 1e-2),
    ("short_q_bf16", (1, 4, 40, 300, 64), torch.bfloat16, "randn", None, 1e-2, 1e-2),
]
K1_TIMED = ("flagship_cfg_bf16", "reference_split_bf16", "train_bf16", "engine_b1_bf16",
            "engine_b2_bf16", "engine_b4_bf16", "dp_b1_f32", "dp_b2_f32", "dp_b4_f32")
K1_HOST_TIMED = ("flagship_cfg_bf16", "engine_b1_bf16")
K1_BF16_HEIGHTS = (64, 128)  # query rows per block (fp32 takes 16)

# (name, (b, h, n, kv, d), dtype, inputs, mask, tol): K2/K3 hold when, for
# each of dq, dk, dv, against the plain backward and against autograd of the
# plain forward in fp32, max |kernel - ref| <= tol * max |ref| and
# ||kernel - ref|| <= NORM_TOL * ||ref|| (the norm holds every entry to the
# bound, not only the largest: qk-normed logits at scale 10 make dq and dk
# heavy-tailed, so tol * max |ref| can exceed a typical entry). bf16: P and
# dS are rounded to bf16 before their products and dq, dk, dv on the way
# out (2^-8 relative each), in the same places as in the plain backward but
# not in autograd's fp32, where the rounding of dS, whose row sums cancel,
# weighs more; fp32: the logits' rounding at scale 10, as for K1.
# "train_randn_bf16" holds the bf16 (wgmma) code at the training shape on a
# soft softmax, where no entry dominates. The empty-row cases mask every key
# of the last batch element and run qk-normed logits at scale 10, where a
# masked key's exp(s - lse) overflows.
K23_CASES = [
    ("train_bf16", (8, 4, 768, 768, 128), torch.bfloat16, "qk", "all", 2e-2),
    ("train_randn_bf16", (8, 4, 768, 768, 128), torch.bfloat16, "randn", "all", 2e-2),
    ("train_f32", (8, 4, 768, 768, 128), torch.float32, "qk", "all", 1e-4),
    ("reference_split_bf16", (8, 16, 768, 768, 64), torch.bfloat16, "qk", "all", 2e-2),
    ("ragged_bf16", (2, 4, 257, 200, 128), torch.bfloat16, "randn", "random", 2e-2),
    ("ragged_f32", (2, 4, 257, 200, 64), torch.float32, "randn", "random", 1e-4),
    ("empty_row_qk_bf16", (3, 4, 300, 300, 128), torch.bfloat16, "qk", "empty_row", 2e-2),
    ("empty_row_qk_f32", (3, 4, 300, 300, 64), torch.float32, "qk", "empty_row", 1e-4),
    # the edges of the bf16 design, at both head dims: kv off the 64-row tile
    # and off 8 (TMA's zero fill, a random mask); n under one 64-row tile; a
    # kv (K2) and an n (K3) that wrap the 2-stage ring many times; masked
    # runs inside tiles; a fully-masked element under qk-norm's scale 10
    *[(f"{case}_d{d}_bf16", (*shape, d), torch.bfloat16, inputs, mask, 2e-2)
      for d in (64, 128)
      for case, shape, inputs, mask in (
          ("ragged_tma", (2, 4, 257, 131), "randn", "random"),
          ("short_q", (1, 4, 40, 300), "randn", None),
          ("long_kv", (1, 4, 4100, 4100), "qk", None),
          ("mid_tile_mask", (8, 4, 600, 600), "qk", "middle"),
          ("empty_row_qk", (3, 4, 300, 300), "qk", "empty_row"),
      ) if (case, d) != ("empty_row_qk", 128)],  # "empty_row_qk_bf16" above
]
K23_TIMED = ("train_bf16", "reference_split_bf16")
NORM_TOL = {torch.bfloat16: (3e-3, 1e-2), torch.float32: (1e-4, 1e-4)}  # vs plain, autograd

FLAGSHIP = dict(
    num_cond_tokens=500, dim_cond_emb=512, dim=512, depth=24, dim_head=128, heads=4,
    num_register_tokens=16, attn_qk_norm=True, condition_on_text=True,
)
FRAMES = 750  # 10 s at 24 kHz, hop 320
STEPS, CFG_SCALE = 3, 1.3
EVALS_PER_REQUEST = 2 * (STEPS - 1)  # midpoint: two evaluations per interval

# the flagship training step (bench.py:41-107): latents of the Encodec width,
# 752 frames + 16 registers = 768 tokens, batch 8, AdamW lr 1e-4, wd 1e-2,
# global-norm clip 0.5, CFG drop 0.2
TRAIN_FRAMES, TRAIN_BATCH, LATENT_DIM = 752, 8, 128
TRAIN_WARMUP, TRAIN_TIMED = 2, 6

# the small fp32 denoiser of the card-vs-CPU phases
SMALL = dict(num_cond_tokens=100, dim_cond_emb=64, dim=128, depth=2, dim_head=64, heads=2,
             num_register_tokens=4)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def seeded(build, seed: int):
    """Build modules with torch's default init under a fixed seed, without
    touching the caller's random state."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # the device sleeps (~50 ms) while the host queues every call, so the
    # events time the device's work and not the host's launches: a short
    # library call (SDPA's, through autograd) is otherwise host-bound
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns: dict, iters: int = 20) -> dict:
    """Mean CUDA-event time of each function, timed in the order
    a, b, ..., ..., b, a and averaged over the two turns."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(cuda_ms(fns[n], iters))
    return {n: sum(t) / len(t) for n, t in times.items()}


def attention_bound(kernel: str, shape, dtype) -> tuple:
    """(bound_ms, bound_by) of one K1, K2 or K3 call: operations 4, 6 or 8
    b h n kv d; bytes of each input read once and each output written once."""
    b, h, n, kv, d = shape
    e = torch.finfo(dtype).bits // 8
    q_bytes, kv_bytes, rows = b * h * n * d * e, b * h * kv * d * e, b * h * n * 4
    flops = {"k1": 4, "k2": 6, "k3": 8}[kernel] * b * h * n * kv * d
    moved = {
        "k1": 2 * q_bytes + 2 * kv_bytes + rows,      # q, k, v, mask in; out, lse out
        "k2": 3 * q_bytes + 2 * kv_bytes + 2 * rows,  # q, k, v, dO, lse, delta in; dq out
        "k3": 2 * q_bytes + 4 * kv_bytes + 2 * rows,  # the same in; dk, dv out
    }[kernel] + b * kv
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], moved / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def reset_launches() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {k: w.launches for k, w in WRAPPERS.items()}


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    major, minor = torch.cuda.get_device_capability(0)
    assert major == 9, f"the kernels are built for sm_90a; this card is sm_{major}{minor}"
    # the fp32 phases compare against fp32 references: no TF32 anywhere
    # (ConvPositionEmbed is a cuDNN conv, where TF32 is on by default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log("device", f"{name} sm_{major}{minor} count={torch.cuda.device_count()} "
                  f"torch={torch.__version__} cuda={torch.version.cuda} | {smi}")
    return smi


# the attention sources, the kernels each holds and their bf16
# instantiations (K1: d 64 and 128 x 64 and 128 query rows; K2, K3: d 64 and
# 128), every one of which must be wgmma + TMA, with no spill
ATTENTION_SOURCES = {"flash_attention_fwd": {"k1": 4}, "flash_attention_bwd": {"k2": 2, "k3": 2}}


def phase_build() -> None:
    sources = ("flash_attention_fwd", "flash_attention_bwd", "w8a16_matmul")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        libs = list(pool.map(kernels.build, sources))
    for name in sources:
        kernels.load(name)
    dt = time.perf_counter() - t0
    for name, lib in zip(sources, libs):
        if name not in ATTENTION_SOURCES:
            ptxas = [
                line.strip() for line in open(f"{lib}.log")
                if "registers" in line or "spill" in line
            ]
            log("build", f"{name}: {lib.name}; ptxas: {' | '.join(ptxas)}")
            continue
        ptxas = _ptxas_by_kernel(f"{lib}.log")
        for fn, lines in ptxas.items():
            log("build", f"{name} {fn}: ptxas: {' | '.join(lines)}")
        tool, counts = _sass_counts(lib)
        log("build", f"{name} SASS ({tool}): (HGMMA, UTMALDG) per instantiation {counts}")
        for kernel, expected in ATTENTION_SOURCES[name].items():
            bf16 = {fn: c for fn, c in counts.items() if fn.startswith(f"{kernel} bf16")}
            assert len(bf16) == expected and all(min(c) > 0 for c in bf16.values()), (
                f"{kernel}'s bf16 code is not wgmma + TMA: {counts}"
            )
            spills = {fn: _spill_bytes(ptxas.get(fn, [])) for fn in bf16}
            assert all(s == 0 for s in spills.values()), f"{kernel} spills: {spills}"
    log("build", f"nvcc {' '.join(kernels.NVCC_FLAGS)}: {len(sources)} sources in "
                 f"{dt:.2f} s, built in parallel")


_KERNEL = re.compile(r"flash_(fwd|bwd_dq|bwd_dkv)_(bf16|f32)ILi(\d+)E(?:Li(\d+)E)?")
_KERNEL_TAG = {"fwd": "k1", "bwd_dq": "k2", "bwd_dkv": "k3"}


def _instance(mangled: str):
    """`k2 bf16 d=128 rows=128` from a mangled K1, K2 or K3 instantiation
    (rows: those a block owns), or None."""
    m = _KERNEL.search(mangled)
    if m is None:
        return None
    which, kind, d, tile = m.groups()
    kernel = _KERNEL_TAG[which]
    rows = 16 if (kernel, kind) == ("k1", "f32") else 64 * int(tile or 1)
    return f"{kernel} {kind} d={d} rows={rows}"


def _ptxas_by_kernel(log_path) -> dict:
    """ptxas's registers, spill and shared-memory lines of each attention
    kernel instantiation, from the build's log."""
    found, current = {}, None
    for line in open(log_path):
        if "Compiling entry function" in line:
            current = _instance(line)
        elif current and ("registers" in line or "spill" in line):
            found.setdefault(current, []).append(line.strip().replace("ptxas info    : ", ""))
    return found


def _spill_bytes(lines) -> int:
    """Spill stores plus loads, in bytes, from ptxas's lines of one kernel."""
    return sum(int(a) + int(b) for line in lines
               for a, b in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line))


def _sass_counts(lib) -> tuple:
    """(tool, {attention instantiation: (HGMMA, UTMALDG) instructions}) from
    `cuobjdump -sass` of the built library: the toolkit's, or Triton's copy."""
    candidates = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        candidates.append(f"{spec.origin.rsplit('/', 1)[0]}/backends/nvidia/bin/cuobjdump")
    tool = next((c for c in candidates if c and os.path.exists(c)), None)
    assert tool is not None, f"no cuobjdump among {candidates}"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = _instance(part.split("\n", 1)[0])
        if name is not None:
            counts[name] = (part.count("HGMMA"), part.count("UTMALDG"))
    return tool, counts


def _attn_inputs(shape, dtype, inputs, mask_kind, gen):
    b, h, n, kv, d = shape
    dev = "cuda"
    q, k, v = (torch.randn(b, h, m, d, generator=gen, device=dev) for m in (n, kv, kv))
    do = torch.randn(b, h, n, d, generator=gen, device=dev)
    scale = d ** -0.5
    if inputs == "qk":
        q, k = (l2norm(t) * d ** 0.5 for t in (q, k))
        scale = 10.0
    mask = None
    if mask_kind == "all":  # the denoiser's mask when no frame is padding
        mask = torch.ones(b, kv, dtype=torch.bool, device=dev)
    elif mask_kind == "middle":  # runs of masked keys inside 128-key tiles
        mask = torch.ones(b, kv, dtype=torch.bool, device=dev)
        mask[:, 50:180] = False
        mask[1::2, 300:310] = False
    elif mask_kind is not None:
        mask = torch.rand(b, kv, generator=gen, device=dev) < 0.7
        if mask_kind == "empty_row":
            mask[-1] = False  # every key of the last batch element masked
    return q.to(dtype), k.to(dtype), v.to(dtype), do.to(dtype), mask, scale


def _sdpa_mask(mask):
    return None if mask is None else mask[:, None, None, :]


def host_us(fn, calls: int = 200) -> float:
    """Host time of one call of fn in microseconds: the host clock over
    `calls` calls queued behind a device sleep, with no synchronize between
    them, so the device never holds the host back."""
    with torch.no_grad():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
    return dt / calls * 1e6


def phase_k1_check(smi: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for name, shape, dtype, inputs, mask_kind, atol, rtol in K1_CASES:
        q, k, v, _, mask, scale = _attn_inputs(shape, dtype, inputs, mask_kind, gen)
        out, lse = flash_attention(q, k, v, mask, scale, return_lse=True)
        ref, ref_lse = reference_attention(q, k, v, mask, scale, return_lse=True)
        torch.cuda.synchronize()
        out, ref = out.float(), ref.float()
        err = (out - ref).abs()
        ok = bool((err <= atol + rtol * ref.abs()).all())
        lse_ok = bool(torch.allclose(lse, ref_lse, rtol=1e-5, atol=1e-3))
        line = (f"{name} {tuple(shape)} {str(dtype)[6:]} max_abs_err={err.max().item():.3e} "
                f"tol=atol {atol:g} + rtol {rtol:g} lse_max_abs_err="
                f"{(lse - ref_lse).abs().max().item():.3e}")
        if mask_kind == "empty_row":
            mean_v = v[-1].float().mean(dim=1, keepdim=True).expand_as(out[-1])
            row_err = (out[-1] - mean_v).abs().max().item()
            ok = ok and row_err <= atol + rtol * mean_v.abs().max().item()
            line += f" empty_row_vs_mean_v={row_err:.3e}"
        log("k1", line)
        assert ok and lse_ok, f"K1 disagrees with the plain version on {name}"
        results[name] = {"max_abs_err": err.max().item(), "shape": shape, "dtype": dtype,
                         "masked": mask is not None}
        if name in K1_TIMED:
            sm = _sdpa_mask(mask)
            t = in_turns({
                "plain": lambda: reference_attention(q, k, v, mask, scale),
                "k1": lambda: flash_attention(q, k, v, mask, scale),
                "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sm,
                                                               scale=scale),
            })
            bound_ms, bound_by = attention_bound("k1", shape, dtype)
            results[name].update(ms=t["k1"], plain_ms=t["plain"], library_ms=t["sdpa"],
                                 bound_ms=bound_ms, bound_by=bound_by)
            log("k1", f"time {name}: K1 {t['k1']:.4f} ms, plain {t['plain']:.4f} ms, SDPA "
                      f"{t['sdpa']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) (CUDA "
                      f"events, mean of 2 x 20, order plain/K1/SDPA/SDPA/K1/plain) on {smi}")
        if name in K1_TIMED and dtype == torch.bfloat16:
            b, h, n = shape[:3]
            chosen = k1_block_q(b, h, n, shape[4], dtype, sms)
            tiles = in_turns({rows: lambda rows=rows: _launch_k1(q, k, v, mask, scale, rows)
                              for rows in K1_BF16_HEIGHTS})
            log("k1", f"tile height {name}: " + ", ".join(
                f"{rows} rows {ms:.4f} ms ({-(-n // rows) * b * h} blocks)"
                + (" <- chosen" if rows == chosen else "") for rows, ms in tiles.items())
                + f" (CUDA events, in turns, {sms} SMs)")
        if name in K1_HOST_TIMED:
            phase_k1_host_time(name, q, k, v, mask, scale)
    return results


def phase_k1_host_time(name, q, k, v, mask, scale, rounds: int = 5) -> None:
    """Host microseconds of one bf16 K1 call, in turns: `flash_attention`
    (what the model calls), `_launch_k1` (which encodes three tensor maps),
    and `_launch_k1` on fp32 copies of the same operands (the same host path,
    no tensor map)."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    calls = {
        "flash_attention bf16": lambda: flash_attention(q, k, v, mask, scale),
        "_launch_k1 bf16 (3 tensor maps encoded)": lambda: _launch_k1(q, k, v, mask, scale),
        "_launch_k1 fp32 (no tensor map)": lambda: _launch_k1(qf, kf, vf, mask, scale),
    }
    us = {label: [] for label in calls}
    for _ in range(rounds):
        for label, fn in calls.items():
            us[label].append(host_us(fn))
    log("k1", f"host time of one call {name}: " + "; ".join(
        f"{label} median {np.median(t):.2f} us, min {min(t):.2f}"
        for label, t in us.items())
        + f" (host clock over 200 calls queued behind a device sleep, no synchronize, "
          f"{rounds} rounds in turns)")


def _rel_err(got, ref) -> float:
    return (got.float() - ref.float()).abs().max().item() / max(ref.float().abs().max().item(),
                                                                1e-30)


def _norm_err(got, ref) -> float:
    """||got - ref|| / ||ref|| over every entry."""
    ref = ref.double()
    return (got.double() - ref).norm().item() / max(ref.norm().item(), 1e-300)


def phase_k23_check(smi: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    results = {}
    for name, shape, dtype, inputs, mask_kind, tol in K23_CASES:
        q, k, v, do, mask, scale = _attn_inputs(shape, dtype, inputs, mask_kind, gen)
        out, lse = flash_attention(q, k, v, mask, scale, return_lse=True)
        delta = attention_delta(do, out)
        dq = flash_attention_bwd_dq(q, k, v, mask, do, lse, delta, scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta, scale)
        torch.cuda.synchronize()
        got = (dq, dk, dv)
        assert all(bool(torch.isfinite(g).all()) for g in got), f"non-finite K2/K3 on {name}"
        plain = reference_attention_backward(q, k, v, mask, out, lse, do, scale)
        leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
        auto = torch.autograd.grad(reference_attention(*leaves, mask, scale), leaves,
                                   do.float())
        err_plain = [_rel_err(a, b) for a, b in zip(got, plain)]
        err_auto = [_rel_err(a, b) for a, b in zip(got, auto)]
        norm_plain = [_norm_err(a, b) for a, b in zip(got, plain)]
        norm_auto = [_norm_err(a, b) for a, b in zip(got, auto)]
        abs_err = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, plain)]
        typical = [r.float().abs().median().item() for r in plain]
        tol_plain, tol_auto = NORM_TOL[dtype]
        line = (f"{name} {tuple(shape)} {str(dtype)[6:]} dq/dk/dv max_abs_err vs plain "
                f"{abs_err[0]:.3e}/{abs_err[1]:.3e}/{abs_err[2]:.3e} (median |ref| "
                f"{'/'.join(f'{e:.3e}' for e in typical)}), relative to max|ref| vs plain "
                f"{'/'.join(f'{e:.2e}' for e in err_plain)}, vs autograd "
                f"{'/'.join(f'{e:.2e}' for e in err_auto)} (tol {tol:g} x max|ref|); "
                f"||err|| / ||ref|| vs plain {'/'.join(f'{e:.2e}' for e in norm_plain)} (tol "
                f"{tol_plain:g}), vs autograd {'/'.join(f'{e:.2e}' for e in norm_auto)} (tol "
                f"{tol_auto:g})")
        ok = (max(err_plain + err_auto) <= tol and max(norm_plain) <= tol_plain
              and max(norm_auto) <= tol_auto)
        if mask_kind == "empty_row":
            zero = int(torch.count_nonzero(dq[-1])) + int(torch.count_nonzero(dk[-1]))
            want_dv = (do[-1].float().sum(dim=1, keepdim=True) / shape[3]).expand_as(dv[-1])
            dv_err = _rel_err(dv[-1], want_dv)
            line += (f"; fully-masked element: nonzero dq+dk {zero} (want 0), dv vs "
                     f"sum(dO)/kv {dv_err:.2e}")
            ok = ok and zero == 0 and dv_err <= tol
        # each block owns its outputs and sums in a fixed order: a second
        # launch on the same inputs gives the same bits
        again = (flash_attention_bwd_dq(q, k, v, mask, do, lse, delta, scale),
                 *flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta, scale))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        line += f"; second launch bit-identical {same}"
        ok = ok and same
        del again
        log("k23", line)
        assert ok, f"K2/K3 disagree with the plain backward on {name}"
        results[name] = {"max_abs_err": abs_err, "shape": shape, "dtype": dtype}
        if name in K23_TIMED:
            sm = _sdpa_mask(mask)
            lv = [t.detach().requires_grad_(True) for t in (q, k, v)]

            def ours_fwd_bwd():
                torch.autograd.grad(flash_attention(*lv, mask, scale), lv, do)

            def sdpa_fwd_bwd():
                torch.autograd.grad(F.scaled_dot_product_attention(
                    *lv, attn_mask=sm, scale=scale), lv, do)

            # SDPA's backward alone: one autograd call into its fused backward,
            # which gives dq, dk and dv together from its saved out and lse
            sdpa_out = F.scaled_dot_product_attention(*lv, attn_mask=sm, scale=scale)
            sdpa_node = type(sdpa_out.grad_fn).__name__
            t = in_turns({
                "plain": lambda: reference_attention_backward(q, k, v, mask, out, lse, do,
                                                              scale),
                "k2": lambda: flash_attention_bwd_dq(q, k, v, mask, do, lse, delta, scale),
                "k3": lambda: flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta, scale),
                "sdpa_bwd": lambda: torch.autograd.grad(sdpa_out, lv, do, retain_graph=True),
                "ours_fwd_bwd": ours_fwd_bwd,
                "sdpa_fwd_bwd": sdpa_fwd_bwd,
            }, iters=10)
            del sdpa_out
            results[name]["times"] = t
            results[name]["bounds"] = {kk: attention_bound(kk, shape, dtype)
                                       for kk in ("k2", "k3")}
            b2, b3 = (results[name]["bounds"][kk][0] for kk in ("k2", "k3"))
            pair = t["k2"] + t["k3"]
            log("k23", f"time {name}: K2 {t['k2']:.4f} ms (bound {b2:.4f}, "
                       f"{b2 / t['k2']:.1%}), K3 {t['k3']:.4f} ms (bound {b3:.4f}, "
                       f"{b3 / t['k3']:.1%}), K2+K3 {pair:.4f} ms = "
                       f"{pair / t['sdpa_bwd']:.2f}x SDPA's backward; "
                       f"dq, dk, dv together: plain backward {t['plain']:.4f} ms, SDPA "
                       f"backward ({sdpa_node}) {t['sdpa_bwd']:.4f} ms; forward + backward: "
                       f"K1+K2+K3 {t['ours_fwd_bwd']:.4f} ms, SDPA {t['sdpa_fwd_bwd']:.4f} ms "
                       f"(CUDA events, mean of 2 x 10, in turns; bf16 K2/K3 blocks own 64 "
                       f"rows) on {smi}")
    return results


# the flagship's four quantized matmuls per block, (k, n): to_qkv, to_out,
# the feed-forward's proj_in (GEGLU, 2 x 1365) and proj_out. m is batch x 2
# for CFG x (frames + 16 registers): the engine's groups give 544 (batch 1,
# 256 frames), 2112 (batch 2, 512) and 8320 (batch 4, 1024); 1532 is
# batch 1 at 750 frames
K4_SHAPES = {"to_qkv": (512, 1536), "to_out": (512, 512), "ff_proj_in": (512, 2730),
             "ff_proj_out": (1365, 512)}
K4_ROWS = (544, 1532, 2112, 8320)
K4_RAGGED_ROWS = (37, 1)
# tolerance of |K4 - plain| <= rtol |plain| + atol max|plain|. Both sum exact
# products (bf16 x int8, or fp32 x int8 in fp32) in fp32, in another order
# (atol); bf16 outputs also round to bf16 after the scale, which moves a
# value by one bf16 step (2^-8 relative) where the sums straddle a boundary
K4_TOL = {torch.bfloat16: (2 ** -7, 1e-4), torch.float32: (1e-5, 1e-5)}


def k4_times(m: int, k: int, n: int, dtype) -> tuple:
    """(operations ms, bytes ms) of one K4 call: 2 m n k operations at the
    peak of x's type; bytes of x, the int8 weight, the fp32 scale and y,
    each once."""
    e = torch.finfo(dtype).bits // 8
    moved = m * k * e + n * k + 4 * n + m * n * e
    return 2 * m * n * k / PEAK_FLOPS[dtype] * 1e3, moved / HBM_BYTES_PER_S * 1e3


def k4_bound(m: int, k: int, n: int, dtype) -> tuple:
    """(bound_ms, bound_by) of one K4 call: the larger of k4_times."""
    t_ops, t_bytes = k4_times(m, k, n, dtype)
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _k4_operands(m, k, n, dtype, gen):
    layer = torch.nn.Linear(k, n, bias=False, device="cuda")
    with torch.no_grad():
        layer.weight.copy_(torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5)
    ql = QuantLinear(layer, "w8a16")
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    return x, ql


def _int8pack_mm(x, ql):
    """`torch._weight_int8pack_mm` on the same product where this build has
    a CUDA kernel for it, else None and why (the yardstick only: the port
    never calls it). Its CPU kernel crashes on a k that is not a multiple of
    32, so such shapes are not tried."""
    n, k = ql.out_features, ql.in_features
    if not torch._C._dispatch_has_kernel_for_dispatch_key("aten::_weight_int8pack_mm", "CUDA"):
        return None, "no CUDA kernel in this build"
    if k % 32:
        return None, f"k = {k} not a multiple of 32"
    w = ql.weight_q[:n, :k].contiguous()
    scales = ql.weight_scale.to(x.dtype)
    try:
        torch._weight_int8pack_mm(x, w, scales)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:80]}"
    return (lambda: torch._weight_int8pack_mm(x, w, scales)), None


def phase_k4_check(smi: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    results = {}
    cases = [(name, m, dtype) for name in K4_SHAPES for m in K4_ROWS
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [("ff_proj_out", m, dtype) for m in K4_RAGGED_ROWS
              for dtype in (torch.bfloat16, torch.float32)]
    for name, m, dtype in cases:
        k, n = K4_SHAPES[name]
        x, ql = _k4_operands(m, k, n, dtype, gen)
        y = w8a16_matmul(x, ql.weight_q, ql.weight_scale)
        ref = w8a16_matmul_reference(x, ql.weight_q, ql.weight_scale)
        torch.cuda.synchronize()
        rtol, atol = K4_TOL[dtype]
        err = (y.float() - ref.float()).abs()
        peak = ref.float().abs().max().item()
        ok = bool(torch.isfinite(y).all()) and bool(
            (err <= rtol * ref.float().abs() + atol * peak).all())
        log("k4", f"{name} (m, k, n) = ({m}, {k}, {n}) {str(dtype)[6:]}: max_abs_err "
                  f"{err.max().item():.3e} (max |plain| {peak:.3e}; tol rtol {rtol:g} + atol "
                  f"{atol:g} x max|plain|)")
        assert ok, f"K4 disagrees with the plain version on {name} m={m} {dtype}"
        if dtype != torch.bfloat16 or m not in K4_ROWS:
            continue
        w_deq = (ql.weight_q[:n, :k].float() * ql.weight_scale[:, None]).to(dtype)
        fns = {
            "plain": lambda: w8a16_matmul_reference(x, ql.weight_q, ql.weight_scale),
            "k4": lambda: w8a16_matmul(x, ql.weight_q, ql.weight_scale),
            "cublas": lambda: F.linear(x, w_deq),
        }
        int8pack, why = _int8pack_mm(x, ql)
        if int8pack is not None:
            fns["int8pack"] = int8pack
        t = in_turns(fns)
        bound_ms, bound_by = k4_bound(m, k, n, dtype)
        results[(m, k, n)] = dict(shape=(m, k, n), ms=t["k4"], plain_ms=t["plain"],
                                  library_ms=t["cublas"], int8pack_ms=t.get("int8pack"),
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  max_abs_err=err.max().item())
        pack = (f"{t['int8pack']:.4f} ms" if int8pack is not None
                else f"not run ({why})")
        log("k4", f"time {name} ({m}, {k}, {n}) bf16: K4 {t['k4']:.4f} ms, plain "
                  f"{t['plain']:.4f} ms, cuBLAS on the bf16-dequantized weight "
                  f"{t['cublas']:.4f} ms, _weight_int8pack_mm {pack}, bound {bound_ms:.4f} ms "
                  f"({bound_by}) (CUDA events, mean of 2 x 20, in turns) on {smi}")
    return results


def _small_slice(device):
    codec = EncodecVoco(
        quantizer=ResidualVQ(num_quantizers=4, codebook_size=64, dim=32),
        vocos=Vocos(input_channels=32, dim=64, intermediate_dim=96, num_layers=2,
                    n_fft=64, hop_length=16, num_bandwidths=4, codebook_size=64,
                    num_quantizers=4),
        ratios=(2, 2, 2, 2),
    )
    vb = vbt.VoiceBox(audio_enc_dec=codec, **SMALL)
    _soften_qk_gains(vb)
    return vbt.ConditionalFlowMatcherWrapper(vb, device=device)


def _soften_qk_gains(vb, gain: float = 0.25):
    # qk-norm scales q and k to norm sqrt(d) and the logits by 10, so with unit
    # gains they reach 10 d = 640 and the softmax is nearly an argmax: a 1e-6
    # change of y0 then moves the latents by 1e-2 (measured on the CPU). Gains
    # of 0.25 (logits up to 40) keep the comparison about rounding, not ties.
    for name, p in vb.named_parameters():
        if name.endswith(("q_norm.gamma", "k_norm.gamma")):
            torch.nn.init.constant_(p, gain)


def phase_slice_card_vs_cpu(quantize=None) -> None:
    """With `quantize="w8a16"` both sides sample through the quantized copy
    of the same weights: K4 on the card, its plain version on the CPU."""
    cfm_cpu = seeded(lambda: _small_slice("cpu"), SEED).eval()
    cfm_gpu = seeded(lambda: _small_slice("cuda"), SEED).eval()
    gen = torch.Generator().manual_seed(SEED + 1)
    b, n = 2, 96
    cond = torch.randn(b, n, 32, generator=gen)
    ids = torch.randint(0, 100, (b, n), generator=gen)
    y0 = torch.randn(b, n, 32, generator=gen)
    kw = dict(semantic_token_ids=ids, cond=cond, steps=STEPS, cond_scale=CFG_SCALE,
              noise=y0, decode_to_audio=False, quantize=quantize)

    before = read_launches()
    lat_cpu = cfm_cpu.sample(**kw)
    assert read_launches() == before, "the CPU run must launch no kernel"
    lat_gpu = cfm_gpu.sample(**{k: v.cuda() if torch.is_tensor(v) else v for k, v in kw.items()})
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in read_launches().items()}
    depth = SMALL["depth"]
    want = {"k1": depth * EVALS_PER_REQUEST, "k2": 0, "k3": 0,
            "k4": 0 if quantize is None else 4 * depth * EVALS_PER_REQUEST}
    assert launches == want, f"launched {launches}, expected {want}"
    lat_err = (lat_gpu.cpu() - lat_cpu).abs().max().item()

    codes_cpu = cfm_cpu.codec.decode_to_codes(lat_cpu)
    codes_gpu = cfm_gpu.codec.decode_to_codes(lat_gpu).cpu()
    code_agree = (codes_cpu == codes_gpu).float().mean().item()
    # audio decoded from the same latents on both devices
    audio_cpu = cfm_cpu.codec.decode(lat_cpu)
    audio_gpu = cfm_gpu.codec.decode(lat_cpu.cuda()).cpu()
    peak = audio_cpu.abs().max().item()
    audio_err = (audio_gpu - audio_cpu).abs().max().item()
    log("slice", f"card vs CPU, fp32, dim 128 depth 2 heads 2x64, {n} frames, steps {STEPS}, "
                 f"cfg {CFG_SCALE}, quantize {quantize}: K1/K4 launches {launches['k1']}/"
                 f"{launches['k4']}, latents max_abs_err {lat_err:.3e} "
                 f"(tol 1e-3), RVQ codes equal {code_agree:.4f} (tol >= 0.99), audio from "
                 f"the same latents max_abs_err {audio_err:.3e} (tol 1e-3 x peak {peak:.3e})")
    assert math.isfinite(lat_err) and lat_err <= 1e-3, "latents disagree card vs CPU"
    assert code_agree >= 0.99, "RVQ codes disagree card vs CPU"
    assert audio_err <= 1e-3 * peak, "audio disagrees card vs CPU"


SMALL_TRAIN = dict(lr=1e-3, initial_lr=1e-4, num_warmup_steps=1, wd=1e-2, max_grad_norm=0.5,
                   save_results_every=1000)


def _small_trainer(device, items):
    def build():
        vb = vbt.VoiceBox(dim_in=32, **SMALL)
        _soften_qk_gains(vb)
        return vbt.ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2, device=device)

    cfm = seeded(build, SEED + 4)
    return vbt.VoiceBoxTrainer(cfm, batch_size=2, dataset=vbt.ArrayDataset(items),
                               num_train_steps=3, valid_frac=0.0, bucket_multiple=128,
                               log_every=1000, device=device, **SMALL_TRAIN)


def phase_train_card_vs_cpu() -> None:
    rs = np.random.RandomState(SEED + 5)
    items = [(rs.randn(n, 32).astype(np.float32), rs.randint(0, 100, n).astype(np.int32))
             for n in (96, 90, 93, 96)]
    cpu, gpu = _small_trainer("cpu", items), _small_trainer("cuda", items)
    init = {n: p.detach().clone() for n, p in cpu.cfm_wrapper.voicebox.named_parameters()}
    frames = 124  # 90-96 frames + 4 registers: the bucket grid gives 124 + 4 = 128 tokens
    depth = SMALL["depth"]
    losses = []
    for step in range(3):
        m = 2
        draws = dict(noise=rs.randn(m, frames, 32).astype(np.float32),
                     times=rs.rand(m).astype(np.float32),
                     cond_mask=rs.rand(m, frames) < 0.7, cond_drop_mask=rs.rand(m) < 0.2)
        cpu_loss = cpu.train_step(**{k: torch.from_numpy(v) for k, v in draws.items()})["loss"]
        reset_launches()
        gpu_loss = gpu.train_step(**{k: torch.from_numpy(v).cuda() for k, v in draws.items()})
        torch.cuda.synchronize()
        # step 0 also evaluates one validation batch: one more forward
        want = {"k1": depth * (2 if step == 0 else 1), "k2": depth, "k3": depth, "k4": 0}
        assert read_launches() == want, f"step {step} launched {read_launches()}, want {want}"
        losses.append((gpu_loss["loss"].item(), cpu_loss.item()))
    loss_err = max(abs(g - c) / abs(c) for g, c in losses)
    lr = SMALL_TRAIN["lr"]
    worst, n_off, total, cos_min = 0.0, 0, 0, 1.0
    gpu_params = dict(gpu.cfm_wrapper.voicebox.named_parameters())
    for name, p in cpu.cfm_wrapper.voicebox.named_parameters():
        a = (gpu_params[name].detach().cpu() - init[name]).double()
        b = (p.detach() - init[name]).double()
        diff = (a - b).abs()
        worst = max(worst, diff.max().item())
        n_off += int((diff > 1e-2 * lr).sum())
        total += diff.numel()
        cos_min = min(cos_min, (a * b).sum().item() / max(a.norm().item() * b.norm().item(),
                                                          1e-30))
    frac_off = n_off / total
    log("train", f"card vs CPU, fp32, dim 128 depth 2 heads 2x64, batch 2 x {frames} frames, "
                 f"3 AdamW steps (lr {lr:g}, clip 0.5): losses card/CPU "
                 f"{[(round(g, 6), round(c, 6)) for g, c in losses]}, max relative diff "
                 f"{loss_err:.2e} (tol 1e-4); K1/K2/K3 launches per step {depth}/{depth}/"
                 f"{depth}; parameter updates: min per-tensor cosine {cos_min:.6f} (tol > "
                 f"0.999), max abs diff {worst:.3e} (tol 6 lr = {6 * lr:g}), weights off by "
                 f"> 0.01 lr {n_off} of {total} (tol 1e-3 of them)")
    # Adam moves each weight by ~lr whatever its gradient's size, so a weight
    # whose gradient is near zero carries the two devices' summation-order
    # rounding amplified: a few weights may differ by up to a flipped update
    # (2 lr a step), the rest agree to rounding
    assert loss_err <= 1e-4, "losses disagree card vs CPU"
    assert cos_min > 0.999 and worst <= 6 * lr and frac_off <= 1e-3, (
        "parameters disagree card vs CPU"
    )


def _flagship():
    codec = EncodecVoco()  # RVQ 8 x 1024 x 128, vocos-encodec-24khz geometry
    vb = vbt.VoiceBox(audio_enc_dec=codec, dtype=torch.bfloat16, **FLAGSHIP)
    return vbt.ConditionalFlowMatcherWrapper(vb)


def phase_serve(smi: str) -> int:
    cfm = seeded(_flagship, SEED + 2).eval()
    codec = cfm.codec
    audio_s = FRAMES * codec.downsample_factor / codec.sampling_rate
    expected = FLAGSHIP["depth"] * EVALS_PER_REQUEST
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def request(batch: int):
        cond = torch.randn(batch, FRAMES, codec.latent_dim, generator=gen, device="cuda")
        ids = torch.randint(0, FLAGSHIP["num_cond_tokens"], (batch, FRAMES), generator=gen,
                            device="cuda")
        before = flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio, lengths = cfm.sample(cond=cond, semantic_token_ids=ids, steps=STEPS,
                                    cond_scale=CFG_SCALE, generator=gen, return_lengths=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = flash_attention.launches - before
        want = (batch, 1, FRAMES * codec.downsample_factor)
        assert tuple(audio.shape) == want, f"audio {tuple(audio.shape)} != {want}"
        assert bool(torch.isfinite(audio).all()), "non-finite audio"
        assert lengths.tolist() == [want[-1]] * batch
        assert launches == expected, f"{launches} K1 launches, expected {expected}"
        return dt, launches

    request(1)  # warm-up: allocator, cuFFT plans
    reset_launches()  # the serving path's run starts here
    for i, batch in enumerate((1, 1, 2, 2)):
        dt, launches = request(batch)
        log("serve", f"request {i} batch {batch}: {FRAMES} frames = {audio_s:.1f} s audio, "
                     f"latency {dt * 1e3:.2f} ms, RTF {dt / audio_s:.5f}, K1 launches "
                     f"{launches}, audio finite {(batch, 1, FRAMES * 320)} on {smi}")
    counts = read_launches()
    assert counts["k2"] == counts["k3"] == 0, "serving launched the backward"
    assert counts["k4"] == 0, "unquantized serving launched K4"
    del cfm
    torch.cuda.empty_cache()
    return counts["k1"]


# quantized duration-mode serving at full width (phase 9)
ENGINE = dict(text_buckets=(32, 64, 128), batch_buckets=(1, 2, 4), frames_per_token=8,
              steps=STEPS, cond_scale=CFG_SCALE, quantize="w8a16")
DP_DEPTH = 10  # the reference DurationPredictor: dim 512, depth 10, 8 x 64 heads
K4_PER_GROUP = EVALS_PER_REQUEST * FLAGSHIP["depth"] * 4  # 4 quantized matmuls a block
K1_PER_GROUP = EVALS_PER_REQUEST * FLAGSHIP["depth"] + DP_DEPTH
ENGINE_REQUESTS = (  # one bucket group each: batch 1 at text bucket 32, batch 2 at 64
    ["hello from the port on the card"],
    ["a second request, some forty characters", "and a shorter one beside it"],
)
BATCHER_TEXTS = (  # four concurrent submits, all in text bucket 128 (1024 frames)
    "the batcher gathers these four requests from four threads into one bucket group of four",
    "each of them is longer than sixty four characters and at most one hundred and twenty",
    "so that the group runs the largest buckets: four rows, a thousand and twenty four frames",
    "and the denoiser's matrix products see eight thousand three hundred and twenty rows",
)


def _engine_flagship():
    tok = GraphemeTokenizer()
    codec = EncodecVoco()
    dp = vbt.DurationPredictor(audio_enc_dec=codec, tokenizer=tok)  # the reference's defaults
    vb = vbt.VoiceBox(audio_enc_dec=codec, dtype=torch.bfloat16,
                      **{**FLAGSHIP, "num_cond_tokens": tok.vocab_size})
    return vbt.ConditionalFlowMatcherWrapper(vb, duration_predictor=dp)


def _group_ids(engine, texts) -> np.ndarray:
    """The bucket-padded ids `engine.synthesize` makes for one group."""
    ids = np.asarray(engine._tokenizer().texts_to_tensor_ids(list(texts)))
    ids = ids[:, : max(1, int((ids >= 0).sum(axis=1).max()))]
    return engine._pad_ids(ids, engine._bucket(len(texts), engine.batch_buckets),
                           engine._bucket(ids.shape[1], engine.text_buckets))


def _expected_lengths(engine, texts) -> list:
    """Samples of audio per text: the masked duration sum x hop, clamped to
    the largest frame bucket where the engine warns."""
    per = engine._predict_durations(_group_ids(engine, texts))
    frames = np.minimum(np.maximum(per.sum(axis=1), 1), engine.frame_buckets[-1])
    hop = engine.wrapper.codec.downsample_factor
    return [int(f) * hop for f in frames[: len(texts)]]


def _host_times_ms(fn, repeats: int) -> list:
    """Host-clock time of each of `repeats` calls of fn, in ms, the device
    synchronized around each."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _min_median(times) -> str:
    return f"min {min(times):.2f} ms, median {float(np.median(times)):.2f} ms"


@contextlib.contextmanager
def shape_tally():
    """Count by operand shape, while the block runs, the calls of K1's
    wrapper from the attention modules and of the w8a16 `QuantLinear`s
    (each one call of K4's wrapper): {("k1", (b, h, n, kv, d), dtype,
    masked) or ("k4", (m, k, n), dtype): calls}. On CUDA tensors each call
    is one launch."""
    tally = collections.Counter()
    k1, forward = attention_module.flash_attention, QuantLinear.forward

    def attend(q, k, v, mask=None, scale=None, **kw):
        tally["k1", (*q.shape[:3], k.shape[2], q.shape[3]), q.dtype, mask is not None] += 1
        return k1(q, k, v, mask=mask, scale=scale, **kw)

    def quant_forward(layer, x):
        if layer.mode == "w8a16":
            m = x.numel() // layer.in_features
            tally["k4", (m, layer.in_features, layer.out_features), layer.compute_dtype] += 1
        return forward(layer, x)

    attention_module.flash_attention, QuantLinear.forward = attend, quant_forward
    try:
        yield tally
    finally:
        attention_module.flash_attention, QuantLinear.forward = k1, forward


# per quantized module, ||quantized - bf16|| / ||bf16|| <= QUANT_MODULE_TOL x
# ||bf16 - fp32|| / ||fp32||. At full width on the CPU (dim 512, 2 x 272
# frames) the ratio reads 1.6-2.3 (attention ~0.05 against a floor of ~0.03
# at unit qk gains, feed-forward 0.009 against 0.004); a module that returns
# zeros reads 1.0, far above 4 x either floor
QUANT_MODULE_TOL = 4.0


def _quantized_gap(cfm, smi: str) -> None:
    """The quantized denoiser against the bf16 one it was made from, beside
    the floor of the bf16 model against the same weights computing in fp32.

    The check is per module: the input each attention and feed-forward
    module (2 x 24, every quantized matmul) sees in one bf16 forward (batch 1
    with its CFG null half, 750 frames) goes through the bf16 module, its
    quantized copy (K4) and the fp32 copy, so no module's error compounds
    through the depth. Then one whole forward at qk gains 0.5, printed for
    information only: at random weights and depth 24 any perturbation
    decorrelates the output (PERF.md section 7)."""
    vb = cfm.voicebox
    vocab = vb.num_cond_tokens
    with torch.device("cuda"):
        vb32 = vbt.VoiceBox(audio_enc_dec=cfm.codec,
                            **{**FLAGSHIP, "num_cond_tokens": vocab}).eval()
    vb32.load_state_dict(vb.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    x, cond = (torch.randn(2, FRAMES, 128, generator=gen, device="cuda") for _ in range(2))
    kw = dict(times=torch.full((2,), 0.5, device="cuda"), cond=cond,
              cond_token_ids=torch.randint(0, vocab, (2, FRAMES), generator=gen, device="cuda"),
              cond_drop_mask=torch.tensor([False, True], device="cuda"))

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    qvb = cfm._serving_voicebox("w8a16", None)
    inputs = []
    hooks = [block[j].register_forward_pre_hook(
                 lambda _, args, kwargs, at=(i, j): inputs.append((at, args, kwargs)),
                 with_kwargs=True)
             for i, block in enumerate(vb.transformer.layers) for j in (3, 5)]
    rows = []  # (ratio, module, quantized vs bf16, floor, quantized vs fp32)
    with torch.no_grad():
        try:
            vb(x, **kw)
        finally:
            for h in hooks:
                h.remove()
        before = w8a16_matmul.launches
        for (i, j), args, kwargs in inputs:
            y16 = vb.transformer.layers[i][j](*args, **kwargs)
            yq = qvb.transformer.layers[i][j](*args, **kwargs)
            y32 = vb32.transformer.layers[i][j](*(a.float() for a in args), **kwargs)
            q_err, floor = rel(yq, y16), rel(y16, y32)
            rows.append((q_err / floor, f"layers.{i}.{'attn' if j == 3 else 'ff'}", q_err,
                         floor, rel(yq, y32)))
        launched = w8a16_matmul.launches - before
    torch.cuda.synchronize()
    del inputs
    for kind in ("attn", "ff"):
        part = [r for r in rows if r[1].endswith(kind)]
        worst = max(part)
        log("engine", f"per module, {kind} x {len(part)} (2 x {FRAMES} frames, unit qk gains, "
                      f"same input each): quantized w8a16 vs bf16 ||err|| / ||ref|| max "
                      f"{max(r[2] for r in part):.4f}, vs fp32 max {max(r[4] for r in part):.4f}; "
                      f"floor bf16 vs fp32 {min(r[3] for r in part):.4f}-"
                      f"{max(r[3] for r in part):.4f}; largest ratio {worst[0]:.2f} at {worst[1]} "
                      f"({worst[2]:.4f} vs floor {worst[3]:.4f}; tol {QUANT_MODULE_TOL:g} x floor)")
    log("engine", f"per-module check: K4 launches {launched} on {smi}")
    assert launched == 4 * FLAGSHIP["depth"], f"{launched} K4 launches over the modules"
    assert all(math.isfinite(r[2]) and r[0] <= QUANT_MODULE_TOL for r in rows), (
        f"a quantized module is further from bf16 than {QUANT_MODULE_TOL:g} x the floor: "
        f"{max(rows)}"
    )

    gain = 0.5
    for model in (vb, vb32):
        _soften_qk_gains(model, gain)  # in place: the next quantized copy is made anew
    qvb = cfm._serving_voicebox("w8a16", None)
    with torch.no_grad():
        yq, y16, y32 = (model(x, **kw) for model in (qvb, vb, vb32))
    q_err, floor, q32 = rel(yq, y16), rel(y16, y32), rel(yq, y32)
    log("engine", f"one whole denoiser forward (2 x {FRAMES} frames, qk gains {gain}), for "
                  f"information: quantized w8a16 vs bf16 ||err|| / ||ref|| {q_err:.4f}, vs fp32 "
                  f"{q32:.4f}; bf16 vs fp32 on the same weights {floor:.4f}")
    assert all(math.isfinite(v) for v in (q_err, floor, q32)), "non-finite forward"
    del vb32, qvb
    cfm._serving_copy = None


ENGINE_REPEATS = 5  # requests per bucket group: latency reads as min and median
BATCHER_ROUNDS = 3  # rounds of four concurrent submits


def phase_engine(smi: str) -> tuple:
    cfm = seeded(_engine_flagship, SEED + 12).eval()
    engine = vbt.TTSEngine(cfm, **ENGINE)
    codec = cfm.codec
    sr = codec.sampling_rate
    t_warm = engine.warmup()
    log("engine", f"flagship bf16 denoiser (dim 512 depth 24 4x128, "
                  f"{engine._tokenizer().vocab_size} phoneme tokens) + DurationPredictor (dim "
                  f"512 depth {DP_DEPTH} 8x64 fp32) behind TTSEngine({ENGINE}): warmup of "
                  f"{len(engine.batch_buckets) * len(engine.text_buckets)} buckets in "
                  f"{t_warm:.2f} s (kernel builds done in phase 2)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    # what the predictor gives each group, and its time, before the counted run
    expected = [_expected_lengths(engine, texts) for texts in ENGINE_REQUESTS]
    dp_ms = [_host_times_ms(lambda t=texts: engine._predict_durations(_group_ids(engine, t)),
                            ENGINE_REPEATS) for texts in ENGINE_REQUESTS]
    per_group = {"k1": K1_PER_GROUP, "k2": 0, "k3": 0, "k4": K4_PER_GROUP}

    calls = []  # (texts, clips) of each engine call the batcher makes
    synthesize = engine.synthesize

    def recorded(texts, **kw):
        out = synthesize(texts, **kw)
        calls.append((list(texts), out))
        return out

    def request(texts, want_lens):
        """(latency ms, horizon s) of one bucket group, checked."""
        before = read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio, lens = synthesize(texts, generator=gen, return_lengths=True)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        launched = {k: v - before[k] for k, v in read_launches().items()}
        assert launched == per_group, f"a bucket group launched {launched}, want {per_group}"
        assert bool(torch.isfinite(audio).all()), "non-finite audio"
        assert lens.tolist() == want_lens, f"lengths {lens.tolist()} != {want_lens}"
        return dt, audio.shape[-1] / sr

    def batcher_round(batcher):
        futures = {}
        threads = [threading.Thread(target=lambda t=t: futures.__setitem__(t, batcher.submit(t)))
                   for t in BATCHER_TEXTS]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert len(futures) == len(BATCHER_TEXTS)
        for f in futures.values():
            f.result(timeout=600)

    reset_launches()  # the quantized duration-mode path's run starts here
    with shape_tally() as tally:
        runs = [[request(texts, want_lens) for _ in range(ENGINE_REPEATS)]
                for texts, want_lens in zip(ENGINE_REQUESTS, expected)]
        engine.synthesize = recorded
        with vbt.DynamicBatcher(engine, max_wait_ms=100.0, seed=SEED) as batcher:
            batcher_ms = _host_times_ms(lambda: batcher_round(batcher), BATCHER_ROUNDS)
        del engine.synthesize
    counts = read_launches()  # the path's run ends here
    groups = len(ENGINE_REQUESTS) * ENGINE_REPEATS + batcher.stats["batches"]
    assert counts == {k: v * groups for k, v in per_group.items()}, (
        f"{groups} bucket groups launched {counts}, want {per_group} each"
    )
    for kernel in ("k1", "k4"):
        tallied = sum(c for key, c in tally.items() if key[0] == kernel)
        assert tallied == counts[kernel], f"{kernel}: {tallied} calls, {counts[kernel]} launches"

    for texts, want_lens, run, dp in zip(ENGINE_REQUESTS, expected, runs, dp_ms):
        lat, horizon_s = [dt for dt, _ in run], run[0][1]
        valid_s = sum(want_lens) / sr
        med = float(np.median(lat))
        log("engine", f"request batch {len(texts)}: horizon {horizon_s:.2f} s, lengths "
                      f"{want_lens} = masked duration sums x {codec.downsample_factor}; latency "
                      f"over {ENGINE_REPEATS} requests {_min_median(lat)} (all "
                      f"{[round(t, 2) for t in lat]}), RTF of the horizon min "
                      f"{min(lat) / 1e3 / horizon_s:.5f} median {med / 1e3 / horizon_s:.5f}, of "
                      f"the valid audio ({valid_s:.2f} s) median {med / 1e3 / valid_s:.5f}; "
                      f"duration predictor alone {_min_median(dp)} = {np.median(dp) / med:.3f} "
                      f"of the median request; K1/K4 launches {per_group['k1']}/"
                      f"{per_group['k4']} each on {smi}")

    assert batcher.stats["batches"] == len(calls) >= BATCHER_ROUNDS
    assert sum(len(texts) for texts, _ in calls) == BATCHER_ROUNDS * len(BATCHER_TEXTS)
    for texts, clips in calls:  # the predictor runs again here, after the counted run
        for clip, n in zip(clips, _expected_lengths(engine, texts)):
            assert bool(torch.isfinite(clip).all()) and clip.shape[-1] == n, (
                f"clip of {tuple(clip.shape)}, expected {n} samples"
            )
    log("engine", f"DynamicBatcher: {BATCHER_ROUNDS} rounds of {len(BATCHER_TEXTS)} concurrent "
                  f"submits served as {batcher.stats['batches']} bucket group(s) "
                  f"{[len(texts) for texts, _ in calls]} (mean occupancy "
                  f"{batcher.mean_occupancy:.2f}); a round {_min_median(batcher_ms)} (all "
                  f"{[round(t, 2) for t in batcher_ms]}); first group's clips "
                  f"{[clip.shape[-1] for clip in calls[0][1]]} samples = masked "
                  f"duration sums x {codec.downsample_factor}; path totals {counts}; launches by "
                  f"shape { {(k[0], k[1], str(k[2])[6:]): c for k, c in tally.items()} }")

    prof = _profile(lambda: engine.synthesize(list(ENGINE_REQUESTS[0]), generator=gen))
    idle = prof["idle"]
    log("engine", f"profiled batch-1 request: wall {prof['wall_ms']:.2f} ms, device busy "
                  f"{prof['busy_ms']:.2f} ms over {prof['kernels']} kernels, idle share "
                  f"{'not measured' if idle is None else f'{idle:.3f}'}; largest (name, ms, "
                  f"calls): {'; '.join(f'{n} {t:.3f} {c}' for n, t, c in prof['top'])}")
    _quantized_gap(cfm, smi)
    del cfm, engine
    torch.cuda.empty_cache()
    return counts, tally


def _profile(step) -> dict:
    """One call of `step` (a training step, a request) under torch.profiler:
    the host wall time, the union of the device's kernel intervals (busy),
    the idle share 1 - busy / wall, the number of device kernels and the
    largest kernels by device time. The idle share is None when the profiler
    saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device activity only: the profiler also puts each record_function range
    # (such as the optimizer's step) on the device's timeline
    kernels_ = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels_)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels_:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "kernels": len(kernels_),
            "idle": 1.0 - busy / wall_us if spans else None,
            "top": [(name[:60], t / 1e3, n) for name, (t, n) in top]}


def phase_train(smi: str) -> dict:
    def build():
        vb = vbt.VoiceBox(dim_in=LATENT_DIM, dtype=torch.bfloat16, param_dtype=torch.float32,
                          **FLAGSHIP)
        return vbt.ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2)

    cfm = seeded(build, SEED + 6)
    rs = np.random.RandomState(SEED + 7)
    items = [(rs.randn(TRAIN_FRAMES, LATENT_DIM).astype(np.float32),
              rs.randint(0, FLAGSHIP["num_cond_tokens"], TRAIN_FRAMES).astype(np.int32))
             for _ in range(40)]
    trainer = vbt.VoiceBoxTrainer(
        cfm, batch_size=TRAIN_BATCH, dataset=vbt.ArrayDataset(items), num_train_steps=1000,
        lr=1e-4, wd=1e-2, max_grad_norm=0.5, valid_frac=0.2, log_every=1000,
        save_results_every=1000, seed=SEED,
    )
    n_params = sum(p.numel() for p in trainer.params)
    watched = {n: p.detach().clone() for n, p in trainer.named_params
               if n in ("to_embed.weight", "transformer.layers.23.3.to_qkv.weight")}
    depth = FLAGSHIP["depth"]
    for _ in range(TRAIN_WARMUP):  # step 0 also runs the validation batch
        trainer.train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()  # the training path's run starts here
    logs, host_s = [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t_all = time.perf_counter()
    start.record()
    for _ in range(TRAIN_TIMED):
        before = read_launches()
        t0 = time.perf_counter()
        logs.append(trainer.train_step())
        host_s.append(time.perf_counter() - t0)
        after = read_launches()
        step_launches = {k: after[k] - before[k] for k in after}
        assert step_launches == {"k1": depth, "k2": depth, "k3": depth, "k4": 0}, (
            f"a training step launched {step_launches}, expected {depth} of each"
        )
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    counts = read_launches()
    gpu_ms = start.elapsed_time(end)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    losses = torch.stack([lg["loss"] for lg in logs]).tolist()
    norms = torch.stack([lg["grad_norm"] for lg in logs]).tolist()
    assert all(math.isfinite(x) for x in losses + norms), f"non-finite {losses} {norms}"
    moved = {n: (p.detach() - watched[n]).abs().max().item() for n, p in trainer.named_params
             if n in watched}
    assert all(m > 0 for m in moved.values()), f"parameters did not change: {moved}"
    prof = _profile(trainer.train_step)
    idle = prof["idle"]
    log("train", f"flagship: dim 512 depth 24 heads 4x128, bf16 compute, fp32 params "
                 f"({n_params / 1e6:.1f} M) and AdamW, batch {TRAIN_BATCH} x {TRAIN_FRAMES} "
                 f"frames + 16 registers; {TRAIN_TIMED} timed steps after {TRAIN_WARMUP} "
                 f"warm-up: losses {[round(x, 4) for x in losses]}, grad norms "
                 f"{[round(x, 3) for x in norms]}, launches per step K1/K2/K3 {depth}/{depth}/"
                 f"{depth}; max |change| of watched weights {moved}")
    log("train", f"steps/s {TRAIN_TIMED / (gpu_ms / 1e3):.3f} (CUDA events, "
                 f"{gpu_ms / TRAIN_TIMED:.2f} ms/step), {TRAIN_TIMED / wall:.3f} (host clock, "
                 f"steps {[round(t * 1e3, 1) for t in host_s]} ms); idle share of one profiled "
                 f"step {'not measured' if idle is None else f'{idle:.3f}'}; peak memory "
                 f"{peak_gib:.2f} GiB (max_memory_allocated) on {smi}")
    log("train", f"profiled step: wall {prof['wall_ms']:.2f} ms, device busy "
                 f"{prof['busy_ms']:.2f} ms over {prof['kernels']} kernels; largest (name, "
                 f"ms, calls): {'; '.join(f'{n} {t:.3f} {c}' for n, t, c in prof['top'])}")
    return counts, trainer


WITNESS_DELTA = 2.0 ** -20  # the noise floor's change of the attention scale


def _plain_attention(factor: float = 1.0):
    """Autograd of the plain `reference_attention`, its scale times `factor`."""
    def attend(q, k, v, mask=None, scale=None):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        return reference_attention(q, k, v, mask, scale * factor)
    return attend


def _flagship_grads(cfm, params, batch, seed: int, attend=None):
    """Loss and gradient of one flagship batch, the span and CFG masks, the
    noise and the times drawn from a generator seeded with `seed`; every
    attention call through K1/K2/K3, or through `attend` in its place."""
    x, mask, ids = batch
    kernel_path = attention_module.flash_attention
    if attend is not None:
        attention_module.flash_attention = attend
    try:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        loss = cfm.loss_fn(x, mask=mask, cond_token_ids=ids, generator=gen)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        attention_module.flash_attention = kernel_path
    return loss.item(), [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]


def _grad_gap(a, b, watch: dict) -> dict:
    """How far gradient b lies from gradient a: the losses' relative
    difference, the global norms' ratio, the cosine of the whole gradient
    vectors, and the norm ratio and cosine of each watched leaf."""
    (loss_a, ga), (loss_b, gb) = a, b
    dots = torch.stack([(x.double() * y.double()).sum() for x, y in zip(ga, gb)])
    na = torch.stack([x.double().norm() for x in ga])
    nb = torch.stack([y.double().norm() for y in gb])
    leaf_cos = dots / (na * nb).clamp_min(1e-300)
    return {
        "loss": abs(loss_b - loss_a) / abs(loss_a),
        "norm": nb.norm().item() / na.norm().item(),
        "cos": dots.sum().item() / (na.norm() * nb.norm()).item(),
        "leaves": {tag: (nb[i].item() / na[i].item(), leaf_cos[i].item())
                   for tag, i in watch.items()},
        "norms": (na.norm().item(), nb.norm().item()),
        "leaf_norms": {tag: na[i].item() for tag, i in watch.items()},
    }


def _fmt_gap(g: dict) -> str:
    return (f"loss {g['loss']:.2e}, global norm ratio {g['norm']:.6f}, cosine {g['cos']:.6f}; "
            f"to_qkv by layer (norm ratio, cosine) "
            + ", ".join(f"{t}: {r:.3f} {c:.4f}" for t, (r, c) in g["leaves"].items()))


# (loss, global norm, cosine) limits of the kernels-vs-plain gap in fp32
# with qk gains 0.25, where the gradient is well conditioned: the loss and
# the global norm relative, the cosine of the whole gradient and of each
# watched leaf
WITNESS_TOL = (1e-5, 1e-4, 0.9999)


def phase_grad_witness(trainer, smi: str) -> None:
    """The flagship's gradient through K1/K2/K3 against the plain attention
    on the card: the trainer's weights, one training batch and the same
    draws, computing in bf16 (the trained configuration) and in fp32 (the
    same weights in a VoiceBox computing in fp32). The noise floor is the
    plain attention against itself with its scale moved by 2^-20 either way,
    a change the size of the logits' summation-order rounding.

    With unit qk gains (logits up to 10 d), and in bf16 whatever the gains,
    the floor shows that no two computations of this gradient agree in its
    direction: the checks there are that the kernels stay as close to the
    plain version as the floor shows the plain version stays to itself, in
    the loss, in the last layer's gradient norm and in the global norm's
    order of magnitude. In fp32 with the qk gains set to 0.25 (logits up to
    80) the gradient is well conditioned and the kernels must match the
    plain version within WITNESS_TOL; the global norm within the larger of
    its tolerance and the floor's own distance from 1: at the weights phase
    10 trains, a 2^-20 change of the plain version's scale can move the
    global norm by more than 1e-4."""
    batch = trainer._next_batch(trainer.dl_iter)
    names = [n for n, _ in trainer.named_params]
    state = trainer.cfm_wrapper.voicebox.state_dict()

    def build_f32():
        vb = vbt.VoiceBox(dim_in=LATENT_DIM, dtype=torch.float32, param_dtype=torch.float32,
                          **FLAGSHIP)
        return vbt.ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2)

    cfm32 = seeded(build_f32, SEED + 8)
    cfm32.voicebox.load_state_dict(state)
    cfm32.train()
    params32 = [p for _, p in cfm32.voicebox.named_parameters() if p.requires_grad]
    depth = FLAGSHIP["depth"]
    last = str(depth - 1)
    watch = {str(i): names.index(f"transformer.layers.{i}.3.to_qkv.weight")
             for i in [*range(0, depth - 1, max(depth // 4, 1)), depth - 1]}
    models = (("bf16", trainer.cfm_wrapper, trainer.params), ("f32", cfm32, params32))
    failed = []
    for gains in ("unit", "0.25"):
        if gains == "0.25":
            for _, cfm, _ in models:
                _soften_qk_gains(cfm.voicebox)
        for label, cfm, params in models:
            def grads(attend=None):
                return _flagship_grads(cfm, params, batch, SEED + 9, attend)

            plain = grads(_plain_attention())
            gap = _grad_gap(plain, grads(), watch)
            floors = [_grad_gap(plain, grads(_plain_attention(1 + s * WITNESS_DELTA)), watch)
                      for s in (1, -1)]
            torch.cuda.synchronize()
            name = f"{label} compute, qk gains {gains}"
            log("witness", f"flagship gradient, {name}, same weights, batch and draws; "
                           f"plain attention on the card: loss {plain[0]:.6f}, global norm "
                           f"{gap['norms'][0]:.4e}, to_qkv norm by layer "
                           f"{ {t: f'{v:.3e}' for t, v in gap['leaf_norms'].items()} } on {smi}")
            log("witness", f"{name}: K1/K2/K3 vs plain: {_fmt_gap(gap)}")
            for s, floor in zip(("+", "-"), floors):
                log("witness", f"{name}: noise floor, plain with scale x (1 {s} 2^-20) vs "
                               f"plain: {_fmt_gap(floor)}")
            ok = all(math.isfinite(x) and x > 0 for g in [gap] + floors for x in g["norms"])
            if gains == "unit" or label == "bf16":
                # the floor's own spread: the loss within 1e-2, the last layer's
                # norm within 25%, the global norm within two orders of magnitude
                ok = ok and (gap["loss"] <= 1e-2 and 0.8 <= gap["leaves"][last][0] <= 1.25
                             and 1e-2 <= gap["norm"] <= 1e2)
            else:
                loss_tol, norm_tol, cos_tol = WITNESS_TOL
                norm_tol = max(norm_tol, *(abs(f["norm"] - 1) for f in floors))
                ok = ok and (gap["loss"] <= loss_tol and abs(gap["norm"] - 1) <= norm_tol
                             and gap["cos"] > cos_tol
                             and min(c for _, c in gap["leaves"].values()) > cos_tol)
                log("witness", f"{name}: tol loss {loss_tol:g}, global norm {norm_tol:.3g} "
                               f"(the larger of {WITNESS_TOL[1]:g} and the floor's), cosines > "
                               f"{cos_tol:g}")
            if not ok:
                failed.append(name)
            del plain
    del cfm32, params32
    torch.cuda.empty_cache()
    assert not failed, f"the flagship gradient through the kernels disagrees with the plain " \
                       f"attention: {failed}"


def _path_row(kernel: str, name: str, parts) -> dict:
    """The row of one kernel on the quantized duration-mode path from the
    shapes that path gave it: parts is [(launches, timed result)]. Times and
    bounds are means per launch, weighted by each shape's launches, so that
    launches x ms is the kernel's device time on the path; bound_by is that
    of the shape that holds most of the weighted bound."""
    total = sum(c for c, _ in parts)

    def mean(key):
        return sum(c * r[key] for c, r in parts) / total

    heaviest = max(parts, key=lambda p: p[0] * p[1]["bound_ms"])[1]
    return {
        "name": name, "path": "serve_w8a16", "route": "cuda", "source": SOURCES[kernel],
        "replaces": REPLACES[kernel], "launches": total,
        "max_abs_err": max(r["max_abs_err"] for _, r in parts),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
        "bound_by": heaviest["bound_by"], "library_ms": mean("library_ms"),
        "timed_as": "mean per launch over the path's shapes, weighted by their launches",
        "per_shape": [{"shape": list(r["shape"]), "dtype": str(r["dtype"])[6:], "launches": c,
                       **{k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                            "bound_by", "max_abs_err", "int8pack_ms")
                          if k in r}}
                      for c, r in parts],
    }


def engine_rows(k1: dict, k4: dict, tally) -> list:
    """The K1 rows (the denoiser's bf16 calls, the duration predictor's fp32
    calls) and the K4 row of the quantized duration-mode path, each from the
    shapes the path launched it at (`shape_tally`). Fails if the path ran a
    kernel at a shape that phases 3 and 5 did not hold against the plain
    version and time."""
    by_role = {"denoiser": [], "predictor": [], "k4": []}
    for key, count in sorted(tally.items(), key=str):
        if key[0] == "k1":
            _, shape, dtype, masked = key
            found = [r for r in k1.values() if tuple(r["shape"]) == shape
                     and r["dtype"] == dtype and r["masked"] == masked and "ms" in r]
            role = "denoiser" if dtype == torch.bfloat16 else "predictor"
        else:
            _, shape, dtype = key
            found = [k4[shape]] if dtype == torch.bfloat16 and shape in k4 else []
            role = "k4"
        assert found, f"the path ran {key[0]} at {shape} {dtype}, which no check timed"
        by_role[role].append((count, {**found[0], "dtype": dtype}))
    return [_path_row("k1", f"{NAMES['k1']}[serve_w8a16]", by_role["denoiser"]),
            _path_row("k1", f"{NAMES['k1']}[serve_w8a16_duration_predictor]",
                      by_role["predictor"]),
            {**_path_row("k4", NAMES["k4"], by_role["k4"]),
             "library": "cuBLAS bf16 on the weight dequantized ahead of time"}]


def _k23_timed_row(r: dict, kernel: str) -> dict:
    """K2's or K3's numbers at one timed shape of phase 4 (the plain version
    and SDPA's backward give dq, dk and dv together)."""
    bound_ms, bound_by = r["bounds"][kernel]
    t = r["times"]
    return {"shape": list(r["shape"]), "dtype": str(r["dtype"])[6:], "ms": t[kernel],
            "plain_ms": t["plain"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": t["sdpa_bwd"], "fwd_bwd_ms": t["ours_fwd_bwd"],
            "library_fwd_bwd_ms": t["sdpa_fwd_bwd"]}


def kernel_line(k1, k23, serve_k1, engine, train_counts) -> str:
    """One row per kernel and main path: K1 on the serving path (timed at the
    serving shape), on the quantized duration-mode path (`engine_rows`: the
    denoiser's and the duration predictor's calls) and on the training path
    (at the training shape); K2 and K3 on the training path; K4 on the
    quantized duration-mode path."""
    rows = []
    for path, case, launches in (("serve", "flagship_cfg_bf16", serve_k1),
                                 ("train", "train_bf16", train_counts["k1"])):
        r = k1[case]
        rows.append({
            "name": f"{NAMES['k1']}[{path}]", "path": path, "route": "cuda",
            "source": SOURCES["k1"], "replaces": REPLACES["k1"], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": list(r["shape"]),
            "dtype": str(r["dtype"])[6:],
        })
    rows += engine[:2]
    train = k23["train_bf16"]
    for kk in ("k2", "k3"):
        rows.append({
            "name": NAMES[kk], "path": "train", "route": "cuda", "source": SOURCES[kk],
            "replaces": REPLACES[kk], "launches": train_counts[kk],
            # K3's error is the larger of dk's and dv's
            "max_abs_err": train["max_abs_err"][0] if kk == "k2" else max(
                train["max_abs_err"][1:]),
            **_k23_timed_row(train, kk),
            "plain_and_library_compute": "dq, dk and dv together",
            "reference_split": _k23_timed_row(k23["reference_split_bf16"], kk),
        })
    rows.append(engine[2])
    return json.dumps({"kernels": rows})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.manual_seed(SEED)
    smi = phase_device()
    phase_build()
    k1 = phase_k1_check(smi)
    k23 = phase_k23_check(smi)
    k4 = phase_k4_check(smi)
    phase_slice_card_vs_cpu()
    phase_slice_card_vs_cpu(quantize="w8a16")
    phase_train_card_vs_cpu()
    serve_k1 = phase_serve(smi)
    assert serve_k1 > 0, "the serving path launched K1 no time"
    engine_counts, tally = phase_engine(smi)
    assert engine_counts["k1"] > 0 and engine_counts["k4"] > 0, (
        f"the quantized duration-mode path skipped a kernel: {engine_counts}"
    )
    engine = engine_rows(k1, k4, tally)
    train_counts, trainer = phase_train(smi)
    assert min(train_counts[k] for k in ("k1", "k2", "k3")) > 0, (
        f"the training path skipped a kernel: {train_counts}"
    )
    phase_grad_witness(trainer, smi)
    del trainer
    print(kernel_line(k1, k23, serve_k1, engine, train_counts), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
