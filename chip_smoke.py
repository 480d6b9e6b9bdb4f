#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`voicebox_tpu_torch`) on one NVIDIA GPU.

Run it from the root of a checkout: `python3 chip_smoke.py`. It needs one
Hopper card (compute capability 9.x), nvcc and PyTorch built for CUDA; it
imports nothing of JAX. Its phases print one line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: K1 (`voicebox_tpu_torch/csrc/flash_attention_fwd.cu`) built by
   nvcc for sm_90a from the checkout, and the build time;
3. K1 check: K1 against its plain PyTorch version on the card, at the
   serving shapes and on masked and ragged inputs, each case with its
   tolerance; CUDA-event times of both at the two serving shapes;
4. slice, card vs CPU: a small fp32 configuration sampled on the card (K1)
   and on the CPU (the plain version) from the same weights and noise;
   latents, RVQ codes and audio compared;
5. serve: the flagship geometry in bf16 (dim 512, depth 24, 4 x 128 heads,
   EncodecVoco with RVQ 8 x 1024 x 128 and the vocos-encodec-24khz
   geometry) answers requests of 750 frames (10 s of 24 kHz audio) at
   batch 1 and 2; each must give finite (b, 1, 240000) audio through
   exactly depth x 4 = 96 K1 launches;
6. one JSON line for the kernels, then the last line
   `{"ok": true, "device": {...}}`.

Any failed check raises, so the process exits nonzero and prints no result.
Weights are random, made from a seed.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

import torch

import voicebox_tpu_torch as vbt
from voicebox_tpu_torch import kernels
from voicebox_tpu_torch.models.codec import EncodecVoco
from voicebox_tpu_torch.models.encodec import ResidualVQ
from voicebox_tpu_torch.models.primitives import l2norm
from voicebox_tpu_torch.models.vocos import Vocos
from voicebox_tpu_torch.ops.flash_attention import flash_attention, reference_attention

SEED = 0
K1_SOURCE = "voicebox_tpu_torch/csrc/flash_attention_fwd.cu"
K1_REPLACES = "voicebox_tpu/ops/flash_attention.py:105"

# (name, (b, h, n, kv, d), dtype, inputs, mask, atol, rtol). "serving": q and k
# qk-normed to norm sqrt(d) with scale 10, as the denoiser calls K1 (logits up
# to 10 d); "randn": unit normals with scale d^-0.5, a softer softmax.
# bf16 tolerance: P and out are each rounded to bf16 (2^-8 relative) on both
# sides, in another order. fp32 tolerance: logits up to 1280 carry ~1e-4 of
# summation-order rounding, which moves exp() by as much relative.
K1_CASES = [
    ("flagship_cfg_bf16", (2, 4, 766, 766, 128), torch.bfloat16, "serving", None, 1e-2, 1e-2),
    ("reference_split_bf16", (2, 16, 1040, 1040, 64), torch.bfloat16, "serving", None, 1e-2, 1e-2),
    ("flagship_cfg_f32", (2, 4, 766, 766, 128), torch.float32, "serving", None, 1e-3, 1e-3),
    ("reference_split_f32", (2, 16, 1040, 1040, 64), torch.float32, "serving", None, 1e-3, 1e-3),
    ("mask_empty_row_bf16", (3, 4, 300, 300, 128), torch.bfloat16, "randn", "empty_row", 1e-2, 1e-2),
    ("mask_empty_row_f32", (3, 4, 300, 300, 64), torch.float32, "randn", "empty_row", 1e-5, 1e-5),
    ("ragged_257_bf16", (2, 4, 257, 257, 64), torch.bfloat16, "randn", "random", 1e-2, 1e-2),
    ("ragged_257_f32", (2, 4, 257, 200, 128), torch.float32, "randn", "random", 1e-5, 1e-5),
]
TIMED_CASES = ("flagship_cfg_bf16", "reference_split_bf16")

FLAGSHIP = dict(
    num_cond_tokens=500, dim_cond_emb=512, dim=512, depth=24, dim_head=128, heads=4,
    num_register_tokens=16, attn_qk_norm=True, condition_on_text=True,
)
FRAMES = 750  # 10 s at 24 kHz, hop 320
STEPS, CFG_SCALE = 3, 1.3
EVALS_PER_REQUEST = 2 * (STEPS - 1)  # midpoint: two evaluations per interval


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
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    major, minor = torch.cuda.get_device_capability(0)
    assert major == 9, f"K1 is built for sm_90a; this card is sm_{major}{minor}"
    # the fp32 phases compare against fp32 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log("device", f"{name} sm_{major}{minor} count={torch.cuda.device_count()} "
                  f"torch={torch.__version__} cuda={torch.version.cuda} | {smi}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = kernels.build("flash_attention_fwd")
    kernels.load("flash_attention_fwd")
    dt = time.perf_counter() - t0
    ptxas = [
        line.strip() for line in open(f"{lib}.log")
        if "registers" in line or "spill" in line
    ]
    log("build", f"K1 {lib.name} nvcc {' '.join(kernels.NVCC_FLAGS)} in {dt:.2f} s; "
                 f"ptxas: {' | '.join(ptxas)}")


def _k1_inputs(shape, dtype, inputs, mask_kind, gen):
    b, h, n, kv, d = shape
    dev = "cuda"
    q, k, v = (torch.randn(b, h, m, d, generator=gen, device=dev) for m in (n, kv, kv))
    scale = d ** -0.5
    if inputs == "serving":
        q, k = (l2norm(t) * d ** 0.5 for t in (q, k))
        scale = 10.0
    mask = None
    if mask_kind is not None:
        mask = torch.rand(b, kv, generator=gen, device=dev) < 0.7
        if mask_kind == "empty_row":
            mask[-1] = False  # every key of the last batch element masked
    return q.to(dtype), k.to(dtype), v.to(dtype), mask, scale


def phase_k1_check(smi: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for name, shape, dtype, inputs, mask_kind, atol, rtol in K1_CASES:
        q, k, v, mask, scale = _k1_inputs(shape, dtype, inputs, mask_kind, gen)
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
        results[name] = {"max_abs_err": err.max().item()}
        if name in TIMED_CASES:
            run_k1 = lambda: flash_attention(q, k, v, mask, scale)  # noqa: E731
            run_plain = lambda: reference_attention(q, k, v, mask, scale)  # noqa: E731
            plain_a, k1_a, k1_b, plain_b = (
                cuda_ms(f) for f in (run_plain, run_k1, run_k1, run_plain)
            )
            results[name].update(ms=(k1_a + k1_b) / 2, plain_ms=(plain_a + plain_b) / 2)
            log("k1", f"time {name}: K1 {results[name]['ms']:.4f} ms, plain "
                      f"{results[name]['plain_ms']:.4f} ms (CUDA events, mean of 20, "
                      f"order plain/K1/K1/plain) on {smi}")
    return results


def _small_slice():
    codec = EncodecVoco(
        quantizer=ResidualVQ(num_quantizers=4, codebook_size=64, dim=32),
        vocos=Vocos(input_channels=32, dim=64, intermediate_dim=96, num_layers=2,
                    n_fft=64, hop_length=16, num_bandwidths=4, codebook_size=64,
                    num_quantizers=4),
        ratios=(2, 2, 2, 2),
    )
    vb = vbt.VoiceBox(num_cond_tokens=100, audio_enc_dec=codec, dim_cond_emb=64, dim=128,
                      depth=2, dim_head=64, heads=2, num_register_tokens=4)
    # qk-norm scales q and k to norm sqrt(d) and the logits by 10, so with unit
    # gains they reach 10 d = 640 and the softmax is nearly an argmax: a 1e-6
    # change of y0 then moves the latents by 1e-2 (measured on the CPU). Gains
    # of 0.25 (logits up to 40) keep the comparison about rounding, not ties.
    for name, p in vb.named_parameters():
        if name.endswith(("q_norm.gamma", "k_norm.gamma")):
            torch.nn.init.constant_(p, 0.25)
    return vbt.ConditionalFlowMatcherWrapper(vb)


def phase_slice_card_vs_cpu() -> None:
    cfm_cpu = seeded(_small_slice, SEED).eval()
    cfm_gpu = copy.deepcopy(cfm_cpu).to("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    b, n = 2, 96
    cond = torch.randn(b, n, 32, generator=gen)
    ids = torch.randint(0, 100, (b, n), generator=gen)
    y0 = torch.randn(b, n, 32, generator=gen)
    kw = dict(semantic_token_ids=ids, cond=cond, steps=STEPS, cond_scale=CFG_SCALE,
              noise=y0, decode_to_audio=False)

    before = flash_attention.launches
    lat_cpu = cfm_cpu.sample(**kw)
    assert flash_attention.launches == before, "the CPU run must not launch K1"
    lat_gpu = cfm_gpu.sample(**{k: v.cuda() if torch.is_tensor(v) else v for k, v in kw.items()})
    torch.cuda.synchronize()
    launches = flash_attention.launches - before
    assert launches == 2 * EVALS_PER_REQUEST, f"expected {2 * EVALS_PER_REQUEST} K1 launches, got {launches}"
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
                 f"cfg {CFG_SCALE}: K1 launches {launches}, latents max_abs_err {lat_err:.3e} "
                 f"(tol 1e-3), RVQ codes equal {code_agree:.4f} (tol >= 0.99), audio from "
                 f"the same latents max_abs_err {audio_err:.3e} (tol 1e-3 x peak {peak:.3e})")
    assert math.isfinite(lat_err) and lat_err <= 1e-3, "latents disagree card vs CPU"
    assert code_agree >= 0.99, "RVQ codes disagree card vs CPU"
    assert audio_err <= 1e-3 * peak, "audio disagrees card vs CPU"


def _flagship():
    codec = EncodecVoco()  # RVQ 8 x 1024 x 128, vocos-encodec-24khz geometry
    vb = vbt.VoiceBox(audio_enc_dec=codec, dtype=torch.bfloat16, **FLAGSHIP)
    return vbt.ConditionalFlowMatcherWrapper(vb)


def phase_serve(smi: str) -> int:
    cfm = seeded(_flagship, SEED + 2).eval().to("cuda")
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
    flash_attention.launches = 0  # the main path's run starts here
    for i, batch in enumerate((1, 1, 2, 2)):
        dt, launches = request(batch)
        log("serve", f"request {i} batch {batch}: {FRAMES} frames = {audio_s:.1f} s audio, "
                     f"latency {dt * 1e3:.2f} ms, RTF {dt / audio_s:.5f}, K1 launches "
                     f"{launches}, audio finite {(batch, 1, FRAMES * 320)} on {smi}")
    return flash_attention.launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.manual_seed(SEED)
    smi = phase_device()
    phase_build()
    k1 = phase_k1_check(smi)
    phase_slice_card_vs_cpu()
    launches = phase_serve(smi)
    assert launches > 0, "the main path launched K1 no time"
    flagship = k1["flagship_cfg_bf16"]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": flagship["max_abs_err"], "ms": flagship["ms"],
        "plain_ms": flagship["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
