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
   ptxas's registers and spills per instantiation; fails unless every bf16
   instantiation of K1, K2, K3 and K4 (attention at head dims 64, 128 and
   256, and the chunked kernels past 256) was compiled to wgmma (`HGMMA`)
   and TMA loads (`UTMALDG`), counted in `cuobjdump -sass` of the built
   library, and spills no byte, and no fp32 K1, K2 or K3 instantiation (head
   dims 16 to 256 and past) spills;
3. K1 check: K1 against its plain PyTorch version on the card, at the
   serving and training shapes, at the quantized engine's denoiser and
   duration-predictor shapes, on masked and ragged inputs and at the edges
   of K1's design (kv off the 128-key tile and off 8, a kv that wraps the
   K/V ring many times, masked keys inside a tile, n under one 64-row
   tile), at phase 19's fp32 shapes (head dims 16, 32 and 64) and at the
   fp32 design's edges at head dims 16 and 32 (`k23_f32_edges`, each kind
   of mask), at the head dims the kernels are not built for and run
   zero-padded (bf16 16 and 32, fp32 8: masked, ragged, a fully-masked
   element) and at phase 22's pipeline stage, each case with its
   tolerance; at head dim 256 in both dtypes, phase 15b's shapes and the
   edges of the 64-key design (kv 131, n 40 against kv 300, n = kv = 4100,
   masked runs inside tiles, a fully-masked element under qk-norm), and
   head dim 192 zero-padded to 256 (with SDPA's kernels named at d > 128);
   past 256 (the chunked kernels) in both dtypes, phase 15c's shapes, the
   reference shape (8, 4, 768, 768, 512), a ragged masked call with a
   fully-masked element at d = 320, 512, 576 and 1024, the design's edges
   at 512 and d = 300 zero-padded to 320;
   CUDA-event times of K1, the plain version and SDPA (the padded widths
   beside the built width's launch of the same shape); bf16 K1 at each
   tile height it can take (the host's choice marked); the host time of
   one bf16 K1 call, and what encoding its tensor maps adds to it;
4. K2/K3 check: K2 and K3 against the plain backward and against autograd
   of the plain forward, by the largest error and by the error's norm, at
   the training shape (bf16 qk-normed and randn, fp32), the reference head
   split, ragged n/kv, a fully-masked batch element under qk-norm's scale
   10, the edges of the bf16 design at head dims 64 and 128 (kv off the
   64-row tile and off 8, n under one tile, n and kv of 4100 that wrap the
   ring many times, masked runs inside tiles) and those of the fp32 design
   (`k23_f32_edges`: n and kv at 1 and around its tiles, 64 owned rows and
   64 or 32 streamed, at head dims 16, 32, 64 and 128, under each kind of
   mask; with one key, dq and dk held to a rounding floor), phase 19's
   training shapes, the padded head dims and the pipeline stage as in
   phase 3, head dims 256 and 192 as in phase 3 and the fp32 edges at 256
   (16 streamed rows; under qk-norm at d = 256 each fp32 tolerance is at
   least `logit_floor`, 8 ulps of the largest logit), the cases past 256
   as in phase 3 but the serving call; a second launch on the same
   inputs must give bit-identical dq, dk and dv; CUDA-event times of K2,
   K3, the plain backward and SDPA's backward (each of the two gives dq, dk
   and dv together) and attention forward + backward through K1/K2/K3
   beside SDPA's, at the training shape (bf16 and fp32), the reference head
   split, the mel training shape and the duration predictor's (fp32), with
   the kernels SDPA's fp32 backward launches (K2 and K3 have one tile
   height, 64 owned rows a block);
5. K4 check: K4 against its plain version at the flagship's four quantized
   (k, n) with the engine's m = 544, 2112 and 8320 rows, m = 1532 and the
   ragged m = 37 and 1, in bf16 and fp32, at every tile (bf16) or route
   (fp32: the GEMV's 8x16, 8x8, 8x4 and the 64x64 tiles) the C entry point
   takes; x as the engine hands it over (rows at the GEGLU's pitch of
   1376 at k = 1365) at the front of a buffer that is NaN in the pitch and
   past its end, and a contiguous (1, 1365) x; n = 2730 (y's rows off 16
   bytes); a second launch must give the same bits; CUDA-event times of
   K4 at the host's tile (and at each tile at one shape), the plain version,
   cuBLAS on the weight dequantized to bf16 ahead of time and, where it runs on CUDA,
   `torch._weight_int8pack_mm`, with K4's share of its bound; then fp32 K4
   at the seq2seq decode's shapes at every route, the chosen one timed
   beside cuBLAS fp32 and every route in turns, and the GEMV route against
   the tiled one at m = 32-256 (`phase_k4_decode_check`);
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
9b. long-form serving and cloning at full width on phase 9's engine (same
   seeded weights) with prompt buckets of 3 s and 6 s, windows of 768
   frames overlapping by 128: `warmup()` must have run the two-window
   stream, each prompt bucket's encode and the prompt-conditioned predictor
   at each (batch, text) bucket; first `sample_long` of phase 6's small
   fp32 configuration card vs CPU (3 windows, a latent prompt, the same
   noise); then an over-bucket text whose exact frames (from the seeded
   predictor) reach 2048, i.e. >= 3 windows, through `synthesize_stream`
   (once: time to the first chunk on the host and latency, min and
   median, RTF) and `synthesize`, a clone from a seeded 3 s raw prompt with
   `prompt_text` through `clone_stream` (once) and `clone`, and an
   over-bucket `DynamicBatcher.submit` beside a `submit_clone`. Each request
   makes exactly 96 K1 and 384 K4 launches a window plus 10 K1 a predictor
   forward, every launch's shape tallied and checked; audio is finite and
   exactly the expected length; the streamed decode is held to the one-shot
   decode of the same latents; one profiled stream's idle share;
10. train: the flagship geometry trains at full width (bf16 compute, fp32
   parameters and AdamW, batch 8 x 752 frames + 16 registers) through
   `VoiceBoxTrainer`: 2 warm-up steps, then timed steps, each with exactly
   24 K1, 24 K2 and 24 K3 launches and a finite loss and gradient norm;
   steps/s, the profiled idle share of one step and peak memory;
11. witness: the flagship's gradient through K1/K2/K3 against the plain
   attention on the card, on the seeded weights as they were before phase
   10 trained them, same batch and draws, in bf16 and fp32 compute, with
   unit qk gains and gains of 0.25, beside the noise floor of the plain
   version against itself;
12. levers: the flagship step of phase 10 under five configurations
   trained in turns: (a) as phase 10; (b) bf16 live parameters over the
   fp32 master and bf16 Adam moments; (c) (b) with an EMA (decay 0.999);
   (d) full remat; (e) remat saving the matmuls and K1's outputs
   ("dots+attn_out+attn_lse"). Each step must launch 24 K1 (48 under full
   remat), 24 K2 and 24 K3; steps/s and device ms per step from CUDA
   events, host steps/s and peak memory per configuration. The EMA of (c)
   samples through adaptive Tsit5 (`use_torchode=True`, loose tolerances;
   its step count printed) and fixed-grid Tsit5: finite latents through 24
   K1 launches per evaluation. Then (c) saves after 2 steps and a trainer
   built from other weights loads the file: its third step's loss, every
   parameter, both moments and the EMA must equal the uninterrupted run's
   to the bit. Last, phase 7's small fp32 denoiser with bf16 moments and
   full remat, card against CPU;
13. raw audio, card vs CPU: small fp32 configurations from the same
   weights, waves and draws: mel power and dB, SEANet latents, the SEANet
   decoder and an LSTM compared; MAS exactly equal on one soft alignment
   (most cells exactly 0: ties everywhere); 3 `VoiceBoxTrainer` steps on
   raw waves through a small MelVoco and 3 `DurationPredictorTrainer` steps
   on (text, wave) items, losses and parameters compared;
14. (a) raw-wave mel CFM, BASELINE config 2: the flagship denoiser without
   text on vocos-mel-24khz log-mels (MelVoco), bf16 compute over fp32
   parameters, AdamW, clip 0.5, trains through `VoiceBoxTrainer` on batches
   of 8 x 10 s 24 kHz waves (each step exactly 24 K1, K2 and K3 launches,
   every K1 at a shape phase 3 checked); steps/s and ms per step (CUDA
   events), the codec encode's ms per step, a profiled step's idle share,
   peak memory; then one request from a 10 s raw prompt (3 midpoint steps,
   CFG 1.3) decoded through MelVoco: finite (1, 938 x 256) audio through
   exactly 96 K1 launches;
15. (b) duration training, BASELINE config 4: the reference
   DurationPredictor (dim 512, depth 10, 8 x 64 heads, fp32) with MelVoco
   and its aligner on the 100 mels trains through
   `DurationPredictorTrainer` on batches of 8 (text of 40-120 characters,
   10 s wave) items, phonemes bucketed to 128: each step exactly 10 fp32
   K1, K2 and K3 launches; ms per step, the transformer's, the aligner's,
   MAS's (ms and launches) and the forward-sum loss's times alone, a
   profiled step's busy time, its K1 + K2 + K3 share and idle share, peak
   memory; then the trained predictor drives one
   `sample(texts=...)` through a MelVoco denoiser of the flagship geometry
   conditioned on phoneme ids (10 + 96 K1 launches, finite audio);
15b. head dim 256: (a) the flagship with its attention split as 2 x 256
   instead of 4 x 128 (the same parameters and FLOPs), built on the card
   from a seed: 2 + 3 AdamW steps at batch 8 x 752 frames + 16 registers,
   each exactly 24 K1, K2 and K3 at (8, 2, 768, 768, 256), then one 10 s
   request (midpoint, CFG 1.3, EncodecVoco) through exactly 96 K1 at (2, 2,
   766, 766, 256) to finite audio; steps/s, latency, peak memory and idle
   shares; (b) the reference DurationPredictor's geometry (dim 512, depth
   10, fp32) at 2 x 256 through `DurationPredictorTrainer`: 1 + 2 steps,
   each exactly 10 fp32 K1, K2 and K3 at (8, 2, 128, 128, 256); (c) phase
   7's small fp32 denoiser at 2 x 256, 3 steps card against CPU. Every
   launch at a shape phases 3 and 4 checked and timed;
15c. head dims past 256 (the chunked kernels): (a) the flagship at 2 x
   512 heads (attention 1024 wide), trained (2 + 3 steps, each exactly 24
   K1, K2 and K3 at (8, 2, 768, 768, 512)) and served (one 10 s request,
   96 K1 at (2, 2, 766, 766, 512), finite audio) as 15b (a); (c) phase 7's
   small fp32 denoiser at 1 x 512, 3 steps card against CPU, losses within
   1e-6 relative or, where larger, twice the distance of a CPU run whose
   logits sum in another order, and every update's cosine above 0.9999;
24 (run after 15c). the JAX package's headline configurations: (a) its
   default VoiceBox (dim 1024, depth 24, 16 x 64 heads, 711.1 M
   parameters) built on the card from a seed, 2 + 3 AdamW steps at batch 8
   x 752 frames + 16 registers in three runs: (i) as it is, (ii) under the
   JAX headline's stack (remat "dots+attn_probs+qk_rotary+norm_out", bf16
   Adam moments, `attn_scores_dtype=torch.bfloat16`), (iii) at 8 x 128
   heads; each step exactly 24 K1 (48 under (ii)'s recompute), 24 K2 and 24
   K3; then one 10 s request (96 K1 at (2, 16, 766, 766, 64)); (b) the 100
   s long-context step: the flagship at batch 1 x 7504 frames + 16
   registers (the trainer's grid at 16 frames), 2 + 3 steps of 24 K1, K2
   and K3 at (1, 4, 7520, 7520, 128), and a 100 s request of 7500 frames in
   one window through `sample` (96 K1 at (2, 4, 7516, 7516, 128)); steps/s
   (CUDA events and host clock), a profiled step's or request's busy ms,
   idle share and kernels, peak memory and the state between steps,
   latency and RTF; every launch at a shape phases 3 and 4 checked and
   timed; (c) card against CPU at depth 2 in fp32 as 15c (c): the default's
   16 x 64 heads at dim 1024 on 2 x 128 frames, and the flagship's geometry
   on 1 x 4096 frames (4112 tokens, past the JAX package's 4096-token
   `attend` threshold);
16. (c) `EncodecVoco.encode` of a 10 s wave through the SEANet encoder at
   the Encodec 24 kHz geometry -> (1, 750, 128), then its decode and the
   SEANet decoder's, with their times;
17. the semantic stack, card vs CPU, small fp32 configurations from the
   same weights: HuBERT features (tolerance) and ids (equal except near
   ties of the k-means distance); the TextToSemantic's teacher-forced
   logits; its greedy, speculative, w8a16 and w8a16-speculative decodes,
   equal to the CPU's up to the first position where the CPU's top-2 logit
   gap is under 1e-3 (printed); `sample(texts=)` latents and lengths; three
   `TextToSemanticTrainer` steps, losses and parameter updates;
18. the semantic stack at full width, random weights: HuBERT-base (layer 9,
   500 clusters) on 8 x 10 s; the TextToSemantic (dim 512, 6 + 6 layers, 8 x
   64 heads, fp32, 500 ids) decoding 64 ids: plain greedy and speculative
   (gamma 5, 3 draft layers; equal before the first near tie) with ms and
   kernels per token and the acceptance, and `quantize="w8a16"` (fp32 K4 on
   every decoder matmul) at batch 1 over 64 ids and batch 4 speculative
   over 64, its ms, kernels, device busy and K4 device ms a token beside
   the float decode's, and K4's launch-weighted ms a launch; semantic-mode
   `TTSEngine` (text buckets 64/128, batch buckets 1/2/4, 64 ids,
   `spec_decode`, the flagship bf16 denoiser with w8a16, EncodecVoco):
   warmup, one request at batch 1, four batcher submits, each
   group exactly 6 + 96 K1 and 384 K4 launches, latency, RTF, the decode's
   share, the profiled idle share of the decode and of the denoiser half
   apart; an over-bucket text of two segments (one decode at batch 2) and
   a clone from a 3 s raw prompt whose ids come through HuBERT, each
   window 96 K1 and 384 K4, each decode's encoder 6 K1;
   `TextToSemanticTrainer` at batch 8 of
   (text, 10 s wave) with targets through HuBERT (511 frames, 499 live):
   6 fp32 K1, K2 and K3 a step, ms per step, HuBERT's share, peak memory.
   Every K1 and K4 launch shape of phase 18 must be one that phases 3 and
   5 checked and timed (phase 5 also checks and times fp32 K4 at the
   decode's shapes against cuBLAS fp32);
19. trained weights (`voicebox_tpu_torch/canaries/`): the semantic quality
   canary (HuBERT k-means on four synthetic melodies, a TextToSemantic with
   4 x 16 heads, a CFM denoiser with 4 x 32 heads, 400 + 2000 Adam steps,
   sampled from text with 16 midpoint steps) and the duration canary (a
   DurationPredictor trained with the aligner, MAS and forward-sum, 400 +
   2000 steps, sampled through `sample(texts=)`), each held to
   tests/test_e2e_quality.py's gates: mel-spectral distance under half its
   untrained anchor (a fresh model at seed 99) and under the corpus's
   cross-utterance distance; both denoisers sampled again under w8a16 (fp32
   K4) and held to the first gate; the generalization split (16 train / 4
   held-out melodies, 600 + 900 steps): held-out texts and oracle ids each
   under half their untrained anchor; the full-width TextToSemantic (dim
   512, 6 + 6, 8 x 64 heads, 500 ids) overfit on a deterministic pattern
   (Adam 3e-4, up to 4000 steps, stopped under loss 5e-3): greedy pattern
   accuracy >= 0.99, speculative decode equal to greedy token for token,
   eos before the 256-id buffer ends; plain, speculative and w8a16 decode
   times, acceptance, the w8a16 decode's agreement, a profiled decode's ms
   and kernels a position. Every K1, K2, K3 and K4 launch of the phase is
   tallied by shape and must be one that phases 3-5 checked and timed;
20. files and HTTP: 8 seeded 10 s mono 24 kHz clips written as 16-bit FLAC
   (tests/flac_ref_encoder.py) and WAV, the native reader asserted built and
   every clip read back bit for bit (FLAC, WAV and `wav_read_batch`, ms a
   clip); phase 14's mel trainer over `AudioDataset` of the FLAC folder
   (10 steps, prefetch on) beside the same trainer over `ArrayDataset` of
   the decoded waves at the same seed, losses equal step for step within
   1e-6 relative (cuDNN deterministic for the phase), both runs' steps/s,
   the prefetch thread's decode ms a batch, a profiled step's idle share;
   phase 18's `TextToSemanticTrainer` over `SpeechTextDataset` of 8 WAV +
   transcript pairs at 16 kHz (3 steps, finite losses, steps/s);
   `examples/serve_http.py`'s engine warmed behind `make_server` on
   127.0.0.1:0, four `/synthesize` and one `/clone` sent at once (every
   answer a 24 kHz 16-bit mono WAV, `/healthz` counting 5 requests and a
   batch of more than 1, 400 and 404, the server and batcher closed), each
   request's latency. Every K1, K2 and K3 launch of the phase is tallied by
   shape and must be one that phases 3-4 checked and timed;
21. LoRA and data parallelism: (a) rank-8 adapters (alpha 16) on the seeded
   flagship (EncodecVoco attached, bf16 compute over fp32 weights), Adam on
   the adapters only at batch 8 x 752 frames, 2 warm-up and 4 timed
   steps: each exactly 24 K1, K2 and K3 launches and a finite loss, every
   base parameter bit-identical, every adapter moved; the counts of adapter
   and base weights, steps/s, a profiled step's idle share and kernels,
   peak memory beside phase 10's; the fold at qk gains 0.25, the folded
   bf16 forward against the hooked one and each adapted Linear alone, in
   units of the hooked bf16 against fp32; the folded model under w8a16
   serving one 750-frame request: finite audio through exactly 96 K1 and
   384 K4 launches at shapes phases 3 and 5 checked. (b) two processes
   (`chip_smoke.py --dp-worker`) under gloo at world 2 sharing cuda:0,
   each running `VoiceBoxTrainer` at phase 10's geometry, qk gains 0.25,
   global batch 8 (4 rows a rank), under "replicated" and "fsdp", 1 warm-up
   and 1 timed step on explicit draws: each rank's step exactly 24 K1, K2
   and K3, rank 0's losses and parameters equal to the single-process
   trainer's on the same global batch and draws (2 micro-batches of 4 rows,
   so "replicated" to the bit), ms a step, the reduction's share, peak
   memory per rank; then `checkpoint_backend="orbax"` under "fsdp" with an
   EMA: saved after 1 step, loaded by ranks built from other weights, the
   second step's loss, every parameter, moment and EMA shard equal to the
   uninterrupted run's to the bit, each rank's shard file written; the peak
   a rank of each layout over its timed steps, and beside it each part's
   (forward and backward, reduction, AdamW, gather): "fsdp"'s peak must be
   under "replicated"'s on both ranks;
22. tensor and sequence parallelism, in phase 21 (b)'s two rank processes
   (`tp_sp_worker`), phase 10's trainer at qk gains 0.25 and the global
   batch of 8 x 752 on each rank, 1 warm-up and 1 timed step on explicit
   draws: (a) `param_sharding="tp"` at model 2 (each rank 2 of the 4 heads:
   24 K1, K2 and K3 a step at (8, 2, 768, 768, 128); the feed-forward's
   `proj_in` split and gathered, `proj_out` whole); (b) `seq_parallel=2`
   (each rank 376 frames + 16 registers; ring attention: 48 K1, K2 and K3 a
   step, its own block (8, 4, 392, 392, 128) and the other rank's (8, 4,
   392, 376, 128); the halo conv); first, ring attention alone on the card
   (K1, K2 and K3 per block) against the plain ring on the same tensors,
   with and without the registers, ragged and with a row of no key, in bf16
   and fp32; each rank's ms a step, the collectives' share (host clock
   around synchronized calls), peak memory and launches; rank 0's losses
   and the first step's reduced gradients (gathered whole, leaf by leaf)
   against one process at 8 rows a micro-batch, within TP_SP_TIMES_FLOOR of
   the distance between two single-process runs that differ in summation
   order (the parameters' distance after the steps printed); then a 4080-frame
   utterance's vector field on each rank's 2040 frames against one
   process's: in bf16 at depth 24 (within the bf16-vs-fp32 floor) and in
   fp32 at depth 4 (within 1e-4); (c) pipeline parallelism
   (`parallel/pipeline.py`, `pp_worker`): the flagship's transformer with
   U-Net skips in bf16, 2 stages over the two ranks, 4 microbatches of 2 x
   752 frames, 1 + 2 forwards and backwards: 48 K1, K2 and K3 a rank a
   step at (2, 4, 768, 768, 128), rank 0's outputs equal to the
   unpipelined module's to the bit, the gradients gathered over every leaf
   within TP_SP_TIMES_FLOOR of the summation-order floor; ms a step, the
   collectives' share, the predicted bubble 3/7, peak memory a rank beside
   one process's. Every K1, K2 and K3 launch (counted where it is made,
   ring attention's included) at a shape phases 3 and 4 checked and timed;
23. the multi-chip dry run (`voicebox_tpu_torch/dryrun.py`) over two gloo
   ranks sharing the card: one "fsdp+tp" step, one step of each stage
   trainer, the sequence-parallel and the pipeline's loss and gradients on
   tiny shapes, all finite; its seconds;
25. one JSON line for the kernels (one row per kernel and main path; on the
   quantized paths, means per launch over the shapes it ran), then
   the last line `{"ok": true, "device": {...}}`.

Any failed check raises, so the process exits nonzero and prints no result.
Weights are random, made from a seed, except where phase 19 trains them.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import gc
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import voicebox_tpu_torch as vbt
from voicebox_tpu_torch import kernels, native
from voicebox_tpu_torch.examples import serve_http
from voicebox_tpu_torch.models import attention as attention_module
from voicebox_tpu_torch.models import cfm as cfm_module
from voicebox_tpu_torch.models.codec import EncodecVoco, MelVoco
from voicebox_tpu_torch.models.encodec import EncodecModel, ResidualVQ, _LSTM
from voicebox_tpu_torch.models.primitives import GEGLU, l2norm
from voicebox_tpu_torch.models.vocos import Vocos
from voicebox_tpu_torch.ops import flash_attention as flash_module
from voicebox_tpu_torch.ops.flash_attention import (
    _launch_k1,
    attention_delta,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    k1_block_q,
    k23_f32_edges,
    reference_attention,
    reference_attention_backward,
)
from voicebox_tpu_torch.ops.quant import (
    K4_GEMV_ROWS,
    K4_TILES,
    QuantLinear,
    _launch_k4,
    _x_rows,
    k4_tile,
    w8a16_matmul,
    w8a16_matmul_reference,
)
from voicebox_tpu_torch.ops import ring_attention as ring_module
from voicebox_tpu_torch.ops.ring_attention import ring_attention, ring_attention_prefixed
from voicebox_tpu_torch.ops.forward_sum import forward_sum_loss
from voicebox_tpu_torch.ops.lora import (fold_lora, lora_dense, lora_init, lora_parameters,
                                         lora_scale, merge_lora_params)
from voicebox_tpu_torch.ops.mas import maximum_path
from voicebox_tpu_torch.ops.stft import amplitude_to_db, mel_spectrogram
from voicebox_tpu_torch.parallel.distributed import maybe_initialize_distributed
from voicebox_tpu_torch.training.data import AudioDataset, PairedDataset, SpeechTextDataset
from voicebox_tpu_torch.utils.profiling import kernel_summary
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

# the semantic engine's buckets (phase 18)
SEM_BATCHES, SEM_TEXT_BUCKETS = (1, 2, 4), (32, 64, 128)
# the semantic stack's id horizon (phase 18: the decodes, the engine's
# warmup and requests), cut from 1024 to 256, to 128 (when phase 22 took
# the script to 1242 s on a slow host) and to 64 (when the head dims past
# 256 took it to 1156 s) to keep the script inside its clock; the engine's
# text buckets leave out 32, which no engine request of phase 18 reaches
SEM_IDS = 64
SEM_ENGINE_TEXT_BUCKETS = (64, 128)
# the example HTTP server's engine (phase 20, `examples/serve_http.py`)
HTTP_BATCHES, HTTP_TEXT_BUCKETS = (1, 2, 4), (32, 64)

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
    # one of phase 21's two data-parallel ranks: 4 of the 8 rows
    ("rank_train_bf16", (4, 4, 768, 768, 128), torch.bfloat16, "qk", "all", 1e-2, 1e-2),
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
    # the raw-audio mel denoiser (phase 14): training on 10 s waves, padded
    # to 1008 frames + 16 registers, the frame padding masked; sampling
    # from a 10 s prompt, 938 frames + 16 registers, x 2 for CFG, no mask
    ("mel_train_bf16", (8, 4, 1024, 1024, 128), torch.bfloat16, "qk", "prefix", 1e-2, 1e-2),
    ("mel_serve_bf16", (2, 4, 954, 954, 128), torch.bfloat16, "qk", None, 1e-2, 1e-2),
    # the reference duration predictor in training (phase 15): fp32, the
    # phoneme bucket 128, the text padding masked, and a batch element whose
    # every key is masked; its sampling call: one 64-phoneme text
    ("dp_train_f32", (8, 8, 128, 128, 64), torch.float32, "qk", "prefix", 1e-3, 1e-3),
    ("dp_train_empty_row_f32", (8, 8, 128, 128, 64), torch.float32, "qk", "empty_row", 1e-3,
     1e-3),
    ("dp_sample_f32", (1, 8, 64, 64, 64), torch.float32, "qk", "all", 1e-3, 1e-3),
    # the semantic stack (phase 18): the TextToSemantic encoder (fp32, 8 x 64
    # heads, no qk-norm, the text padding masked) at each (batch, text)
    # bucket of the semantic engine and at the trainer's batch of 8 at text
    # bucket 64 (128 is dp_train_f32's shape); the denoiser under the
    # generated mask: 2b x 4 x 128 heads over SEM_IDS ids + 16 registers
    *[(f"t2s_b{b}_n{n}_f32", (b, 8, n, n, 64), torch.float32, "randn", "prefix", 1e-5, 1e-5)
      for b in SEM_BATCHES for n in SEM_TEXT_BUCKETS],
    ("t2s_train_n64_f32", (8, 8, 64, 64, 64), torch.float32, "randn", "prefix", 1e-5, 1e-5),
    *[(f"semantic_b{b}_bf16", (2 * b, 4, SEM_IDS + 16, SEM_IDS + 16, 128), torch.bfloat16, "qk",
       "prefix", 1e-2,
       1e-2) for b in SEM_BATCHES],
    # long-form and cloning (phases 9b and 18): every window of the engine's
    # default 768 frames + 16 registers at batch 1, x 2 for CFG, no mask (the
    # duration predictor's and the encoder's shapes are the cases above)
    ("longform_bf16", (2, 4, 784, 784, 128), torch.bfloat16, "qk", None, 1e-2, 1e-2),
    # the trained-weight canaries (phase 19), fp32: the denoiser (4 x 32
    # heads, qk-norm, 121 mel frames + 2 registers, no mask) in training at
    # batch 4 (16 on the held-out split) and sampling at batch 1 and 4; the
    # seq2seq encoder (no qk-norm) and the duration predictor (qk-norm) over
    # 7 graphemes, 4 x 16 heads, masked; the full-width seq2seq's encoder
    # over 16 graphemes in training (batch 8) and decoding (batch 1)
    *[(f"canary_vb_b{b}_f32", (b, 4, 123, 123, 32), torch.float32, "qk", None, 1e-3, 1e-3)
      for b in (1, 4, 16)],
    ("canary_dp_b4_f32", (4, 4, 7, 7, 16), torch.float32, "qk", "prefix", 1e-3, 1e-3),
    *[(f"canary_enc_b{b}_f32", (b, 4, 7, 7, 16), torch.float32, "randn", "all", 1e-5, 1e-5)
      for b in (1, 16)],
    *[(f"canary_t2s_b{b}_f32", (b, 8, 16, 16, 64), torch.float32, "randn", "prefix", 1e-5,
       1e-5) for b in (1, 8)],
    # the example HTTP server's engine (phase 20, `examples/serve_http.py`):
    # its TextToSemantic encoder (fp32, 4 x 32 heads, no qk-norm, the text
    # padding masked) at each (batch, text) bucket, its denoiser (bf16, 4 x
    # 64 heads, qk-norm, 512 ids + 8 registers, x 2 for CFG) under the
    # generated mask at each batch bucket, and its long-form window unmasked
    *[(f"http_t2s_b{b}_n{n}_f32", (b, 4, n, n, 32), torch.float32, "randn", "prefix", 1e-5,
       1e-5) for b in HTTP_BATCHES for n in HTTP_TEXT_BUCKETS],
    *[(f"http_b{b}_bf16", (2 * b, 4, 520, 520, 64), torch.bfloat16, "qk", "prefix", 1e-2, 1e-2)
      for b in HTTP_BATCHES],
    ("http_long_bf16", (2, 4, 520, 520, 64), torch.bfloat16, "qk", None, 1e-2, 1e-2),
    # the edges of the fp32 design at the narrow head dims: n and kv at 1,
    # around the 16-row query and 32-key tiles (`k23_f32_edges`), under each
    # kind of mask in turn
    *[(f"edge_n{n}_kv{kv}_d{d}_f32", (2, 4, n, kv, d), torch.float32,
       "qk" if mask in ("prefix", "empty_row") else "randn", mask,
       *((1e-3, 1e-3) if mask in ("prefix", "empty_row") else (1e-5, 1e-5)))
      for j, d in enumerate((16, 32)) for i, (n, kv) in enumerate(k23_f32_edges())
      for mask in [(None, "prefix", "random", "empty_row")[(i + j) % 4]]],
]
# phase 22's ranks: a "tp" rank's 2 of the 4 heads; a sequence-parallel
# rank's ring blocks, its 376 frames + 16 registers against its own keys,
# then against the other rank's 376, in training and on a long utterance
# (2040 frames a rank) with no mask
TP_SP_K1 = [
    ("tp_rank_bf16", (8, 2, 768, 768, 128), torch.bfloat16, "qk", "all", 1e-2, 1e-2),
    ("sp_own_bf16", (8, 4, 392, 392, 128), torch.bfloat16, "qk", "all", 1e-2, 1e-2),
    ("sp_remote_bf16", (8, 4, 392, 376, 128), torch.bfloat16, "qk", "all", 1e-2, 1e-2),
    ("sp_long_own_bf16", (1, 4, 2056, 2056, 128), torch.bfloat16, "qk", None, 1e-2, 1e-2),
    ("sp_long_remote_bf16", (1, 4, 2056, 2040, 128), torch.bfloat16, "qk", None, 1e-2, 1e-2),
    ("sp_long_own_f32", (1, 4, 2056, 2056, 128), torch.float32, "qk", None, 1e-3, 1e-3),
    ("sp_long_remote_f32", (1, 4, 2056, 2040, 128), torch.float32, "qk", None, 1e-3, 1e-3),
]
K1_CASES += TP_SP_K1
# head dims the kernels are not built for, zero-padded to the next built
# width and sliced back (bf16 16 and 32 -> 64, fp32 8 -> 16): masked,
# ragged, a fully-masked element; then timed at the training shape beside
# the built width's launch of the same (b, h, n) ("pad_ref_"), SDPA and the
# bound at the true d. Phase 22's pipeline stage: one microbatch of 2 x
# 752 frames + 16 registers
PAD_K1 = [
    *[(f"pad_ragged_d{d}_{t}", (3, 4, 257, 131, d), dtype, "randn", "empty_row", tol, tol)
      for d, dtype, t, tol in ((16, torch.bfloat16, "bf16", 1e-2), (32, torch.bfloat16, "bf16",
                                                                    1e-2),
                               (8, torch.float32, "f32", 1e-5))],
    *[(f"pad_{'ref_' if ref else ''}d{d}_{t}", (8, 4, 768, 768, d), dtype, "qk", "all", tol, tol)
      for d, dtype, t, tol, ref in ((16, torch.bfloat16, "bf16", 1e-2, False),
                                    (32, torch.bfloat16, "bf16", 1e-2, False),
                                    (64, torch.bfloat16, "bf16", 1e-2, True),
                                    (8, torch.float32, "f32", 1e-3, False),
                                    (16, torch.float32, "f32", 1e-3, True))],
]
PP_K1 = [("pp_stage_bf16", (2, 4, 768, 768, 128), torch.bfloat16, "qk", "all", 1e-2, 1e-2)]
# head dim 256: phase 10b's flagship with its attention split as 2 x 256
# (training at batch 8 x 752 frames + 16 registers; a 10 s request, x 2 for
# CFG) and the reference duration predictor at 2 x 256 (fp32, phoneme bucket
# 128, the text padding masked); the edges of K1's 64-key tiles at that width
# in both dtypes (kv off the tile and off 8, n under one 64-row tile, a kv
# that wraps the ring 64 times, masked runs inside tiles, a fully-masked
# element under qk-norm); the head dim 192, zero-padded to 256, as the other
# padded widths
WIDE_EDGES = (("ragged_tma", (2, 4, 257, 131), "randn", "random"),
              ("short_q", (1, 4, 40, 300), "randn", None),
              ("long_kv", (1, 4, 4100, 4100), "qk", None),
              ("mid_tile_mask", (8, 4, 600, 600), "qk", "middle"),
              ("empty_row_qk", (3, 4, 300, 300), "qk", "empty_row"))
WIDE_K1 = [
    ("flagship256_train_bf16", (8, 2, 768, 768, 256), torch.bfloat16, "qk", "all", 1e-2, 1e-2),
    ("flagship256_cfg_bf16", (2, 2, 766, 766, 256), torch.bfloat16, "qk", None, 1e-2, 1e-2),
    ("dp256_train_f32", (8, 2, 128, 128, 256), torch.float32, "qk", "prefix", 1e-3, 1e-3),
    *[(f"{case}_d256_{t}", (*shape, 256), dtype, inputs, mask,
       *((1e-2, 1e-2) if dtype == torch.bfloat16 else (1e-3, 1e-3) if inputs == "qk"
         else (1e-5, 1e-5)))
      for dtype, t in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))
      for case, shape, inputs, mask in WIDE_EDGES],
    *[(f"pad_ragged_d192_{t}", (3, 4, 257, 131, 192), dtype, "randn", "empty_row", tol, tol)
      for dtype, t, tol in ((torch.bfloat16, "bf16", 1e-2), (torch.float32, "f32", 1e-5))],
    *[(f"pad_{'ref_' if d == 256 else ''}d{d}_{t}", (8, 4, 768, 768, d), dtype, "qk", "all",
       tol, tol)
      for dtype, t, tol in ((torch.bfloat16, "bf16", 1e-2), (torch.float32, "f32", 1e-3))
      for d in (192, 256)],
]
# head dims past 256, the chunked kernels: phase 15c's flagship at 2 x 512
# heads in training and serving and its small fp32 1 x 512 denoiser (batch
# 2 x 124 frames + 4 registers, the frame padding masked); the reference
# shape (8, 4, 768, 768, 512) in both dtypes, timed; at d = 320, 512, 576
# and 1024 in both dtypes a ragged, masked call with a fully-masked element
# (576 and 320: a last chunk of 64 columns); at 512 the edges of the design
# (n under one 64-row tile, a kv that wraps the slice and V rings many
# times, masked runs inside tiles, a fully-masked element under qk-norm);
# d = 300, zero-padded to 320
CHUNKED_D = (320, 512, 576, 1024)
CHUNKED_EDGES = (("short_q", (1, 2, 40, 300), "randn", None),
                 ("long_kv", (1, 2, 2100, 2100), "qk", None),
                 ("mid_tile_mask", (4, 2, 600, 600), "qk", "middle"),
                 ("empty_row_qk", (3, 2, 300, 300), "qk", "empty_row"))


def _k1_tol(dtype, inputs):
    return ((1e-2, 1e-2) if dtype == torch.bfloat16 else (1e-3, 1e-3) if inputs == "qk"
            else (1e-5, 1e-5))


CHUNKED_K1 = [
    ("flagship512_train_bf16", (8, 2, 768, 768, 512), torch.bfloat16, "qk", "all", 1e-2, 1e-2),
    ("flagship512_cfg_bf16", (2, 2, 766, 766, 512), torch.bfloat16, "qk", None, 1e-2, 1e-2),
    ("small512_train_f32", (2, 1, 128, 128, 512), torch.float32, "qk", "prefix", 1e-3, 1e-3),
    *[(f"chunked_ref_d512_{t}", (8, 4, 768, 768, 512), dtype, "qk", "all",
       *_k1_tol(dtype, "qk")) for dtype, t in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))],
    *[(f"chunked_ragged_d{d}_{t}", (3, 2, 257, 131, d), dtype, "randn", "empty_row",
       *_k1_tol(dtype, "randn"))
      for dtype, t in ((torch.bfloat16, "bf16"), (torch.float32, "f32")) for d in CHUNKED_D],
    *[(f"chunked_{case}_d512_{t}", (*shape, 512), dtype, inputs, mask, *_k1_tol(dtype, inputs))
      for dtype, t in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))
      for case, shape, inputs, mask in CHUNKED_EDGES],
    *[(f"pad_ragged_d300_{t}", (3, 2, 257, 131, 300), dtype, "randn", "empty_row",
       *_k1_tol(dtype, "randn"))
      for dtype, t in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))],
]
# phase 24: the JAX package's default VoiceBox (dim 1024, 16 x 64 heads)
# trained at batch 8 x 752 frames + 16 registers and serving a 10 s request
# (x 2 for CFG), and trained at benchmarks/dim1024_remat.py's 8 x 128
# split; the 100 s long-context step (the flagship at batch 1 x 7504 frames
# + 16 registers: 7520 rows, 117 x 64 + 32 and 58 x 128 + 96) and a 100 s
# request in one window (7500 frames + 16, x 2 for CFG); phase 24 (c)'s
# fp32 card-vs-CPU steps (the default at depth 2 on 2 x 128 frames, the
# flagship at depth 2 on 1 x 4096 frames, past JAX's 4096-token threshold),
# checked, not timed
DEFAULT_LONG_K1 = [
    ("default_train_bf16", (8, 16, 768, 768, 64), torch.bfloat16, "qk", "all", 1e-2, 1e-2),
    ("default_cfg_bf16", (2, 16, 766, 766, 64), torch.bfloat16, "qk", None, 1e-2, 1e-2),
    ("default128_train_bf16", (8, 8, 768, 768, 128), torch.bfloat16, "qk", "all", 1e-2, 1e-2),
    ("long_train_bf16", (1, 4, 7520, 7520, 128), torch.bfloat16, "qk", "all", 1e-2, 1e-2),
    ("long_cfg_bf16", (2, 4, 7516, 7516, 128), torch.bfloat16, "qk", None, 1e-2, 1e-2),
    ("default_small_f32", (2, 16, 144, 144, 64), torch.float32, "qk", "all", 1e-3, 1e-3),
    ("long_small_f32", (1, 4, 4112, 4112, 128), torch.float32, "qk", "all", 1e-3, 1e-3),
]
K1_CASES += PAD_K1 + PP_K1 + WIDE_K1 + CHUNKED_K1 + DEFAULT_LONG_K1
K1_TIMED = ("flagship_cfg_bf16", "reference_split_bf16", "train_bf16", "rank_train_bf16",
            *(name for name, *_ in TP_SP_K1 + PP_K1),
            *(name for name, shape, *_ in PAD_K1 if shape[2] == 768),
            "flagship256_train_bf16", "flagship256_cfg_bf16", "dp256_train_f32",
            "flagship512_train_bf16", "flagship512_cfg_bf16", "small512_train_f32",
            "chunked_ref_d512_bf16", "chunked_ref_d512_f32",
            *(name for name, *_ in WIDE_K1 if name.startswith("pad_d")),
            *(name for name, *_ in WIDE_K1 if name.startswith("pad_ref_d")),
            "engine_b1_bf16",
            "engine_b2_bf16", "engine_b4_bf16", "dp_b1_f32", "dp_b2_f32", "dp_b4_f32",
            "mel_train_bf16", "mel_serve_bf16", "dp_train_f32", "dp_sample_f32",
            *(name for name, *_ in K1_CASES if name.startswith(("t2s_", "semantic_",
                                                                 "canary_", "http_"))),
            "longform_bf16", "default_train_bf16", "default_cfg_bf16", "default128_train_bf16",
            "long_train_bf16", "long_cfg_bf16")
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
    ("rank_train_bf16", (4, 4, 768, 768, 128), torch.bfloat16, "qk", "all", 2e-2),
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
    # the raw-audio mel denoiser's training shape (phase 14) and the
    # duration predictor's, in fp32 (phase 15), as K1's cases above
    ("mel_train_bf16", (8, 4, 1024, 1024, 128), torch.bfloat16, "qk", "prefix", 2e-2),
    ("dp_train_f32", (8, 8, 128, 128, 64), torch.float32, "qk", "prefix", 1e-4),
    ("dp_train_empty_row_f32", (8, 8, 128, 128, 64), torch.float32, "qk", "empty_row", 1e-4),
    # the edges of the fp32 design (`k23_f32_edges`, the CPU tests' shapes):
    # n and kv at 1, one under, at and one over its tiles (64 owned rows, 64
    # or 32 streamed) and at the phoneme buckets, at both head dims, the
    # masks taken in turn as in tests/test_torch_flash_backward_tiles.py
    # (qk-normed at scale 10 under the prefix and fully-masked ones). Where
    # kv = 1, dq and dk are held to `single_key_floor` instead (ds is 0 in
    # exact arithmetic)
    *[(f"edge_n{n}_kv{kv}_d{d}_f32", (2, 4, n, kv, d), torch.float32,
       "qk" if mask in ("prefix", "empty_row") else "randn", mask, 1e-4)
      for j, d in enumerate((64, 128, 16, 32, 256)) for i, (n, kv) in enumerate(k23_f32_edges())
      for mask in [(None, "prefix", "random", "empty_row")[(i + j) % 4]]],
    # the trained-weight canaries' training (phase 19), as K1's cases above
    *[(f"canary_vb_b{b}_f32", (b, 4, 123, 123, 32), torch.float32, "qk", None, 1e-4)
      for b in (4, 16)],
    # (dq and dk under qk-norm at d = 16 and 32 are held to their rounding
    # floor: the same shape on a soft softmax holds them relatively)
    ("canary_vb_b4_randn_f32", (4, 4, 123, 123, 32), torch.float32, "randn", None, 1e-4),
    ("canary_dp_b4_f32", (4, 4, 7, 7, 16), torch.float32, "qk", "prefix", 1e-4),
    ("canary_enc_b16_f32", (16, 4, 7, 7, 16), torch.float32, "randn", "all", 1e-4),
    ("canary_t2s_b8_f32", (8, 8, 16, 16, 64), torch.float32, "randn", "prefix", 1e-4),
]
TP_SP_K23 = [(name, shape, dtype, inputs, mask, 2e-2)
             for name, shape, dtype, inputs, mask, *_ in TP_SP_K1 + PP_K1 if "long" not in name]
# the padded head dims as K1's: the ragged cases on a soft softmax (qk-norm
# at d = 16 and 32 leaves dq and dk at their rounding floor), the timed ones
# at the training shape
PAD_K23 = [(name, shape, dtype, "randn", mask, 2e-2 if dtype == torch.bfloat16 else 1e-4)
           for name, shape, dtype, inputs, mask, *_ in PAD_K1
           + [c for c in WIDE_K1 if c[0].startswith("pad_")]]
# head dim 256 as K1's: the two training paths, and the edges of the 64-row
# tiles in both dtypes
WIDE_K23 = [(name, shape, dtype, inputs, mask, 2e-2 if dtype == torch.bfloat16 else 1e-4)
            for name, shape, dtype, inputs, mask, *_ in WIDE_K1
            if not name.startswith(("pad_", "flagship256_cfg"))]
# past 256 as K1's: every case but the serving call's (the padded one on a
# soft softmax, as the other padded widths)
CHUNKED_K23 = [(name, shape, dtype, inputs, mask, 2e-2 if dtype == torch.bfloat16 else 1e-4)
               for name, shape, dtype, inputs, mask, *_ in CHUNKED_K1 if "_cfg_" not in name]
# phase 24's training shapes as K1's (the default's 16 x 64 split is
# "reference_split_bf16" above)
DEFAULT_LONG_K23 = [(name, shape, dtype, inputs, mask, 2e-2 if dtype == torch.bfloat16 else 1e-4)
                    for name, shape, dtype, inputs, mask, *_ in DEFAULT_LONG_K1
                    if "_cfg_" not in name and name != "default_train_bf16"]
K23_CASES += TP_SP_K23 + PAD_K23 + WIDE_K23 + CHUNKED_K23 + DEFAULT_LONG_K23
# timed: the paths' shapes and the reference shapes; of the fp32 padded
# widths at (8, 4, 768, 768, d) none any more (checked, not timed, to make
# room for the widths past 256 under the script's clock)
K23_TIMED = ("train_bf16", "rank_train_bf16", "reference_split_bf16", "mel_train_bf16",
             *(name for name, *_ in TP_SP_K23),
             *(name for name, shape, dtype, *_ in PAD_K23
               if shape[2] == 768 and dtype == torch.bfloat16),
             "flagship256_train_bf16", "dp256_train_f32",
             "flagship512_train_bf16", "small512_train_f32", "chunked_ref_d512_bf16",
             "chunked_ref_d512_f32",
             "dp_train_f32",
             "train_f32", *(name for name, *_ in K23_CASES if name.startswith("canary_")),
             "default128_train_bf16", "long_train_bf16")
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


MEASURED: dict = {}  # numbers one phase prints beside another's


_START = time.perf_counter()


def log(phase: str, msg: str) -> None:
    """One line, tagged with the phase and the process's seconds so far."""
    print(f"[{phase} {time.perf_counter() - _START:.0f}s] {msg}", flush=True)


def seeded(build, seed: int):
    """Build modules with torch's default init under a fixed seed, without
    touching the caller's random state."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def seeded_on(device: str, build, seed: int):
    """`seeded` with the modules made on `device` and their init drawn from
    its generator: the same weights in every process that builds them so,
    with no host init and no copy (other weights than `seeded`'s)."""
    with torch.random.fork_rng(devices=[torch.device(device).index or 0]), \
            torch.device(device):
        torch.manual_seed(seed)
        return build()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # the device sleeps (~25 ms) while the host queues every call, so the
    # events time the device's work and not the host's launches: a short
    # library call (SDPA's, through autograd) is otherwise host-bound. The
    # longest queueing of a timed loop, 10 of SDPA's forward + backward
    # through autograd, takes under 10 ms of a slow host (it slept ~50 ms,
    # 100M cycles, until the widths past 256 needed the script's time)
    torch.cuda._sleep(50_000_000)
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


# the kernel sources, the kernels each holds and their bf16 instantiations
# (K1: d 64, 128 and 256 x 64 and 128 query rows; K2, K3: d 64, 128 and 256;
# K4: 64 and 128 channels x 64, 128 and 256 rows), every one of which must
# be wgmma + TMA, with no spill; the fp32 K1, K2 and K3 instantiations (d 16,
# 32, 64, 128 and 256) must not spill either
SOURCES_BF16 = {"flash_attention_fwd": {"k1": 7}, "flash_attention_bwd": {"k2": 4, "k3": 4},
                "w8a16_matmul": {"k4": len(K4_TILES[torch.bfloat16])}}
# fp32 K1, K2 and K3 kernels each: d 16, 32, 64, 128, 256 and the chunked
# kernel past 256
F32_HEAD_DIMS = 6


def phase_build() -> None:
    sources = tuple(SOURCES_BF16)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        libs = list(pool.map(kernels.build, sources))
    for name in sources:
        kernels.load(name)
    dt = time.perf_counter() - t0
    for name, lib in zip(sources, libs):
        ptxas = _ptxas_by_kernel(f"{lib}.log")
        for fn, lines in ptxas.items():
            log("build", f"{name} {fn}: ptxas: {' | '.join(lines)}")
        tool, counts = _sass_counts(lib)
        log("build", f"{name} SASS ({tool}): (HGMMA, UTMALDG) per instantiation {counts}")
        for kernel, expected in SOURCES_BF16[name].items():
            bf16 = {fn: c for fn, c in counts.items() if fn.startswith(f"{kernel} bf16")}
            assert len(bf16) == expected and all(min(c) > 0 for c in bf16.values()), (
                f"{kernel}'s bf16 code is not wgmma + TMA: {counts}"
            )
            spills = {fn: _spill_bytes(ptxas.get(fn, [])) for fn in bf16}
            assert all(s == 0 for s in spills.values()), f"{kernel} spills: {spills}"
        if name == "flash_attention_bwd":  # fp32 K2/K3 at d = 16-256: no spill
            f32 = {fn: _spill_bytes(lines) for fn, lines in ptxas.items()
                   if fn.split()[:2] in (["k2", "f32"], ["k3", "f32"])}
            assert len(f32) == 2 * F32_HEAD_DIMS and not any(f32.values()), (
                f"fp32 K2/K3 spills: {f32}")
        if name == "flash_attention_fwd":  # fp32 K1 at d = 16-256: no spill
            f32 = {fn: _spill_bytes(lines) for fn, lines in ptxas.items()
                   if fn.split()[:2] == ["k1", "f32"]}
            assert len(f32) == F32_HEAD_DIMS and not any(f32.values()), f"fp32 K1 spills: {f32}"
        if name == "w8a16_matmul":  # fp32 K4's GEMV: its sums and weights stay in registers
            gemv = [(_spill_bytes(lines), _stack_bytes(lines)) for fn, lines in ptxas.items()
                    if fn == "k4 f32 gemv"]
            assert gemv == [(0, 0)], f"fp32 K4 GEMV (spill, stack frame) bytes: {gemv}"
    log("build", f"nvcc {' '.join(kernels.NVCC_FLAGS)}: {len(sources)} sources in "
                 f"{dt:.2f} s, built in parallel")


_KERNEL = re.compile(r"flash_(fwd|bwd_dq|bwd_dkv)_(bf16|f32)(?:_wide|ILi(\d+)E(?:Li(\d+)E)?)")
_KERNEL_TAG = {"fwd": "k1", "bwd_dq": "k2", "bwd_dkv": "k3"}
_K4_KERNEL = re.compile(r"w8a16_(bf16|f32_gemv|f32)(?:ILi(\d+)E(?:Li(\d+)E)?)?")


def _instance(mangled: str):
    """`k2 bf16 d=128 rows=128` from a mangled K1, K2 or K3 instantiation
    (rows: those a block owns; `d>256` for the chunked kernels), `k4 bf16
    channels=128 rows=256` from a K4
    one (its tile of y), `k4 f32 gemv` from the GEMV route's, or None."""
    m = _KERNEL.search(mangled)
    if m is None:
        m = _K4_KERNEL.search(mangled)
        if m is None:
            return None
        kind, wgs, rows = m.groups()
        if kind == "f32_gemv":
            return "k4 f32 gemv"
        return f"k4 {kind} channels={64 * int(wgs or 1)} rows={rows or 64}"
    which, kind, d, tile = m.groups()
    kernel = _KERNEL_TAG[which]
    rows = 16 if (kernel, kind) == ("k1", "f32") else 64 * int(tile or 1)
    return f"{kernel} {kind} d{'>256' if d is None else f'={d}'} rows={rows}"


def _ptxas_by_kernel(log_path) -> dict:
    """ptxas's registers, spill and shared-memory lines of each kernel
    instantiation, from the build's log."""
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


def _stack_bytes(lines) -> int:
    """Stack frame bytes (local arrays not held in registers) of one kernel."""
    return sum(int(a) for line in lines for a in re.findall(r"(\d+) bytes stack frame", line))


def _sass_counts(lib) -> tuple:
    """(tool, {kernel instantiation: (HGMMA, UTMALDG) instructions}) from
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
    elif mask_kind == "prefix":  # padding at each row's end, as a batch of ragged items
        lengths = torch.randint(kv // 3, kv + 1, (b,), generator=gen, device=dev)
        lengths[0] = kv
        mask = torch.arange(kv, device=dev)[None, :] < lengths[:, None]
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
            if shape[4] > 128:  # which of SDPA's backends takes the wide heads
                log("k1", f"SDPA {name} launches: " + "; ".join(_device_kernels(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sm,
                                                           scale=scale))))
        if name in K1_TIMED and dtype == torch.bfloat16:
            b, h, n = shape[:3]
            chosen = k1_block_q(b, h, n, shape[4], dtype, sms)
            heights = K1_BF16_HEIGHTS if shape[4] <= 256 else (64,)  # chunked: one height
            tiles = in_turns({rows: lambda rows=rows: _launch_k1(q, k, v, mask, scale, rows)
                              for rows in heights})
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
        # with one key (kv = 1) dq and dk are 0 in exact arithmetic and
        # rounding noise on every side: each is held to its floor, absolutely.
        # So are they at head dims 16 and 32 under qk-norm's scale 10: logits
        # up to 10 d leave a short row's softmax one-hot to within rounding
        # but not exactly (at d = 64 and 128 it is exact), so on the
        # dominant key ds = p (dp - delta) is the rounding noise of the
        # difference, as with one key, and every side's dq and dk carry it
        floored = shape[3] == 1 or (shape[4] in (16, 32) and inputs == "qk")
        graded = 1 if floored else 3
        err_plain = [_rel_err(a, b) for a, b in zip(got[-graded:], plain[-graded:])]
        err_auto = [_rel_err(a, b) for a, b in zip(got[-graded:], auto[-graded:])]
        norm_plain = [_norm_err(a, b) for a, b in zip(got[-graded:], plain[-graded:])]
        norm_auto = [_norm_err(a, b) for a, b in zip(got[-graded:], auto[-graded:])]
        abs_err = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, plain)]
        typical = [r.float().abs().median().item() for r in plain]
        tol_plain, tol_auto = NORM_TOL[dtype]
        wide_floor = None
        if dtype == torch.float32 and inputs == "qk" and shape[4] > 128:
            # qk-normed logits at d = 256 reach 10 d = 2560: a few ulps of
            # their fp32 sums in another order (cuBLAS's, for the plain
            # version and autograd; the kernel's sequential one) are as large
            # a relative error of p, past the 1e-4 that logits up to 1280
            # were held to (`logit_floor`)
            wide_floor = logit_floor(q, k, scale)
            tol, tol_plain, tol_auto = (max(t, wide_floor) for t in (tol, tol_plain, tol_auto))
        graded_as = "dq/dk/dv" if graded == 3 else "dv"
        line = (f"{name} {tuple(shape)} {str(dtype)[6:]} dq/dk/dv max_abs_err vs plain "
                f"{abs_err[0]:.3e}/{abs_err[1]:.3e}/{abs_err[2]:.3e} (median |ref| "
                f"{'/'.join(f'{e:.3e}' for e in typical)}), {graded_as} relative to max|ref| "
                f"vs plain {'/'.join(f'{e:.2e}' for e in err_plain)}, vs autograd "
                f"{'/'.join(f'{e:.2e}' for e in err_auto)} (tol {tol:g} x max|ref|); "
                f"||err|| / ||ref|| vs plain {'/'.join(f'{e:.2e}' for e in norm_plain)} (tol "
                f"{tol_plain:g}), vs autograd {'/'.join(f'{e:.2e}' for e in norm_auto)} (tol "
                f"{tol_auto:g})")
        if wide_floor is not None:
            line += f" (each at least the logit floor {wide_floor:.2e})"
        ok = (max(err_plain + err_auto) <= tol and max(norm_plain) <= tol_plain
              and max(norm_auto) <= tol_auto)
        if floored:
            floors = single_key_floor(q, k, v, do, scale)
            worst = [max((g.float() - r.float()).abs().max().item() for r in (p, a))
                     for g, p, a in zip(got[:2], plain[:2], auto[:2])]
            line += (f"; {'one key' if shape[3] == 1 else 'one-hot rows'}: dq/dk max |err| "
                     f"vs plain and autograd {worst[0]:.3e}/{worst[1]:.3e} (floor "
                     f"{floors[0]:.3e}/{floors[1]:.3e})")
            ok = ok and all(w <= f for w, f in zip(worst, floors))
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
        results[name] = {"max_abs_err": abs_err, "shape": shape, "dtype": dtype,
                         "masked": mask is not None}
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
            # fp32: does it use tensor cores (a TF32 split)? wide heads: which backend?
            if dtype == torch.float32 or shape[4] > 128:
                log("k23", f"SDPA's backward {name} launches: " + "; ".join(_device_kernels(
                    lambda: torch.autograd.grad(sdpa_out, lv, do, retain_graph=True))))
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
                       f"(CUDA events, mean of 2 x 10, in turns; K2/K3 blocks own 64 "
                       f"rows) on {smi}")
    return results


def _device_kernels(fn) -> list:
    """The names of the device kernels that one call of fn launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:120] for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


LOGIT_ULPS = 8  # a sum of 256 products in two orders: up to ~log2(256) ulps apart


def logit_floor(q, k, scale) -> float:
    """The relative error of p that LOGIT_ULPS ulps of the largest |logit|
    bring: exp turns an absolute error of a logit into the same relative
    error of its probability, and two fp32 sums of one logit in different
    orders differ by a few ulps."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)).abs().max().item() * scale
    return LOGIT_ULPS * 2.0 ** -23 * s


def single_key_floor(q, k, v, do, scale) -> tuple:
    """Bounds on |dq| and |dk| errors where kv = 1: a row's one key has p =
    1, so ds = p (dO.v - delta) scale is 0 in exact arithmetic and every
    side's dq and dk are rounding noise of the difference: 16 ulps (2^-20)
    of |dO| |v|, times scale, times max |k| (dq) or max |q| (dk)."""
    base = 2.0 ** -20 * scale * (do.float().norm(dim=-1).max()
                                 * v.float().norm(dim=-1).max()).item()
    return base * k.float().abs().max().item(), base * q.float().abs().max().item()


# the flagship's four quantized matmuls per block, (k, n): to_qkv, to_out,
# the feed-forward's proj_in (GEGLU, 2 x 1365) and proj_out. m is batch x 2
# for CFG x (frames + 16 registers): the engine's groups give 544 (batch 1,
# 256 frames), 2112 (batch 2, 512) and 8320 (batch 4, 1024); 1532 is
# batch 1 at 750 frames; the semantic engine's 64 ids (SEM_IDS) give 160,
# 320 and 640; a long-form window (768 frames + 16 registers, batch 1)
# gives 1568
K4_SHAPES = {"to_qkv": (512, 1536), "to_out": (512, 512), "ff_proj_in": (512, 2730),
             "ff_proj_out": (1365, 512)}
K4_ROWS = tuple(sorted({544, 1532, 1568, 2112, 8320,  # the semantic batches 1, 2, 4:
                        *(2 * b * (SEM_IDS + 16) for b in SEM_BATCHES)}))
K4_RAGGED_ROWS = (37, 1)
# tolerance of |K4 - plain| <= rtol |plain| + atol max|plain|. Both sum exact
# products (bf16 x int8, or fp32 x int8 in fp32) in fp32, in another order
# (atol); bf16 outputs also round to bf16 after the scale, which moves a
# value by one bf16 step (2^-8 relative) where the sums straddle a boundary
K4_TOL = {torch.bfloat16: (2 ** -7, 1e-4), torch.float32: (1e-5, 1e-5)}
# bf16 K4 timed at every tile at this one (k, n) x m only (every tile is
# still checked at every shape): the sweep at every shape took ~54 s of the
# script's clock
K4_TILES_TIMED_AT = ("to_qkv", 2112)


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


# x as the engine hands it to K4: rows at the pitch a w8a16 copy's GEGLU
# writes (16 elements: 1376 for k = 1365, k itself for k = 512), at the
# front of a buffer whose pitch columns and tail are NaN, so that a read
# past k or past m shows as NaN in y. Pitch 1 gives a contiguous x.
K4_PITCH = 16
K4_NAN_TAIL = 4096  # NaN elements past x's last row


def _k4_operands(m, k, n, dtype, gen, pitch=K4_PITCH):
    layer = torch.nn.Linear(k, n, bias=False, device="cuda")
    with torch.no_grad():
        layer.weight.copy_(torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5)
    ql = QuantLinear(layer, "w8a16")
    ldx = -(-k // pitch) * pitch
    buf = torch.full((m * ldx + K4_NAN_TAIL,), float("nan"), dtype=dtype, device="cuda")
    x = buf[: m * ldx].view(m, ldx)[:, :k]
    x.copy_(torch.randn(m, k, generator=gen, device="cuda"))
    return x, ql


def _k4_call(x, ql, tile=None):
    """One call of K4 on (x, ql): through `w8a16_matmul` at the host's tile,
    or at `tile` (rows, channels)."""
    if tile is None:
        return lambda: w8a16_matmul(x, ql.weight_q, ql.weight_scale)
    x2, ldx = _x_rows(x)
    return lambda: _launch_k4(x2, ldx, ql.weight_q, ql.weight_scale, tile)


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


def phase_k4_host_time(rounds: int = 5) -> None:
    """Host microseconds of one K4 call at the engine's batch-1 to_out shape
    (544, 512, 512), in turns: `w8a16_matmul` (what `QuantLinear` calls),
    `_launch_k4` on bf16 operands (which encodes two tensor maps) and on fp32
    copies of them (the same host path, no tensor map); at the decode's
    (1, 512, 512) `_launch_k4` and `w8a16_matmul` on fp32 (the GEMV route)
    beside `F.linear` on the dequantized weight (what the float decode
    calls); and the feed-forward's
    GEGLU at batch 1 (2 x 272 tokens, 2 x 1365 wide) at the w8a16 copy's row
    pitch of 16 beside the contiguous one."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    x, ql = _k4_operands(544, 512, 512, torch.bfloat16, gen)
    x2, ldx = _x_rows(x)
    xf = x2.float()
    w, sc = ql.weight_q, ql.weight_scale
    w_deq = w[:512, :512].float() * sc[:, None]
    h = torch.randn(2, 272, 2730, generator=gen, device="cuda").to(torch.bfloat16)
    pitched, plain = GEGLU(row_pitch=16), GEGLU()
    calls = {
        "w8a16_matmul bf16": lambda: w8a16_matmul(x, w, sc),
        "_launch_k4 bf16 (2 tensor maps encoded)": lambda: _launch_k4(x2, ldx, w, sc),
        "_launch_k4 fp32 (no tensor map)": lambda: _launch_k4(xf, 512, w, sc),
        "_launch_k4 fp32 (1, 512, 512) GEMV": lambda: _launch_k4(xf[:1], 512, w, sc),
        "w8a16_matmul fp32 (1, 512, 512) GEMV": lambda: w8a16_matmul(xf[:1], w, sc),
        "F.linear fp32 (1, 512, 512) (cuBLAS)": lambda: F.linear(xf[:1], w_deq),
        "GEGLU pitched": lambda: pitched(h),
        "GEGLU contiguous": lambda: plain(h),
    }
    us = {label: [] for label in calls}
    for _ in range(rounds):
        for label, fn in calls.items():
            us[label].append(host_us(fn))
    log("k4", "host time of one call (544, 512, 512): " + "; ".join(
        f"{label} median {np.median(t):.2f} us, min {min(t):.2f}" for label, t in us.items())
        + f" (host clock over 200 calls queued behind a device sleep, no synchronize, "
          f"{rounds} rounds in turns)")


def phase_k4_check(smi: str) -> dict:
    """K4 against its plain version: every (k, n) of K4_SHAPES at every m of
    K4_ROWS and K4_RAGGED_ROWS, bf16 and fp32, x pitched (k = 1365) and
    NaN past its end, at every tile (bf16) or route (fp32) the C entry
    point takes; a second launch must give the same bits. A contiguous (1, 1365) x and, in fp32,
    a contiguous (37, 1365) one. Times at the bf16 shapes of K4_ROWS: K4 at
    the host's tile, the plain version, cuBLAS on the weight dequantized to
    bf16 ahead of time and `_weight_int8pack_mm` where it runs, in turns;
    K4 at each tile at `K4_TILES_TIMED_AT` alone."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    cases = [(name, m, dtype, K4_PITCH) for name in K4_SHAPES
             for m in K4_ROWS + K4_RAGGED_ROWS for dtype in (torch.bfloat16, torch.float32)]
    cases += [("ff_proj_out", 1, torch.bfloat16, 1), ("ff_proj_out", 1, torch.float32, 1),
              ("ff_proj_out", 37, torch.float32, 1)]
    for name, m, dtype, pitch in cases:
        k, n = K4_SHAPES[name]
        x, ql = _k4_operands(m, k, n, dtype, gen, pitch)
        ref = w8a16_matmul_reference(x, ql.weight_q, ql.weight_scale).float()
        rtol, atol = K4_TOL[dtype]
        peak = ref.abs().max().item()
        chosen = k4_tile(m, k, n, dtype, sms)
        errs, ok = {}, True
        for tile in K4_TILES[dtype]:
            call = _k4_call(x, ql, None if tile == chosen else tile)
            y, again = call(), call()
            torch.cuda.synchronize()
            err = (y.float() - ref).abs()
            same = torch.equal(y, again)
            good = bool(torch.isfinite(y).all()) and bool((err <= rtol * ref.abs()
                                                           + atol * peak).all())
            errs[tile] = err.max().item()
            ok = ok and good and same
            if not (good and same):
                log("k4", f"FAIL {name} m={m} {str(dtype)[6:]} tile {tile}: max_abs_err "
                          f"{errs[tile]:.3e}, finite {bool(torch.isfinite(y).all())}, second "
                          f"launch bit-identical {same}")
        x_kind = (f"x rows {x.stride(0)} apart, NaN past them" if pitch > 1 or m == 1
                  else "x contiguous, NaN past it")
        log("k4", f"{name} (m, k, n) = ({m}, {k}, {n}) {str(dtype)[6:]}, {x_kind}: max_abs_err "
                  f"by tile (rows x channels) "
                  + ", ".join(f"{r}x{c} {e:.3e}" + (" <- chosen" if (r, c) == chosen else "")
                              for (r, c), e in errs.items())
                  + f" (max |plain| {peak:.3e}; tol rtol {rtol:g} + atol {atol:g} x max|plain|);"
                    f" second launches bit-identical")
        assert ok, f"K4 disagrees with the plain version on {name} m={m} {dtype}"
        if dtype != torch.bfloat16 or m not in K4_ROWS:
            continue
        w_deq = (ql.weight_q[:n, :k].float() * ql.weight_scale[:, None]).to(dtype)
        fns = {
            "plain": lambda: w8a16_matmul_reference(x, ql.weight_q, ql.weight_scale),
            "k4": _k4_call(x, ql),
            "cublas": lambda: F.linear(x, w_deq),
        }
        int8pack, why = _int8pack_mm(x, ql)
        if int8pack is not None:
            fns["int8pack"] = int8pack
        t = in_turns(fns)
        bound_ms, bound_by = k4_bound(m, k, n, dtype)
        results[(m, k, n)] = dict(
            shape=(m, k, n), ms=t["k4"], plain_ms=t["plain"], library_ms=t["cublas"],
            int8pack_ms=t.get("int8pack"), bound_ms=bound_ms, bound_by=bound_by,
            max_abs_err=errs[chosen], tile=list(chosen), share_of_bound=bound_ms / t["k4"],
            vs_library=t["k4"] / t["cublas"])
        by_tile = ""
        if (name, m) == K4_TILES_TIMED_AT:
            tiles = in_turns({tile: _k4_call(x, ql, tile) for tile in K4_TILES[dtype]})
            results[(m, k, n)]["tile_ms"] = {f"{r}x{c}": ms for (r, c), ms in tiles.items()}
            by_tile = "; K4 by tile (rows x channels, blocks): " + ", ".join(
                f"{r}x{c} {ms:.4f} ms ({-(-m // r) * -(-n // c)})" for (r, c), ms in tiles.items())
        pack = (f"{t['int8pack']:.4f} ms" if int8pack is not None
                else f"not run ({why})")
        log("k4", f"time {name} ({m}, {k}, {n}) bf16: K4 {t['k4']:.4f} ms at tile "
                  f"{chosen[0]}x{chosen[1]} ({bound_ms / t['k4']:.1%} of the bound "
                  f"{bound_ms:.4f} ms, {bound_by}; {t['k4'] / t['cublas']:.2f}x cuBLAS), plain "
                  f"{t['plain']:.4f} ms, cuBLAS on the bf16-dequantized weight "
                  f"{t['cublas']:.4f} ms, _weight_int8pack_mm {pack}{by_tile}"
                  f" (CUDA events, mean of 2 x 20, in turns, {sms} SMs) on {smi}")
    phase_k4_host_time()
    return results


# fp32 K4 on the TextToSemantic decode under generate(quantize="w8a16")
# (phase 18): the (k, n) of each decoder matmul and of the head (to_q is
# to_out's (512, 512)), at m = the rows of a decode step (batch 1, 4) or of
# a verify chunk (batch 4 x (gamma + 1) = 24); the cross-attention's to_kv
# runs once per request at m = batch x text bucket (1 x 32, 4 x 128) and,
# on the trained decode of phase 19, 1 x 16 graphemes
K4_DECODE_SHAPES = {"dec_to_qkv": (512, 1536), "dec_to_out": (512, 512),
                    "dec_ff_proj_in": (512, 2730), "dec_ff_proj_out": (1365, 512),
                    "to_logits": (512, 502)}
K4_DECODE_ROWS = (1, 4, 24)
K4_DECODE_KV = ("dec_to_kv", (512, 1024), (16, 32, 512))
# the quality canaries' denoiser under w8a16 (phase 19; dim 128, GEGLU 2 x
# 341): m = 123 tokens (one text at a time, the GEMV route) and 4 x 123 (the
# duration canary's batched texts, the tiled route)
K4_CANARY_SHAPES = {"canary_to_qkv": (128, 384), "canary_to_out": (128, 128),
                    "canary_ff_proj_in": (128, 682), "canary_ff_proj_out": (341, 128)}
K4_CANARY_ROWS = (123, 492)
# m past the GEMV route's rows of one stage, where it meets the tiled route
K4_CROSSOVER_ROWS = (32, 64, 128, 192, 256)


def phase_k4_decode_check(smi: str) -> dict:
    """fp32 K4 at the quantized decode's shapes against its plain version at
    every route the C entry point takes (x at the GEGLU's pitch, NaN past
    it; a second launch bit-identical), timed at the host's route in turns
    beside the plain version and cuBLAS fp32 (TF32 off) on the weight
    dequantized ahead of time, with its bound, and every route in turns;
    then the GEMV route the host picks against the tiled one at m around
    K4_GEMV_ROWS."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(name, m, kn) for name, kn in K4_DECODE_SHAPES.items() for m in K4_DECODE_ROWS]
    cases += [(K4_DECODE_KV[0], m, K4_DECODE_KV[1]) for m in K4_DECODE_KV[2]]
    cases += [(name, m, kn) for name, kn in K4_CANARY_SHAPES.items() for m in K4_CANARY_ROWS]
    rtol, atol = K4_TOL[torch.float32]
    routes = K4_TILES[torch.float32]
    results = {}
    for name, m, (k, n) in cases:
        x, ql = _k4_operands(m, k, n, torch.float32, gen)
        ref = w8a16_matmul_reference(x, ql.weight_q, ql.weight_scale)
        chosen = k4_tile(m, k, n, torch.float32, sms)
        errs = {}
        for tile in routes:
            call = _k4_call(x, ql, None if tile == chosen else tile)
            y, again = call(), call()
            torch.cuda.synchronize()
            err = (y - ref).abs()
            errs[tile] = err.max().item()
            ok = (bool(torch.isfinite(y).all()) and torch.equal(y, again)
                  and bool((err <= rtol * ref.abs() + atol * ref.abs().max()).all()))
            assert ok, f"fp32 K4 disagrees with the plain version on {name} m={m} at {tile}"
        w_deq = ql.weight_q[:n, :k].float() * ql.weight_scale[:, None]
        t = in_turns({"plain": lambda: w8a16_matmul_reference(x, ql.weight_q, ql.weight_scale),
                      "k4": _k4_call(x, ql), "cublas": lambda: F.linear(x, w_deq)})
        by_route = in_turns({tile: _k4_call(x, ql, tile) for tile in routes})
        bound_ms, bound_by = k4_bound(m, k, n, torch.float32)
        results[(m, k, n)] = dict(
            shape=(m, k, n), dtype=torch.float32, ms=t["k4"], plain_ms=t["plain"],
            library_ms=t["cublas"], bound_ms=bound_ms, bound_by=bound_by,
            max_abs_err=errs[chosen], tile=list(chosen), share_of_bound=bound_ms / t["k4"],
            vs_library=t["k4"] / t["cublas"],
            tile_ms={f"{r}x{c}": ms for (r, c), ms in by_route.items()})
        log("k4", f"decode {name} (m, k, n) = ({m}, {k}, {n}) fp32, x rows {x.stride(0)} apart, "
                  f"NaN past them: max_abs_err by route (rows x channels) "
                  + ", ".join(f"{r}x{c} {e:.3e}" + (" <- chosen" if (r, c) == chosen else "")
                              for (r, c), e in errs.items())
                  + f" (tol rtol {rtol:g} + atol {atol:g} x max|plain|), second launches "
                    f"bit-identical; K4 {t['k4']:.4f} ms at {chosen[0]}x{chosen[1]} "
                    f"({bound_ms / t['k4']:.1%} of the bound {bound_ms:.4f} ms, {bound_by}; "
                    f"{t['k4'] / t['cublas']:.2f}x cuBLAS fp32), plain {t['plain']:.4f} ms, "
                    f"cuBLAS fp32 on the dequantized weight {t['cublas']:.4f} ms; by route "
                  + ", ".join(f"{r}x{c} {ms:.4f}" for (r, c), ms in by_route.items())
                  + f" ms (CUDA events, mean of 2 x 20, in turns) on {smi}")
    for name in ("dec_to_qkv", "dec_to_out", "dec_ff_proj_out"):
        k, n = K4_DECODE_SHAPES[name]
        line = []
        for m in K4_CROSSOVER_ROWS:
            x, ql = _k4_operands(m, k, n, torch.float32, gen)
            gemv = k4_tile(min(m, K4_GEMV_ROWS), k, n, torch.float32, sms)
            t = in_turns({"gemv": _k4_call(x, ql, gemv), "tiled": _k4_call(x, ql, routes[0])})
            line.append(f"m {m}: GEMV {gemv[0]}x{gemv[1]} {t['gemv']:.4f}, tiled "
                        f"{t['tiled']:.4f}")
        log("k4", f"decode {name} ({k}, {n}) fp32 GEMV against tiled (ms; the host takes GEMV "
                  f"for m <= {K4_GEMV_ROWS}): " + "; ".join(line) + f" on {smi}")
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


def _small_trainer(device, items, model=None, trainer=None, batch: int = 2):
    def build():
        vb = vbt.VoiceBox(dim_in=32, **{**SMALL, **(model or {})})
        _soften_qk_gains(vb)
        return vbt.ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2, device=device)

    cfm = seeded(build, SEED + 4)
    return vbt.VoiceBoxTrainer(cfm, batch_size=batch, dataset=vbt.ArrayDataset(items),
                               num_train_steps=3, valid_frac=0.0, bucket_multiple=128,
                               log_every=1000, device=device, **SMALL_TRAIN, **(trainer or {}))


def phase_train_card_vs_cpu() -> None:
    rs = np.random.RandomState(SEED + 5)
    items = [(rs.randn(n, 32).astype(np.float32), rs.randint(0, 100, n).astype(np.int32))
             for n in (96, 90, 93, 96)]
    cpu, gpu = _small_trainer("cpu", items), _small_trainer("cuda", items)
    _compare_small_runs(cpu, gpu, rs, k1_per_step=SMALL["depth"])


def _update_gap(init: dict, cpu_module, gpu_module, lr: float) -> tuple:
    """(max abs diff, weights off by > 0.01 lr, weights, min per-tensor
    cosine) of the two devices' parameter updates since `init`."""
    worst, n_off, total, cos_min = 0.0, 0, 0, 1.0
    gpu_params = dict(gpu_module.named_parameters())
    for name, p in cpu_module.named_parameters():
        a = (gpu_params[name].detach().cpu() - init[name]).double()
        b = (p.detach() - init[name]).double()
        diff = (a - b).abs()
        worst = max(worst, diff.max().item())
        n_off += int((diff > 1e-2 * lr).sum())
        total += diff.numel()
        cos_min = min(cos_min, (a * b).sum().item() / max(a.norm().item() * b.norm().item(),
                                                          1e-30))
    return worst, n_off, total, cos_min


@contextlib.contextmanager
def _logits_reordered():
    """The CPU's plain attention with its logits summed in float64 and
    rounded to fp32: the same function in another summation order, as the
    card's kernels sum in another order than the CPU's BLAS."""
    plain = flash_module.reference_attention

    def reordered(q, k, v, mask=None, scale=None, return_lse=False, **kw):
        assert not kw.get("dropout"), "the floor run has no attention dropout"
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        sim = torch.matmul(q.double(), k.double().transpose(-1, -2)).float() * scale
        if mask is not None:
            sim = sim.masked_fill(~mask[:, None, None, :], flash_module.MASK_FILL)
        out = torch.matmul(torch.softmax(sim, dim=-1).to(v.dtype), v).to(q.dtype)
        return (out, torch.logsumexp(sim, dim=-1).unsqueeze(2)) if return_lse else out

    flash_module.reference_attention = reordered
    try:
        yield
    finally:
        flash_module.reference_attention = plain


def _compare_small_runs(cpu, gpu, rs, k1_per_step: int, label: str = "AdamW",
                        heads: dict = None, loss_tol: float = 1e-4,
                        cos_tol: float = 0.999, floor_run=None, frames: int = 124,
                        batch: int = 2) -> None:
    """3 steps of the small trainers on the same batches and draws; losses
    (to `loss_tol` relative) and parameter updates (per-tensor cosine above
    `cos_tol`) held card against CPU. With `floor_run`, a third CPU trainer
    from the same weights steps on the same draws with its logits summed in
    another order (`_logits_reordered`), and the losses are held to the
    larger of `loss_tol` and CARD_CPU_TIMES_FLOOR times its distance from
    the CPU's. `frames` is the batches' bucketed length (the phases' 90-96
    frames + 4 registers: 124 + 4 = 128 tokens), `batch` their rows."""
    init = {n: p.detach().clone() for n, p in cpu.cfm_wrapper.voicebox.named_parameters()}
    depth = SMALL["depth"]
    losses, floor_losses = [], []
    for step in range(3):
        m = batch
        draws = dict(noise=rs.randn(m, frames, 32).astype(np.float32),
                     times=rs.rand(m).astype(np.float32),
                     cond_mask=rs.rand(m, frames) < 0.7, cond_drop_mask=rs.rand(m) < 0.2)
        cpu_loss = cpu.train_step(**{k: torch.from_numpy(v) for k, v in draws.items()})["loss"]
        if floor_run is not None:
            with _logits_reordered():
                floor_losses.append(floor_run.train_step(
                    **{k: torch.from_numpy(v) for k, v in draws.items()})["loss"].item())
        reset_launches()
        gpu_loss = gpu.train_step(**{k: torch.from_numpy(v).cuda() for k, v in draws.items()})
        torch.cuda.synchronize()
        # step 0 also evaluates one validation batch: one more forward
        want = {"k1": k1_per_step + (depth if step == 0 else 0), "k2": depth, "k3": depth,
                "k4": 0}
        assert read_launches() == want, f"step {step} launched {read_launches()}, want {want}"
        losses.append((gpu_loss["loss"].item(), cpu_loss.item()))
    loss_err = max(abs(g - c) / abs(c) for g, c in losses)
    floor_note = ""
    if floor_run is not None:
        floor = max(abs(f - c) / abs(c) for f, (_, c) in zip(floor_losses, losses))
        loss_tol = max(loss_tol, CARD_CPU_TIMES_FLOOR * floor)
        floor_note = (f", the CPU against itself with the logits summed in another order "
                      f"{floor:.2e}: tol max of the bar and {CARD_CPU_TIMES_FLOOR:g} x that")
    lr = SMALL_TRAIN["lr"]
    worst, n_off, total, cos_min = _update_gap(init, cpu.cfm_wrapper.voicebox,
                                               gpu.cfm_wrapper.voicebox, lr)
    frac_off = n_off / total
    heads = {**SMALL, **(heads or {})}
    log("train", f"card vs CPU, fp32, dim {heads['dim']} depth 2 heads {heads['heads']}x"
                 f"{heads['dim_head']}, batch {batch} x {frames} frames + "
                 f"{heads['num_register_tokens']} registers, "
                 f"3 {label} steps (lr {lr:g}, clip 0.5): losses card/CPU "
                 f"{[(round(g, 6), round(c, 6)) for g, c in losses]}, max relative diff "
                 f"{loss_err:.2e} (tol {loss_tol:.3g}{floor_note}); K1/K2/K3 launches per step "
                 f"{k1_per_step}/"
                 f"{depth}/{depth}; parameter updates: min per-tensor cosine {cos_min:.6f} (tol > "
                 f"{cos_tol:g}), max abs diff {worst:.3e} (tol 6 lr = {6 * lr:g}), weights off by "
                 f"> 0.01 lr {n_off} of {total} (tol 1e-3 of them)")
    # Adam moves each weight by ~lr whatever its gradient's size, so a weight
    # whose gradient is near zero carries the two devices' summation-order
    # rounding amplified: a few weights may differ by up to a flipped update
    # (2 lr a step), the rest agree to rounding
    assert loss_err <= loss_tol, "losses disagree card vs CPU"
    assert cos_min > cos_tol and worst <= 6 * lr and frac_off <= 1e-3, (
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
    """Count by operand shape, while the block runs, each launch of K1, K2
    and K3 wherever it is called from (the attention modules' kernels and
    ring attention's blocks: the launch functions are wrapped) and each call
    of the w8a16 `QuantLinear`s (one call of K4's wrapper, one launch on CUDA
    tensors): {("k1" | "k2" | "k3", (b, h, n, kv, d), dtype, masked) or
    ("k4", (m, k, n), dtype): count}. Tallies may nest."""
    tally = collections.Counter()
    forward = QuantLinear.forward
    saved = {name: getattr(flash_module, name) for name in
             ("_launch_k1", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")}

    def counted(kernel, fn):
        def call(q, k, v, mask, *args, **kw):
            tally[kernel, (*q.shape[:3], k.shape[2], q.shape[3]), q.dtype,
                  mask is not None] += 1
            try:
                return fn(q, k, v, mask, *args, **kw)
            finally:  # K2 and K3 count on the name they are called by: this one
                if call.launches:
                    call.root.launches += call.launches
                    call.launches = 0
        call.launches, call.root = 0, getattr(fn, "root", fn)
        return call

    def quant_forward(layer, x):
        if layer.mode == "w8a16":
            m = x.numel() // layer.in_features
            tally["k4", (m, layer.in_features, layer.out_features), layer.compute_dtype] += 1
        return forward(layer, x)

    for kernel, name in zip(("k1", "k2", "k3"), saved):
        setattr(flash_module, name, counted(kernel, saved[name]))
    QuantLinear.forward = quant_forward
    try:
        yield tally
    finally:
        for name, fn in saved.items():
            setattr(flash_module, name, fn)
        QuantLinear.forward = forward


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


# long-form serving and cloning at full width (phase 9b): phase 9's engine
# with raw-prompt buckets, at the engine's default window 768 and overlap 128
LONG_ENGINE = dict(ENGINE, prompt_seconds_buckets=(3.0, 6.0))
LONG_MIN_FRAMES = 2048  # >= 27.3 s: 3 windows at least (768 + 2 x 640)
CLONE_MIN_FRAMES = 900  # the prompt's 225 frames and the continuation: 2 windows
PROMPT_SAMPLES = 72_000  # a 3 s prompt at 24 kHz
PROMPT_TEXT = "a voice that the engine should keep"
# requests of each kind: time to first chunk and latency (3 until phase 15b's
# head-dim-256 paths needed room under the script's clock, 2 until phase 24)
LONG_REPEATS = 1
K1_PER_WINDOW = EVALS_PER_REQUEST * FLAGSHIP["depth"]  # 96
K4_PER_WINDOW = 4 * K1_PER_WINDOW  # 384
# the streamed decode against the one-shot decode of the same latents, fp32
# with TF32 off: |streamed - one-shot| <= LONG_SEAM_TOL x max |one-shot|.
# Measured 7.3e-7 of the peak on an H100 over 2050 frames (no sample past
# 1e-6): the convolutions of each buffer length round apart, no seam
LONG_SEAM_TOL = 1e-5


def _text_of(n_chars: int) -> str:
    words = []
    while len(" ".join(words)) < n_chars:
        words += _WORDS
    return " ".join(words)[:n_chars]


def _long_plan(engine, text: str, cond=None, prompt_frames: int = 0) -> dict:
    """What a long request of `text` (behind `prompt_frames` of prompt,
    whose latents `cond` condition the predictor) runs: its exact frames,
    windows and predictor forwards. Runs the predictor, outside any count."""
    ids = np.asarray(engine._tokenizer().texts_to_tensor_ids([text]))
    row = ids[:, : int((ids[0] >= 0).sum())]
    _, groups = engine._segment_groups(row)
    _, gen_exact = engine._long_frame_ids(row, cond=cond)
    exact = prompt_frames + gen_exact
    window, hop = engine.long_window_frames, engine.long_window_frames - engine.long_overlap_frames
    windows = 1 + -(-max(exact - window, 0) // hop)
    return {"tokens": row.shape[1], "exact": exact, "windows": windows, "forwards": len(groups)}


def _text_for_frames(engine, min_frames: int, cond=None, prompt_frames: int = 0):
    """The shortest text (doubling from 128 characters) whose exact frames
    under the seeded predictor reach `min_frames`, and its plan."""
    n = 128
    while True:
        text = _text_of(n)
        plan = _long_plan(engine, text, cond, prompt_frames)
        if plan["exact"] >= min_frames:
            return text, plan
        n *= 2


def _stream_timed(chunks) -> tuple:
    """Consume a stream as a player would, each chunk read to the host:
    (audio, ms to the first chunk, ms to the last)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, out = None, []
    for chunk in chunks:
        out.append(chunk.cpu())
        if first is None:
            first = (time.perf_counter() - t0) * 1e3
    return torch.cat(out, dim=-1), first, (time.perf_counter() - t0) * 1e3


def phase_long_card_vs_cpu() -> None:
    """`sample_long` of phase 6's small fp32 configuration on the card and on
    the CPU from the same weights and the same noise of each window (drawn
    on the host): 3 windows of 96 frames overlapping by 16 over 230 frames,
    with a latent prompt of 20."""
    cfm_cpu = seeded(lambda: _small_slice("cpu"), SEED).eval()
    cfm_gpu = seeded(lambda: _small_slice("cuda"), SEED).eval()
    gen = torch.Generator().manual_seed(SEED + 90)
    ids = torch.randint(0, 100, (2, 150), generator=gen)
    prompt = torch.randn(2, 20, 32, generator=gen)
    kw = dict(total_frames=230, window_frames=96, overlap_frames=16, steps=STEPS,
              cond_scale=CFG_SCALE, decode_to_audio=False)
    draw = cfm_module.normal

    def run(cfm, device):
        noise = torch.Generator().manual_seed(SEED + 91)
        cfm_module.normal = lambda shape, *_, **__: torch.randn(shape, generator=noise).to(device)
        try:
            return cfm.sample_long(semantic_token_ids=ids.to(device), prompt=prompt.to(device),
                                   **kw)
        finally:
            cfm_module.normal = draw

    before = read_launches()
    lat_cpu = run(cfm_cpu, "cpu")
    assert read_launches() == before, "the CPU run must launch no kernel"
    lat_gpu = run(cfm_gpu, "cuda").cpu()
    launches = {k: v - before[k] for k, v in read_launches().items()}
    want = SMALL["depth"] * EVALS_PER_REQUEST * 3
    assert launches == {"k1": want, "k2": 0, "k3": 0, "k4": 0}, launches
    err = (lat_gpu - lat_cpu).abs().max().item()
    log("long", f"sample_long card vs CPU, fp32, dim 128 depth 2, 230 frames in 3 windows of 96 "
                f"(overlap 16), a 20-frame prompt, steps {STEPS}, cfg {CFG_SCALE}: K1 launches "
                f"{launches['k1']}, latents max_abs_err {err:.3e} (tol 1e-3); the prompt's "
                f"span kept exactly {torch.equal(lat_gpu[:, :20], prompt)}")
    assert math.isfinite(err) and err <= 1e-3, "sample_long disagrees card vs CPU"
    assert torch.equal(lat_gpu[:, :20], prompt) and torch.equal(lat_cpu[:, :20], prompt)


def phase_long(smi: str) -> tuple:
    """Phase 9b: long-form serving and cloning on phase 9's quantized
    duration-mode engine (same seeded weights), with 3 s and 6 s prompt
    buckets."""
    t_phase = time.perf_counter()
    cfm = seeded(_engine_flagship, SEED + 12).eval()
    engine = vbt.TTSEngine(cfm, **LONG_ENGINE)
    codec = cfm.codec
    sr, spf = codec.sampling_rate, codec.downsample_factor
    window, overlap = engine.long_window_frames, engine.long_overlap_frames

    # warmup: the window program, each prompt bucket's encode, the
    # prompt-conditioned predictor at each (batch, text) bucket
    warmed = collections.Counter()
    stream, encode, predict = cfm.sample_long_stream, codec.encode, engine._predict_durations

    def spy_stream(**kw):
        warmed["long_stream", kw["total_frames"]] += 1
        return stream(**kw)

    def spy_encode(audio):
        warmed["encode", audio.shape[-1]] += 1
        return encode(audio)

    def spy_predict(ids, cond=None):
        warmed["predictor_with_cond" if cond is not None else "predictor", ids.shape] += 1
        return predict(ids, cond=cond)

    cfm.sample_long_stream, codec.encode, engine._predict_durations = (spy_stream, spy_encode,
                                                                       spy_predict)
    try:
        t_warm = engine.warmup()
    finally:
        del cfm.sample_long_stream, codec.encode, engine._predict_durations
    buckets = [(b, n) for b in engine.batch_buckets for n in engine.text_buckets]
    want_warm = {("long_stream", 2 * window - overlap): 1, ("encode", 72_000): 1,
                 ("encode", 144_000): 1,
                 **{("predictor_with_cond", bn): 1 for bn in buckets},
                 **{("predictor", bn): 1 for bn in buckets}}
    assert warmed == want_warm, f"warmup ran {dict(warmed)}, want {want_warm}"
    log("long", f"TTSEngine({LONG_ENGINE}), window {window}, overlap {overlap}: warmup in "
                f"{t_warm:.2f} s covered the 9 buckets, one two-window stream of "
                f"{2 * window - overlap} frames, the encode of each prompt bucket (3 s, 6 s) "
                f"and the prompt-conditioned predictor at each of the 9 buckets")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    wave = torch.from_numpy(_waves(1, PROMPT_SAMPLES, SEED + 81)[0])[None]
    # the plans (the predictor runs here, outside the counted run)
    text, plan = _text_for_frames(engine, LONG_MIN_FRAMES)
    p_lat, p_ids = engine._prepare_prompt(wave, None, PROMPT_TEXT)
    p_frames = p_lat.shape[1]
    clone_text, cplan = _text_for_frames(engine, CLONE_MIN_FRAMES, cond=p_lat,
                                         prompt_frames=p_frames)
    assert plan["windows"] >= 3 and p_ids.shape == (1, p_frames), (plan, p_ids.shape)

    def launches_of(p, prompt_forwards=0):
        return {"k1": K1_PER_WINDOW * p["windows"] + DP_DEPTH * (p["forwards"] + prompt_forwards),
                "k2": 0, "k3": 0, "k4": K4_PER_WINDOW * p["windows"]}

    want_long, want_clone = launches_of(plan), launches_of(cplan, prompt_forwards=1)

    def counted(fn, want):
        before = read_launches()
        out = fn()
        got = {k: v - before[k] for k, v in read_launches().items()}
        assert got == want, f"a request launched {got}, want {want}"
        return out

    def check_audio(audio, frames):
        assert audio.shape[-1] == audio.numel() == frames * spf, (tuple(audio.shape), frames)
        assert bool(torch.isfinite(audio).all()), "non-finite audio"

    reset_launches()  # the long-form and cloning path's run starts here
    runs = {"long stream": [], "clone stream": []}
    with shape_tally() as tally:
        for _ in range(LONG_REPEATS):
            audio, first, total = counted(
                lambda: _stream_timed(engine.synthesize_stream(text, generator=gen)), want_long)
            check_audio(audio, plan["exact"])
            runs["long stream"].append((first, total))
        (audio, lens), synth_ms = _timed(lambda: counted(
            lambda: engine.synthesize([text], generator=gen, return_lengths=True), want_long))
        check_audio(audio, plan["exact"])
        assert lens.tolist() == [plan["exact"] * spf], lens
        for _ in range(LONG_REPEATS):
            audio, first, total = counted(lambda: _stream_timed(engine.clone_stream(
                clone_text, wave, prompt_text=PROMPT_TEXT, generator=gen)), want_clone)
            check_audio(audio, cplan["exact"] - p_frames)
            runs["clone stream"].append((first, total))
        clip = counted(lambda: engine.clone(clone_text, wave, prompt_text=PROMPT_TEXT,
                                            generator=gen), want_clone)
        check_audio(clip, cplan["exact"] - p_frames)
        before = read_launches()
        with vbt.DynamicBatcher(engine, max_wait_ms=100.0, seed=SEED) as batcher:
            f_long = batcher.submit(text)
            f_clone = batcher.submit_clone(clone_text, wave, prompt_text=PROMPT_TEXT)
            b_long, b_clone = f_long.result(timeout=600), f_clone.result(timeout=600)
        got = {k: v - before[k] for k, v in read_launches().items()}
        both = {k: want_long[k] + want_clone[k] for k in want_long}
        assert got == both, f"the batcher's two requests launched {got}, want {both}"
        check_audio(b_long, plan["exact"])
        check_audio(b_clone, cplan["exact"] - p_frames)
    counts = read_launches()  # the path's run ends here
    requests = 2 * LONG_REPEATS + 4
    windows = (LONG_REPEATS + 2) * plan["windows"] + (LONG_REPEATS + 2) * cplan["windows"]
    assert counts["k4"] == K4_PER_WINDOW * windows, (counts, windows)
    assert counts["k2"] == counts["k3"] == 0
    for kernel in ("k1", "k4"):
        tallied = sum(c for key, c in tally.items() if key[0] == kernel)
        assert tallied == counts[kernel], f"{kernel}: {tallied} calls, {counts[kernel]} launches"
    window_k1 = {key: c for key, c in tally.items() if key[0] == "k1"
                 and key[2] == torch.bfloat16}
    assert window_k1 == {("k1", (2, 4, window + 16, window + 16, 128), torch.bfloat16, False):
                         K1_PER_WINDOW * windows}, window_k1

    for kind, p, audio_frames in (("long stream", plan, plan["exact"]),
                                  ("clone stream", cplan, cplan["exact"] - p_frames)):
        audio_s = audio_frames * spf / sr
        first = [f for f, _ in runs[kind]]
        total = [t for _, t in runs[kind]]
        log("long", f"{kind}: {p['tokens']} tokens, {p['exact']} exact frames"
                    + (f" ({p_frames} of them the 3 s prompt's)" if kind.startswith("clone")
                       else "")
                    + f", {p['windows']} windows of {window} (hop {window - overlap}), "
                    f"{audio_s:.2f} s of audio out; time to the first chunk on the host "
                    f"{_min_median(first)}; latency {_min_median(total)} (all "
                    f"{[round(t, 1) for t in total]}); RTF median "
                    f"{np.median(total) / 1e3 / audio_s:.5f}; launches per window "
                    f"{K1_PER_WINDOW} K1 + {K4_PER_WINDOW} K4, plus {DP_DEPTH} K1 per "
                    f"predictor forward x {p['forwards'] + (1 if kind.startswith('clone') else 0)}"
                    f" on {smi}")
    log("long", f"synthesize of the long text (one call, not streamed): {synth_ms:.1f} ms, "
                f"lengths {lens.tolist()} = exact frames x {spf}; clone of {clone_text[:24]!r}... "
                f"from a 3 s raw prompt ({PROMPT_SAMPLES} samples, bucket 3 s, {p_frames} "
                f"frames, ids from prompt_text) -> {clip.shape[-1]} samples; DynamicBatcher: "
                f"an over-bucket submit and a submit_clone served ({b_long.shape[-1]}, "
                f"{b_clone.shape[-1]} samples); path totals {counts} over {requests} requests, "
                f"{windows} windows; launches by shape "
                f"{ {(k[0], k[1], str(k[2])[6:]): c for k, c in tally.items()} }")

    # the streamed decode against the one-shot decode of the same latents
    ids = np.asarray(engine._tokenizer().texts_to_tensor_ids([text]))
    cond_ids, exact = engine._long_frame_ids(ids[:, : plan["tokens"]])
    chunks = list(cfm._sample_long_chunks(
        semantic_token_ids=torch.from_numpy(cond_ids), total_frames=exact,
        window_frames=window, overlap_frames=overlap, prompt=None, steps=STEPS,
        cond_scale=CFG_SCALE, quantize="w8a16", param_store_dtype=None, generator=gen))
    latents = torch.cat(chunks, dim=1)
    streamed = torch.cat(list(cfm._stream_decode(iter(chunks), codec, True, overlap)), dim=-1)
    one_shot = codec.decode(latents)
    peak = one_shot.abs().max().item()
    gap = (streamed - one_shot).abs()
    worst = int(gap.flatten().argmax()) // spf
    log("long", f"streamed decode vs one-shot decode of the same {exact} frames (fp32, TF32 "
                f"off, ctx = guard = {overlap} frames): max_abs_err {gap.max().item():.3e}, "
                f"{gap.max().item() / peak:.3e} of the peak {peak:.3e} (tol {LONG_SEAM_TOL:g} x "
                f"peak), worst at frame {worst}; samples off by more than 1e-6 x peak "
                f"{int((gap > 1e-6 * peak).sum())} of {gap.numel()}")
    assert tuple(streamed.shape) == tuple(one_shot.shape) == (1, 1, exact * spf)
    assert gap.max().item() <= LONG_SEAM_TOL * peak, "the streamed decode leaves a seam"

    prof = _profile(lambda: list(engine.synthesize_stream(text, generator=gen)))
    idle = prof["idle"]
    log("long", f"profiled long stream ({plan['windows']} windows): wall {prof['wall_ms']:.2f} "
                f"ms, device busy {prof['busy_ms']:.2f} ms over {prof['kernels']} kernels "
                f"(K1/K2/K3 {prof['attention_ms']:.2f} ms, K4 {prof['k4_ms']:.2f} ms over "
                f"{prof['k4_kernels']}), idle share "
                f"{'not measured' if idle is None else f'{idle:.3f}'}; largest (name, ms, "
                f"calls): {'; '.join(f'{n} {t:.3f} {c}' for n, t, c in prof['top'])}")
    log("long", f"phase 9b took {time.perf_counter() - t_phase:.1f} s")
    del cfm, engine
    torch.cuda.empty_cache()
    return counts, tally


def _profile(step) -> dict:
    """One call of `step` (a training step, a request) under torch.profiler:
    the host wall time, the union of the device's kernel intervals (busy),
    the idle share 1 - busy / wall, the number of device kernels, the number
    of record_function ranges the profiler also put on the device's timeline
    (left out of the kernels and of busy), the device time of K1, K2 and K3,
    K4's device time and launches, and the largest kernels by device time
    (`utils/profiling.py::kernel_summary`). The idle share is None when the
    profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _device_summary(prof, wall_us)


def _device_summary(prof, wall_us: float) -> dict:
    """`_profile`'s numbers from the profiler's raw results: device activity
    only (the profiler also puts each record_function range, such as the
    optimizer's step, on the device's timeline). `prof.events()` would first
    build the host's event tree, which takes tens of seconds for a window of
    tens of thousands of launches on a slow host."""
    on_device = [e for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
    kernels_ = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3) for e in on_device
                if not e.is_user_annotation()]
    return {**kernel_summary(kernels_, wall_us), "annotations": len(on_device) - len(kernels_)}


def phase_train(smi: str) -> dict:
    def build():
        vb = vbt.VoiceBox(dim_in=LATENT_DIM, dtype=torch.bfloat16, param_dtype=torch.float32,
                          **FLAGSHIP)
        return vbt.ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2)

    cfm = seeded(build, SEED + 6)
    # the weights before any step, for the gradient witness (phase 11): the
    # kernels under test train them here
    untrained = {k: v.detach().to("cpu", copy=True) for k, v in cfm.voicebox.state_dict().items()}
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
    MEASURED.update(train_peak_gib=peak_gib, train_steps_s=TRAIN_TIMED / (gpu_ms / 1e3))

    losses = torch.stack([lg["loss"] for lg in logs]).tolist()
    norms = torch.stack([lg["grad_norm"] for lg in logs]).tolist()
    assert all(math.isfinite(x) for x in losses + norms), f"non-finite {losses} {norms}"
    moved = {n: (p.detach() - watched[n]).abs().max().item() for n, p in trainer.named_params
             if n in watched}
    assert all(m > 0 for m in moved.values()), f"parameters did not change: {moved}"
    prof = _profile(trainer.train_step)
    idle = prof["idle"]
    MEASURED.update(train_busy_ms=prof["busy_ms"])
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
    return counts, trainer, untrained


WITNESS_DELTA = 2.0 ** -20  # the noise floor's change of the attention scale


def _plain_attention(factor: float = 1.0):
    """Autograd of the plain `reference_attention`, its scale times `factor`."""
    def attend(q, k, v, mask=None, scale=None, scores_dtype=None):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        return reference_attention(q, k, v, mask, scale * factor, scores_dtype=scores_dtype)
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


def phase_grad_witness(trainer, untrained: dict, smi: str) -> None:
    """The flagship's gradient through K1/K2/K3 against the plain attention
    on the card: the seeded flagship's weights as they were before phase 10
    trained them through the kernels under test (`untrained`), one training
    batch and the same draws, computing in bf16 (the trained configuration)
    and in fp32 (the same weights in a VoiceBox computing in fp32). The
    noise floor is the plain attention against itself with its scale moved
    by 2^-20 either way, a change the size of the logits' summation-order
    rounding.

    With unit qk gains (logits up to 10 d), and in bf16 whatever the gains,
    the floor shows that no two computations of this gradient agree in its
    direction: the checks there are that the kernels stay as close to the
    plain version as the floor shows the plain version stays to itself, in
    the loss, in the last layer's gradient norm and in the global norm's
    order of magnitude. In fp32 with the qk gains set to 0.25 (logits up to
    80) the gradient is well conditioned and the kernels must match the
    plain version within WITNESS_TOL. The floor's own distance from 1 in
    the global norm is printed beside its limit; should it exceed the limit
    at these weights, the check holds the norm to the floor and says so."""
    batch = trainer._next_batch(trainer.dl_iter)
    names = [n for n, _ in trainer.named_params]
    trainer.cfm_wrapper.voicebox.load_state_dict(untrained)

    def build_f32():
        vb = vbt.VoiceBox(dim_in=LATENT_DIM, dtype=torch.float32, param_dtype=torch.float32,
                          **FLAGSHIP)
        return vbt.ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2)

    cfm32 = seeded(build_f32, SEED + 8)
    cfm32.voicebox.load_state_dict(untrained)
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
                floor_norm = max(abs(f["norm"] - 1) for f in floors)
                held = "the fixed limit" if floor_norm <= norm_tol else "the floor, above the limit"
                norm_tol = max(norm_tol, floor_norm)
                ok = ok and (gap["loss"] <= loss_tol and abs(gap["norm"] - 1) <= norm_tol
                             and gap["cos"] > cos_tol
                             and min(c for _, c in gap["leaves"].values()) > cos_tol)
                log("witness", f"{name}: tol loss {loss_tol:g}, global norm {norm_tol:.3g} "
                               f"({held}; limit {WITNESS_TOL[1]:g}, the floor's own distance "
                               f"{floor_norm:.3g}), cosines > {cos_tol:g}; kernels' distance "
                               f"{abs(gap['norm'] - 1):.3g}")
            if not ok:
                failed.append(name)
            del plain
    del cfm32, params32
    torch.cuda.empty_cache()
    assert not failed, f"the flagship gradient through the kernels disagrees with the plain " \
                       f"attention: {failed}"


# phase 12: the training levers at full width. Each configuration is the
# flagship step of phase 10 (bf16 compute, fp32 parameters) with one change.
LEVERS = {
    "a_baseline": ({}, {}),
    "b_bf16_params_moments": ({}, dict(param_dtype=torch.bfloat16, moment_dtype=torch.bfloat16)),
    "c_b_plus_ema": ({}, dict(param_dtype=torch.bfloat16, moment_dtype=torch.bfloat16,
                              ema_decay=0.999)),
    "d_remat_full": (dict(remat=True), {}),
    "e_remat_dots_attn": (dict(remat=True, remat_policy="dots+attn_out+attn_lse"), {}),
}
# steps before timing; steps per turn (3 until the pipeline phase needed
# the script's time, 2 until the head dims past 256 did)
LEVER_WARMUP, LEVER_TURN_STEPS = 2, 1
ODE_LOOSE = 5e-2  # atol = rtol of the adaptive Tsit5 sample
SAMPLE_FRAMES = 300


def _levers_trainer(model_kw: dict, trainer_kw: dict, items, seed: int, **extra):
    def build():
        vb = vbt.VoiceBox(dim_in=LATENT_DIM, dtype=torch.bfloat16, param_dtype=torch.float32,
                          **FLAGSHIP, **model_kw)
        return vbt.ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2, **extra)

    cfm = seeded_on("cuda:0", build, seed)
    return vbt.VoiceBoxTrainer(
        cfm, batch_size=TRAIN_BATCH, dataset=vbt.ArrayDataset(items), num_train_steps=1000,
        lr=1e-4, wd=1e-2, max_grad_norm=0.5, valid_frac=0.0, log_every=1000,
        save_results_every=1000, seed=SEED, **trainer_kw,
    )


def _state_bytes(trainer) -> int:
    """Bytes the trainer keeps on the card between steps: parameters, their
    bf16 live copies, the optimizer's moments and the EMA."""
    tensors = list(trainer.params) + list(trainer._live or [])
    tensors += list(trainer.ema.shadow) if trainer.ema is not None else []
    for st in trainer.optimizer.state.values():
        tensors += [v for v in st.values() if torch.is_tensor(v) and v.is_cuda]
    return sum(t.numel() * t.element_size() for t in tensors)


def _k1_per_step(model_kw: dict) -> int:
    """K1 launches of one flagship step: the forward, and again in the
    backward's recompute unless the remat policy saves K1's outputs."""
    depth = FLAGSHIP["depth"]
    policy = model_kw.get("remat_policy") or ""
    saved = {"attn_out", "attn_lse"} <= set(policy.split("+"))
    return 2 * depth if model_kw.get("remat") and not saved else depth


def phase_levers(smi: str) -> dict:
    """The five configurations trained in turns (a, b, c, d, e, e, d, c, b,
    a; each turn LEVER_TURN_STEPS steps after LEVER_WARMUP warm-up steps):
    per configuration steps/s and device ms per step from CUDA events, host
    steps/s, launches per step (asserted) and peak memory (its state on the
    card between steps plus the transient peak of its steps). Then the EMA
    of configuration (c) samples 300 frames through adaptive Tsit5
    (`use_torchode=True`, atol = rtol = ODE_LOOSE) and through fixed-grid
    Tsit5: finite latents and 24 K1 launches per evaluation. Returns the
    launch counts of the timed turns and each configuration's launches per
    step."""
    rs = np.random.RandomState(SEED + 7)
    items = [(rs.randn(TRAIN_FRAMES, LATENT_DIM).astype(np.float32),
              rs.randint(0, FLAGSHIP["num_cond_tokens"], TRAIN_FRAMES).astype(np.int32))
             for _ in range(40)]
    depth = FLAGSHIP["depth"]
    trainers, expected = {}, {}
    for i, (name, (model_kw, trainer_kw)) in enumerate(LEVERS.items()):
        extra = dict(use_torchode=True, ode_atol=ODE_LOOSE, ode_rtol=ODE_LOOSE) \
            if name == "c_b_plus_ema" else {}
        trainers[name] = _levers_trainer(model_kw, trainer_kw, items, SEED + 6, **extra)
        expected[name] = {"k1": _k1_per_step(model_kw), "k2": depth, "k3": depth, "k4": 0}
        for _ in range(LEVER_WARMUP):  # step 0 also runs the validation batch
            trainers[name].train_step()
    torch.cuda.synchronize()

    stats = {n: {"gpu_ms": [], "host_s": [], "peak": 0, "losses": []} for n in trainers}
    reset_launches()  # the levers path's run starts here
    for name in list(trainers) + list(trainers)[::-1]:
        trainer, st = trainers[name], stats[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(LEVER_TURN_STEPS):
            before = read_launches()
            st["losses"].append(trainer.train_step()["loss"])
            after = read_launches()
            got = {k: after[k] - before[k] for k in after}
            assert got == expected[name], f"{name}: a step launched {got}, want {expected[name]}"
        end.record()
        torch.cuda.synchronize()
        st["host_s"].append(time.perf_counter() - t0)
        st["gpu_ms"].append(start.elapsed_time(end))
        transient = torch.cuda.max_memory_allocated() - base
        st["peak"] = max(st["peak"], _state_bytes(trainer) + transient)
    counts = read_launches()
    results = {}
    for name, st in stats.items():
        prof = _profile(trainers[name].train_step)  # after the counted run
        losses = torch.stack(st["losses"]).tolist()
        assert all(math.isfinite(x) for x in losses), f"{name}: non-finite loss {losses}"
        steps = LEVER_TURN_STEPS * len(st["gpu_ms"])
        ms = sum(st["gpu_ms"]) / steps
        results[name] = {"steps_per_s": 1e3 / ms, "device_ms_per_step": ms,
                         "host_steps_per_s": steps / sum(st["host_s"]),
                         "peak_gib": st["peak"] / 2**30, "launches_per_step": expected[name],
                         "state_gib": _state_bytes(trainers[name]) / 2**30,
                         "busy_ms": prof["busy_ms"], "idle": prof["idle"],
                         "kernels": prof["kernels"]}
        log("levers", f"{name}: steps/s {results[name]['steps_per_s']:.3f} (CUDA events, "
                      f"{ms:.2f} ms/step over {steps} steps in 2 turns), host clock "
                      f"{results[name]['host_steps_per_s']:.3f} steps/s, launches per step "
                      f"K1/K2/K3 {expected[name]['k1']}/{depth}/{depth}, peak memory "
                      f"{results[name]['peak_gib']:.2f} GiB (state on the card "
                      f"{results[name]['state_gib']:.2f} GiB + the steps' transient peak), "
                      f"losses {[round(x, 4) for x in losses]} on {smi}")
        idle = "not measured" if prof["idle"] is None else f"{prof['idle']:.3f}"
        log("levers", f"{name}: profiled step: wall {prof['wall_ms']:.2f} ms, device busy "
                      f"{prof['busy_ms']:.2f} ms over {prof['kernels']} kernels, idle share "
                      f"{idle}; largest (name, ms, calls): "
                      f"{'; '.join(f'{n} {t:.3f} {c}' for n, t, c in prof['top'][:5])}")
    ema_trainer = trainers.pop("c_b_plus_ema")
    del trainers
    torch.cuda.empty_cache()
    _ema_samples(ema_trainer, smi)
    del ema_trainer
    torch.cuda.empty_cache()
    return counts, {n: r["launches_per_step"] for n, r in results.items()}


def _ema_samples(trainer, smi: str) -> None:
    cfm = trainer.cfm_wrapper
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    cond = torch.randn(1, SAMPLE_FRAMES, LATENT_DIM, generator=gen, device="cuda")
    ids = torch.randint(0, FLAGSHIP["num_cond_tokens"], (1, SAMPLE_FRAMES), generator=gen,
                        device="cuda")
    depth = FLAGSHIP["depth"]
    for method in ("tsit5_adaptive", "tsit5"):
        cfm.ode_method = method
        before = flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.generate(use_ema=True, cond=cond, semantic_token_ids=ids, steps=STEPS,
                               cond_scale=CFG_SCALE, generator=gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = flash_attention.launches - before
        evals = 7 * (cfm.ode_steps_taken if method == "tsit5_adaptive" else STEPS - 1)
        assert tuple(out.shape) == (1, SAMPLE_FRAMES, LATENT_DIM), tuple(out.shape)
        assert bool(torch.isfinite(out).all()), f"{method}: non-finite EMA latents"
        assert launches == depth * evals, f"{method}: {launches} K1 launches, want {depth * evals}"
        steps_note = (f"{cfm.ode_steps_taken} adaptive steps (atol = rtol = {ODE_LOOSE:g}, "
                      f"max 256)" if method == "tsit5_adaptive" else f"{STEPS - 1} intervals")
        log("levers", f"EMA (decay 0.999, fp32) sample, {method}: {steps_note}, {evals} "
                      f"evaluations at CFG {CFG_SCALE} (batch 2 x {SAMPLE_FRAMES} frames + 16 "
                      f"registers), K1 launches {launches} = 24 x evaluations, latents finite, "
                      f"|latents| max {out.abs().max().item():.3f}, host {dt * 1e3:.1f} ms on "
                      f"{smi}")


def phase_resume(smi: str) -> None:
    """Configuration (c) at full width: a run saves after 2 steps and takes a
    third; a trainer built from other weights loads the file and takes the
    same third step (same batch: every item of the dataset is the same; same
    draws). Its loss, every parameter, both moments and the EMA must equal the
    uninterrupted run's to the bit. cuDNN runs deterministic algorithms here
    (ConvPositionEmbed's weight gradient), so the check is about the file."""
    rs = np.random.RandomState(SEED + 31)
    item = (rs.randn(TRAIN_FRAMES, LATENT_DIM).astype(np.float32),
            rs.randint(0, FLAGSHIP["num_cond_tokens"], TRAIN_FRAMES).astype(np.int32))
    model_kw, trainer_kw = LEVERS["c_b_plus_ema"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    frames = TRAIN_FRAMES

    def draws():
        m = TRAIN_BATCH
        return dict(noise=torch.randn(m, frames, LATENT_DIM, generator=gen, device="cuda"),
                    times=torch.rand(m, generator=gen, device="cuda"),
                    cond_mask=torch.rand(m, frames, generator=gen, device="cuda") < 0.7,
                    cond_drop_mask=torch.rand(m, generator=gen, device="cuda") < 0.2)

    step_draws = [draws() for _ in range(3)]
    path = kernels.BUILD_DIR.parent / "levers_resume.pt"  # in the checkout, ignored by git
    path.parent.mkdir(parents=True, exist_ok=True)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        a = _levers_trainer(model_kw, trainer_kw, [item] * TRAIN_BATCH, SEED + 33)
        for d in step_draws[:2]:
            a.train_step(**d)
        t0 = time.perf_counter()
        a.save(path)
        save_s = time.perf_counter() - t0
        loss_a = a.train_step(**step_draws[2])["loss"]
        b = _levers_trainer(model_kw, trainer_kw, [item] * TRAIN_BATCH, SEED + 34)
        t0 = time.perf_counter()
        b.load(path)
        load_s = time.perf_counter() - t0
        assert b.steps == 2, b.steps
        loss_b = b.train_step(**step_draws[2])["loss"]
        torch.cuda.synchronize()
        same = torch.equal(loss_a, loss_b)
        differ = [n for (n, p), q in zip(a.named_params, b.params) if not torch.equal(p, q)]
        differ += [f"{key} {n}" for (n, p), q in zip(a.named_params, b.params)
                   for key in ("exp_avg", "exp_avg_sq")
                   if not torch.equal(a.optimizer.state[p][key], b.optimizer.state[q][key])]
        differ += [f"ema {n}" for (n, _), x, y in zip(a.named_params, a.ema.shadow, b.ema.shadow)
                   if not torch.equal(x, y)]
        size_mb = path.stat().st_size / 2**20
        log("resume", f"configuration (c) at full width: saved after 2 steps "
                      f"({size_mb:.0f} MiB, {save_s:.2f} s), loaded into a trainer built from "
                      f"other weights ({load_s:.2f} s); third step loss uninterrupted "
                      f"{loss_a.item():.6f} resumed {loss_b.item():.6f}, bit-identical "
                      f"{same}; tensors that differ (parameters, moments, EMA): "
                      f"{len(differ)} on {smi}")
        assert same and not differ, f"the resumed run differs: loss {same}, {differ[:5]}"
    finally:
        torch.backends.cudnn.deterministic = was
        path.unlink(missing_ok=True)
    del a, b
    torch.cuda.empty_cache()


def phase_levers_card_vs_cpu() -> None:
    """Phase 7's small fp32 denoiser with bf16 moments and full remat, 3
    steps on the card and on the CPU, held to phase 7's tolerances."""
    rs = np.random.RandomState(SEED + 35)
    items = [(rs.randn(n, 32).astype(np.float32), rs.randint(0, 100, n).astype(np.int32))
             for n in (96, 90, 93, 96)]
    levers = dict(model=dict(remat=True), trainer=dict(moment_dtype=torch.bfloat16))
    cpu, gpu = (_small_trainer(dev, items, **levers) for dev in ("cpu", "cuda"))
    _compare_small_runs(cpu, gpu, rs, k1_per_step=2 * SMALL["depth"],
                        label="bf16-moment Adam, full-remat")


# ---------------------------------------------------------------------------
# the raw-audio path and duration-predictor training (phases 13-16)

WAVE_SAMPLES = 240_000  # 10 s at 24 kHz
# BASELINE config 2: the flagship denoiser on vocos-mel-24khz log-mels of raw
# waves, without text (raw-wave datasets carry no conditioning ids)
MEL_FLAGSHIP = {**FLAGSHIP, "condition_on_text": False, "num_cond_tokens": None}
MEL_HOP = 256
MEL_FRAMES = WAVE_SAMPLES // MEL_HOP + 1  # 938: a 10 s prompt
MEL_TRAIN_TIMED = 4
# BASELINE config 4: the reference DurationPredictor trained on (text, 10 s
# wave) items through the same codec, its aligner on the 100 mels
DP_TRAIN_BATCH, DP_PHONEME_BUCKET, DP_TRAIN_TIMED = 8, 128, 4
DP_SAMPLE_TEXT = "a trained duration predictor decides how long each sound will be"  # 64
_WORDS = ("the quick brown fox jumps over a lazy dog while seven singers hum a low tune near "
          "quiet rivers and bright open fields of tall green grass").split()
# the small fp32 configurations of phase 13
SMALL_MEL = dict(n_mels=32, n_fft=256, win_length=160)
SMALL_MEL_VOCOS = dict(input_channels=32, dim=32, intermediate_dim=48, num_layers=1, n_fft=256,
                       hop_length=64)
SMALL_DP = dict(dim_phoneme_emb=64, dim=64, depth=2, dim_head=64, heads=2, aligner_dim_in=32,
                aligner_attn_channels=16)


def _waves(n: int, samples: int, seed: int) -> list:
    """`n` float32 waves of `samples` at 24 kHz: three tones under noise."""
    rs = np.random.RandomState(seed)
    t = np.arange(samples, dtype=np.float32) / np.float32(24000.0)
    out = []
    for _ in range(n):
        w = sum(np.float32(0.2) * np.sin(np.float32(2 * np.pi) * f * t)
                for f in rs.uniform(100, 3000, 3).astype(np.float32))
        out.append((w + np.float32(0.05) * rs.randn(samples).astype(np.float32)))
    return out


def _texts(n: int, seed: int, lo: int = 40, hi: int = 120) -> list:
    """`n` texts of lo-hi characters from a small vocabulary of words."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        target, words = int(rs.randint(lo, hi + 1)), []
        while len(" ".join(words)) < target:
            words.append(_WORDS[rs.randint(len(_WORDS))])
        out.append(" ".join(words)[:target])
    return out


def _assert_checked(tally, k1: dict, path: str) -> None:
    """Every K1 launch of a path ran at a shape, dtype and masking that
    phase 3 held against the plain version and timed."""
    for key, count in tally.items():
        if key[0] != "k1":
            continue
        _, shape, dtype, masked = key
        found = [n for n, r in k1.items() if tuple(r["shape"]) == shape and r["dtype"] == dtype
                 and r["masked"] == masked and "ms" in r]
        assert found, (f"{path} ran K1 {count} times at {shape} {dtype} masked={masked}, "
                       "which no check timed")


def _small_mel_voco():
    return MelVoco(vocos=Vocos(**SMALL_MEL_VOCOS), **SMALL_MEL)


def _small_wave_trainer(device, waves):
    def build():
        kw = {**SMALL, "condition_on_text": False, "num_cond_tokens": None}
        vb = vbt.VoiceBox(audio_enc_dec=_small_mel_voco(), **kw)
        _soften_qk_gains(vb)
        return vbt.ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2, device=device)

    cfm = seeded(build, SEED + 54)
    return vbt.VoiceBoxTrainer(cfm, batch_size=2, dataset=vbt.ArrayDataset(waves),
                               num_train_steps=3, valid_frac=0.0, log_every=1000, device=device,
                               **SMALL_TRAIN)


def _small_dp_trainer(device, items):
    def build():
        dp = vbt.DurationPredictor(audio_enc_dec=_small_mel_voco(), tokenizer=GraphemeTokenizer(),
                                   **SMALL_DP)
        _soften_qk_gains(dp.net)
        return dp

    dp = seeded(build, SEED + 55)
    return vbt.DurationPredictorTrainer(
        dp, batch_size=2, dataset=PairedDataset(items), num_train_steps=3, valid_frac=0.0,
        phoneme_bucket_multiple=16, frame_bucket_multiple=16, log_every=1000,
        save_results_every=1000, device=device,
        **{k: SMALL_TRAIN[k] for k in ("lr", "initial_lr", "num_warmup_steps", "max_grad_norm")})


def phase_raw_card_vs_cpu() -> None:
    """Small fp32 configurations of the raw-audio path and of duration
    training on the card and on the CPU, from the same weights, waves and
    draws."""
    waves = _waves(4, 6000, SEED + 51)
    w = torch.from_numpy(np.stack(waves[:2]))
    mel_kw = dict(n_mels=32, n_fft=256, win_length=160, hop_length=64)
    mel_c, mel_g = mel_spectrogram(w, **mel_kw), mel_spectrogram(w.cuda(), **mel_kw).cpu()
    mel_ratio = ((mel_g - mel_c).abs() / (1e-3 * mel_c.abs() + 1e-6 * mel_c.max())).max().item()
    db_err = (amplitude_to_db(mel_g) - amplitude_to_db(mel_c)).abs().max().item()

    def small_encodec():
        return EncodecModel(dim=32, n_filters=8, ratios=(4, 4, 2, 2), num_quantizers=2,
                            codebook_size=64)

    enc_c, enc_g = seeded(small_encodec, SEED + 52), seeded(small_encodec, SEED + 52).cuda()
    lat_c, lat_g = enc_c.encode(w), enc_g.encode(w.cuda()).cpu()
    lat_err = (lat_g - lat_c).abs().max().item() / max(1.0, lat_c.abs().max().item())
    with torch.no_grad():
        aud_c, aud_g = enc_c.decoder(lat_c), enc_g.decoder(lat_c.cuda()).cpu()
    aud_err = (aud_g - aud_c).abs().max().item() / max(1.0, aud_c.abs().max().item())
    lstm_c, lstm_g = seeded(lambda: _LSTM(64), SEED + 53), seeded(lambda: _LSTM(64),
                                                                  SEED + 53).cuda()
    x = torch.randn(2, 64, 300, generator=torch.Generator().manual_seed(SEED + 53))
    with torch.no_grad():
        lstm_err = (lstm_g(x.cuda()).cpu() - lstm_c(x)).abs().max().item()
    log("raw", f"card vs CPU, fp32: mel power max |card - CPU| / (1e-3 |CPU| + 1e-6 peak) "
               f"{mel_ratio:.3f} (tol 1), dB max_abs_err {db_err:.3e} (tol 1e-2); SEANet "
               f"(n_filters 8, dim 32, hop 64) latents max_abs_err / max(1, peak) {lat_err:.3e} "
               f"(tol 1e-4), decoder audio {aud_err:.3e} (tol 1e-4); LSTM (2 x 64, 300 steps) "
               f"max_abs_err {lstm_err:.3e} (tol 1e-5)")
    assert mel_ratio <= 1 and db_err <= 1e-2, "mel disagrees card vs CPU"
    assert lat_err <= 1e-4 and aud_err <= 1e-4 and lstm_err <= 1e-5, (
        "SEANet disagrees card vs CPU")

    # MAS, exactly, on one input: a soft alignment at temperature 5e-4 where
    # most cells underflow to 0 (ties everywhere)
    gen = torch.Generator().manual_seed(SEED + 56)
    q, k = torch.randn(3, 400, 8, generator=gen) * 300, torch.randn(3, 60, 8, generator=gen) * 300
    value = torch.softmax(-5e-4 * torch.cdist(q, k).square(), dim=-1).transpose(1, 2)
    x_len, y_len = torch.tensor([60, 41, 7]), torch.tensor([400, 277, 31])
    mask = ((torch.arange(60)[None, :, None] < x_len[:, None, None])
            & (torch.arange(400)[None, None, :] < y_len[:, None, None]))
    path_c = maximum_path(value, mask)
    path_g = maximum_path(value.cuda(), mask.cuda()).cpu()
    zeros = (value == 0).float().mean().item()
    log("raw", f"MAS card vs CPU on one (3, 60, 400) soft alignment ({zeros:.1%} of cells "
               f"exactly 0): paths equal {torch.equal(path_c, path_g)}, durations "
               f"{path_c.sum(-1)[:, :8].tolist()}...")
    assert torch.equal(path_c, path_g), "MAS disagrees card vs CPU"

    # 3 steps of the VoiceBox trainer on raw waves through a small MelVoco:
    # 5800-6000 samples pad to 7872 (the sample grid) = 124 frames + 4
    # registers
    wave_items = _waves(4, 6000, SEED + 57)
    wave_items = [wv[: 5800 + 50 * i] for i, wv in enumerate(wave_items)]
    cpu, gpu = _small_wave_trainer("cpu", wave_items), _small_wave_trainer("cuda", wave_items)
    _compare_small_runs(cpu, gpu, np.random.RandomState(SEED + 58), k1_per_step=SMALL["depth"],
                        label="AdamW (raw waves, MelVoco)")

    # 3 steps of the duration trainer: (text, wave) items, the span mask
    # drawn here, the same on both
    items = list(zip(_texts(4, SEED + 59, 20, 30), _waves(4, 6000, SEED + 60)))
    cpu, gpu = _small_dp_trainer("cpu", items), _small_dp_trainer("cuda", items)
    init = {n: p.detach().clone() for n, p in cpu.module.named_parameters()}
    rs = np.random.RandomState(SEED + 61)
    depth, frames = SMALL_DP["depth"], 6144 // 64 + 1
    losses = []
    for step in range(3):
        span = torch.from_numpy(rs.rand(2, frames) < 0.6)
        cpu_loss = cpu.train_step(cond_mask=span)["loss"].item()
        reset_launches()
        gpu_loss = gpu.train_step(cond_mask=span.cuda())["loss"].item()
        torch.cuda.synchronize()
        want = {"k1": depth * (2 if step == 0 else 1), "k2": depth, "k3": depth, "k4": 0}
        assert read_launches() == want, f"step {step} launched {read_launches()}, want {want}"
        losses.append((gpu_loss, cpu_loss))
    loss_err = max(abs(g - c) / abs(c) for g, c in losses)
    lr = SMALL_TRAIN["lr"]
    worst, n_off, total, cos_min = _update_gap(init, cpu.module, gpu.module, lr)
    log("raw", f"duration trainer card vs CPU, fp32, dim 64 depth 2 heads 2x64, aligner on 32 "
               f"mels, batch 2 x {frames} frames: losses card/CPU "
               f"{[(round(g, 6), round(c, 6)) for g, c in losses]}, max relative diff "
               f"{loss_err:.2e} (tol 1e-4); fp32 K1/K2/K3 launches per step {depth}/{depth}/"
               f"{depth}; parameter updates: min per-tensor cosine {cos_min:.6f} (tol > 0.999), "
               f"max abs diff {worst:.3e} (tol 6 lr), weights off by > 0.01 lr {n_off} of "
               f"{total} (tol 1e-3 of them)")
    assert loss_err <= 1e-4, "duration losses disagree card vs CPU"
    assert cos_min > 0.999 and worst <= 6 * lr and n_off / total <= 1e-3, (
        "duration parameters disagree card vs CPU")


def phase_mel(smi: str, k1: dict) -> dict:
    """Path (a), BASELINE config 2: `VoiceBoxTrainer` on 10 s raw waves
    through MelVoco (the flagship denoiser, bf16 compute over fp32
    parameters, AdamW, clip 0.5), then one request sampled from a 10 s raw
    prompt and decoded through MelVoco."""
    def build():
        vb = vbt.VoiceBox(audio_enc_dec=MelVoco(), dtype=torch.bfloat16,
                          param_dtype=torch.float32, **MEL_FLAGSHIP)
        return vbt.ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2)

    cfm = seeded(build, SEED + 20)
    codec = cfm.codec
    waves = _waves(40, WAVE_SAMPLES, SEED + 21)
    trainer = vbt.VoiceBoxTrainer(
        cfm, batch_size=TRAIN_BATCH, dataset=vbt.ArrayDataset(waves), num_train_steps=1000,
        lr=1e-4, wd=1e-2, max_grad_norm=0.5, valid_frac=0.2, log_every=1000,
        save_results_every=1000, seed=SEED,
    )
    depth = MEL_FLAGSHIP["depth"]
    for _ in range(TRAIN_WARMUP):
        trainer.train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the path's training run starts here
    logs = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with shape_tally() as tally:
        t_all = time.perf_counter()
        start.record()
        for _ in range(MEL_TRAIN_TIMED):
            before = read_launches()
            logs.append(trainer.train_step())
            after = read_launches()
            step = {k: after[k] - before[k] for k in after}
            assert step == {"k1": depth, "k2": depth, "k3": depth, "k4": 0}, (
                f"a mel training step launched {step}, expected {depth} of each")
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_all
    train_counts = read_launches()
    gpu_ms = start.elapsed_time(end)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack([lg["loss"] for lg in logs]).tolist()
    norms = torch.stack([lg["grad_norm"] for lg in logs]).tolist()
    assert all(math.isfinite(x) for x in losses + norms), f"non-finite {losses} {norms}"
    _assert_checked(tally, k1, "mel training")
    tokens = {key[1][2] for key in tally if key[0] == "k1"}
    assert len(tokens) == 1, f"mel training ran K1 at {tokens} tokens"
    tokens = tokens.pop()
    # the codec's share of a step: one encode of a step's padded batch
    padded = (tokens - MEL_FLAGSHIP["num_register_tokens"] - 1) * MEL_HOP
    batch = F.pad(torch.from_numpy(np.stack(waves[:TRAIN_BATCH])).cuda(),
                  (0, padded - WAVE_SAMPLES))
    frames = codec.encode(batch).shape[1]
    enc_ms = cuda_ms(lambda: codec.encode(batch), iters=10)
    prof = _profile(trainer.train_step)
    idle = prof["idle"]
    log("mel", f"(a) raw-wave mel CFM training: flagship dim 512 depth 24 heads 4x128 without "
               f"text, vocos-mel-24khz MelVoco, batch {TRAIN_BATCH} x {WAVE_SAMPLES} samples "
               f"(10 s, {WAVE_SAMPLES // MEL_HOP + 1} frames; the trainer's sample bucket "
               f"pads them to {padded} samples = {frames} frames + 16 registers = {tokens} "
               f"tokens, the padding masked); {MEL_TRAIN_TIMED} timed steps: losses "
               f"{[round(x, 4) for x in losses]}, grad norms {[round(x, 3) for x in norms]}, "
               f"K1/K2/K3 per step {depth}/{depth}/{depth}")
    log("mel", f"steps/s {MEL_TRAIN_TIMED / (gpu_ms / 1e3):.3f} (CUDA events, "
               f"{gpu_ms / MEL_TRAIN_TIMED:.2f} ms/step; host clock {MEL_TRAIN_TIMED / wall:.3f}); "
               f"codec encode of a step's batch ({TRAIN_BATCH} x {padded} samples -> {frames} "
               f"frames) {enc_ms:.3f} ms (CUDA events); profiled step: wall "
               f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms over "
               f"{prof['kernels']} kernels (+ {prof['annotations']} annotation ranges left "
               f"out), idle share "
               f"{'not measured' if idle is None else f'{idle:.3f}'}; peak memory "
               f"{peak_gib:.2f} GiB on {smi}")
    log("mel", f"profiled step's largest kernels (name, ms, calls): "
               f"{'; '.join(f'{n} {t:.3f} {c}' for n, t, c in prof['top'])}")

    cfm.eval()
    prompt = torch.from_numpy(waves[-1][None]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    want_k1 = depth * EVALS_PER_REQUEST

    def request():
        return cfm.sample(cond=prompt, steps=STEPS, cond_scale=CFG_SCALE, generator=gen,
                          return_lengths=True)

    request()  # warm-up
    reset_launches()  # the path's sampling run starts here
    with shape_tally() as stally:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio, lengths = request()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    serve_counts = read_launches()
    want = (1, MEL_FRAMES * MEL_HOP)
    assert tuple(audio.shape) == want, f"audio {tuple(audio.shape)} != {want}"
    assert bool(torch.isfinite(audio).all()), "non-finite audio"
    assert lengths.tolist() == [want[1]]
    assert serve_counts == {"k1": want_k1, "k2": 0, "k3": 0, "k4": 0}, (
        f"a mel request launched {serve_counts}, expected {want_k1} K1")
    _assert_checked(stally, k1, "mel sampling")
    log("mel", f"(a) request from a 10 s raw prompt (-> {MEL_FRAMES} frames), {STEPS} midpoint "
               f"steps, CFG {CFG_SCALE}, MelVoco decode: audio {want} finite, latency "
               f"{dt * 1e3:.2f} ms (host clock), RTF {dt / (WAVE_SAMPLES / 24000):.5f}, K1 "
               f"launches {serve_counts['k1']} on {smi}")
    del trainer, cfm
    torch.cuda.empty_cache()
    return {"train": train_counts, "serve_k1": serve_counts["k1"]}


def phase_duration(smi: str, k1: dict) -> dict:
    """Path (b), BASELINE config 4: `DurationPredictorTrainer` trains the
    reference DurationPredictor (dim 512, depth 10, 8 x 64 heads, fp32) on
    (text, 10 s wave) items through MelVoco, its aligner on the 100 mels;
    then the trained predictor drives one `sample(texts=...)` through a
    MelVoco denoiser of the flagship geometry conditioned on phoneme ids."""
    tok = GraphemeTokenizer()

    def build():
        return vbt.DurationPredictor(audio_enc_dec=MelVoco(), tokenizer=tok, aligner_dim_in=100,
                                     aligner_attn_channels=80)

    dp = seeded(build, SEED + 30)
    items = list(zip(_texts(40, SEED + 31), _waves(40, WAVE_SAMPLES, SEED + 32)))
    trainer = vbt.DurationPredictorTrainer(
        dp, batch_size=DP_TRAIN_BATCH, dataset=PairedDataset(items), num_train_steps=1000,
        lr=1e-4, valid_frac=0.2, phoneme_bucket_multiple=DP_PHONEME_BUCKET, log_every=1000,
        save_results_every=1000, seed=SEED,
    )
    depth = DP_DEPTH
    for _ in range(TRAIN_WARMUP):
        trainer.train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the path's training run starts here
    logs = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with shape_tally() as tally:
        t_all = time.perf_counter()
        start.record()
        for _ in range(DP_TRAIN_TIMED):
            before = read_launches()
            logs.append(trainer.train_step())
            after = read_launches()
            step = {k: after[k] - before[k] for k in after}
            assert step == {"k1": depth, "k2": depth, "k3": depth, "k4": 0}, (
                f"a duration training step launched {step}, expected {depth} of each")
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_all
    train_counts = read_launches()
    gpu_ms = start.elapsed_time(end)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack([lg["loss"] for lg in logs]).tolist()
    norms = torch.stack([lg["grad_norm"] for lg in logs]).tolist()
    assert all(math.isfinite(x) for x in losses + norms), f"non-finite {losses} {norms}"
    _assert_checked(tally, k1, "duration training")
    prof = _profile(trainer.train_step)
    idle = prof["idle"]

    # the step's parts, each alone on one training batch, each profiled once
    # after a warm-up call: the host's wall time, the device's busy time and
    # the kernels it launched (the parts are host-bound: their CUDA-event
    # times would be the host's enqueue)
    b = trainer._prepare_batch(next(trainer.dl_iter))
    ids, cond, mel = b["phoneme_ids"], b["cond"], b["mel"]

    def transformer():
        dp.net(cond=cond, phoneme_ids=ids).sum().backward()

    keys = dp.net.to_phoneme_emb(ids.clamp_min(0)).detach().requires_grad_(True)

    def aligner():
        dp.aligner(mel.transpose(1, 2), keys, b["phoneme_mask"])[1].sum().backward()

    with torch.no_grad():
        soft, logprob = dp.aligner(mel.transpose(1, 2), keys, b["phoneme_mask"])
    value = soft[:, 0].transpose(1, 2)
    attn_mask = b["phoneme_mask"][:, :, None] & b["mel_mask"][:, None, :]
    lp = logprob.detach().requires_grad_(True)

    def fsum():
        forward_sum_loss(lp, b["phoneme_len"], b["mel_len"]).backward()

    parts = {}
    for name, fn in (("transformer", transformer), ("aligner", aligner),
                     ("MAS", lambda: maximum_path(value, attn_mask)), ("forward_sum", fsum)):
        fn()
        parts[name] = _profile(fn)
    n_frames = mel.shape[1]
    log("dp", f"(b) duration training: reference DurationPredictor dim 512 depth 10 heads 8x64 "
              f"fp32, MelVoco, aligner 100 mels -> 80 channels, batch {DP_TRAIN_BATCH}: "
              f"phonemes padded to {ids.shape[1]}, waves to {n_frames} frames; "
              f"{DP_TRAIN_TIMED} timed steps: losses {[round(x, 4) for x in losses]}, grad "
              f"norms {[round(x, 3) for x in norms]}, fp32 K1/K2/K3 per step "
              f"{depth}/{depth}/{depth}")
    log("dp", f"ms per step {gpu_ms / DP_TRAIN_TIMED:.2f} (CUDA events; steps/s "
              f"{DP_TRAIN_TIMED / (gpu_ms / 1e3):.3f}, host clock {DP_TRAIN_TIMED / wall:.3f}); "
              f"parts alone (forward + backward; MAS over {n_frames} frames), wall / device "
              f"busy ms / kernels (+ annotation ranges left out): " + "; ".join(
                  f"{name} {r['wall_ms']:.2f} / {r['busy_ms']:.3f} / {r['kernels']} (+ "
                  f"{r['annotations']})"
                  for name, r in parts.items()) + "; profiled step: wall "
              f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms over "
              f"{prof['kernels']} kernels (+ {prof['annotations']} annotation ranges left "
              f"out), K1+K2+K3 {prof['attention_ms']:.3f} ms of it "
              f"({prof['attention_ms'] / max(prof['busy_ms'], 1e-9):.1%}), idle share "
              f"{'not measured' if idle is None else f'{idle:.3f}'}; peak memory "
              f"{peak_gib:.2f} GiB on {smi}")
    log("dp", f"profiled step's largest kernels (name, ms, calls): "
              f"{'; '.join(f'{n} {t:.3f} {c}' for n, t, c in prof['top'])}")
    del trainer, b, keys, lp, soft, logprob, value

    def build_cfm():
        vb = vbt.VoiceBox(audio_enc_dec=dp.audio_enc_dec, dtype=torch.bfloat16,
                          **{**FLAGSHIP, "num_cond_tokens": tok.vocab_size})
        return vbt.ConditionalFlowMatcherWrapper(vb, duration_predictor=dp)

    cfm = seeded(build_cfm, SEED + 33).eval()
    dp.eval()
    assert len(DP_SAMPLE_TEXT) == 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 34)

    def request():
        return cfm.sample(texts=[DP_SAMPLE_TEXT], steps=STEPS, cond_scale=CFG_SCALE,
                          frame_length=MEL_FRAMES, generator=gen, return_lengths=True)

    request()  # warm-up
    reset_launches()
    with shape_tally() as stally:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio, lengths = request()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    sample_counts = read_launches()
    den_want = FLAGSHIP["depth"] * EVALS_PER_REQUEST
    want_k1 = den_want + depth
    assert sample_counts == {"k1": want_k1, "k2": 0, "k3": 0, "k4": 0}, (
        f"a duration-mode request launched {sample_counts}, expected {want_k1} K1")
    # the request's K1 calls by dtype: the fp32 predictor's and the bf16
    # denoiser's (on the card each call is one launch; together they are the
    # counted launches)
    by_dtype = collections.Counter()
    for key, count in stally.items():
        if key[0] == "k1":
            by_dtype[key[2]] += count
    dp_k1, den_k1 = by_dtype[torch.float32], by_dtype[torch.bfloat16]
    assert (dp_k1, den_k1) == (depth, den_want) and dp_k1 + den_k1 == sample_counts["k1"], (
        f"the request's K1 calls by dtype {dict(by_dtype)}: expected {depth} fp32 (predictor) "
        f"and {den_want} bf16 (denoiser), {sample_counts['k1']} launches in all")
    assert tuple(audio.shape) == (1, MEL_FRAMES * MEL_HOP), tuple(audio.shape)
    assert bool(torch.isfinite(audio).all()), "non-finite audio"
    _assert_checked(stally, k1, "duration-mode sampling")
    log("dp", f"(b) the trained predictor drives sample(texts=[64 characters]) through a "
              f"MelVoco denoiser of the flagship geometry (bf16, phoneme ids), frame_length "
              f"{MEL_FRAMES}: audio {tuple(audio.shape)} finite, valid samples "
              f"{lengths.tolist()}, latency {dt * 1e3:.2f} ms (host clock), K1 launches "
              f"{sample_counts['k1']} ({dp_k1} fp32 predictor + {den_k1} bf16 denoiser) on "
              f"{smi}")
    del cfm, dp
    torch.cuda.empty_cache()
    return {"train": train_counts, "sample_k1": sample_counts["k1"], "sample_k1_dp": dp_k1,
            "sample_k1_denoiser": den_k1}


# phase 15b: head dim 256. (a) the bench flagship with its 512-wide attention
# split as 2 x 256 instead of 4 x 128 (the same parameters and FLOPs); (b) the
# reference duration predictor's geometry (dim 512, depth 10, fp32) at 2 x
# 256; (c) the small fp32 denoiser of phase 7 at 2 x 256, card against CPU
WIDE = dict(heads=2, dim_head=256)
RUN_TIMED = 3  # steps after phase 10's TRAIN_WARMUP (15b, 15c and 24's runs)
WIDE_DP_TIMED, WIDE_DP_ITEMS = 2, 16
# phase 15c: head dims past 256 (the chunked kernels). (a) the flagship at
# 2 x 512 heads (attention 1024 wide: to_qkv 512 -> 3072, to_out 1024 ->
# 512), trained and served as in 15b (a); (c) phase 7's small fp32
# denoiser at 1 x 512, card against CPU, to 1e-6 of the loss and update
# cosine 0.9999
CHUNKED = dict(heads=2, dim_head=512)
CHUNKED_SMALL = dict(heads=1, dim_head=512)
CHUNKED_CARD_VS_CPU = dict(loss_tol=1e-6, cos_tol=0.9999)
# 15c (c)'s losses are held to the configuration's own rounding floor where
# it exceeds 1e-6: at 1 x 512 the qk-normed logits reach 10 d gain^2 = 320
# (160 at 2 x 256), and on the CPU alone, with only the logits' fp32 sums
# in another order, three AdamW steps' losses move by 2.0e-6 relative (2.1e-7
# at 2 x 256); the card's kernels sum in another order than the CPU's BLAS
CARD_CPU_TIMES_FLOOR = 2.0


def phase_wide_flagship(smi: str, k1: dict, k23: dict, heads: dict = WIDE,
                        seed: int = SEED + 90, tag: str = "(a)") -> dict:
    """15b (a) (and 15c (a) at `CHUNKED`): the flagship at 2 x 256 heads
    trains through `VoiceBoxTrainer` (bf16 compute over fp32 parameters and
    AdamW, batch 8 x 752 frames + 16 registers), then serves one 10 s request
    through the midpoint sampler and EncodecVoco, both built on the card
    from a seed."""
    model = {**FLAGSHIP, **heads}
    label = f"{tag} flagship at {heads['heads']} x {heads['dim_head']} heads"
    train = _train_run(smi, k1, k23, label, model, {}, seed, TRAIN_BATCH, TRAIN_FRAMES,
                       tag="wide")
    serve = _serve_run(smi, k1, label, model, seed + 2, FRAMES, tag="wide")
    return {"train": train["counts"], "train_tally": train["tally"], "serve": serve["counts"],
            "serve_tally": serve["tally"]}


def _train_run(smi: str, k1: dict, k23: dict, label: str, model_kw: dict, trainer_kw: dict,
               seed: int, batch: int, frames: int, tag: str = "p24", **extra) -> dict:
    """Build `model_kw` on the card from `seed`, train TRAIN_WARMUP +
    RUN_TIMED steps of `batch` x `frames` through `VoiceBoxTrainer` (bf16
    compute over fp32 parameters and AdamW), every step's launches asserted
    (`_k1_per_step`) and every launch's shape one that phases 3 and 4
    checked and timed; log (under `tag`) and return the run's numbers."""
    def build():
        vb = vbt.VoiceBox(dim_in=LATENT_DIM, dtype=torch.bfloat16, param_dtype=torch.float32,
                          **model_kw)
        return vbt.ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2)

    cfm = seeded_on("cuda", build, seed)
    rs = np.random.RandomState(seed + 1)
    items = [(rs.randn(frames, LATENT_DIM).astype(np.float32),
              rs.randint(0, model_kw["num_cond_tokens"], frames).astype(np.int32))
             for _ in range(2 * batch)]
    trainer = vbt.VoiceBoxTrainer(
        cfm, batch_size=batch, dataset=vbt.ArrayDataset(items), num_train_steps=1000, lr=1e-4,
        wd=1e-2, max_grad_norm=0.5, valid_frac=0.0, log_every=1000, save_results_every=1000,
        seed=SEED, **trainer_kw, **extra)
    vb = cfm.voicebox
    attn = vb.transformer.layers[0][3]
    depth, h, dh = vb.transformer.depth, attn.heads, attn.dim_head
    n_params = sum(p.numel() for p in trainer.params)
    per_step = {"k1": _k1_per_step(model_kw), "k2": depth, "k3": depth, "k4": 0}
    for _ in range(TRAIN_WARMUP):
        trainer.train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the run's launches start here
    logs, host_s = [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with shape_tally() as tally:
        t_all = time.perf_counter()
        start.record()
        for _ in range(RUN_TIMED):
            before = read_launches()
            t0 = time.perf_counter()
            logs.append(trainer.train_step())
            host_s.append(time.perf_counter() - t0)
            step = {k: v - before[k] for k, v in read_launches().items()}
            assert step == per_step, f"{label}: a step launched {step}, want {per_step}"
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_all
    counts = read_launches()
    gpu_ms = start.elapsed_time(end)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tokens = frames + vb.transformer.num_register_tokens
    want = (batch, h, tokens, tokens, dh)
    assert {key[:3] for key in tally} == {(k, want, torch.bfloat16) for k in ("k1", "k2", "k3")}, (
        f"{label} launched at {sorted(tally, key=str)}, want {want} bf16 only")
    _assert_checked(tally, k1, label)
    _assert_k23_checked(tally, k23, label)
    losses = torch.stack([lg["loss"] for lg in logs]).tolist()
    norms = torch.stack([lg["grad_norm"] for lg in logs]).tolist()
    assert all(math.isfinite(x) for x in losses + norms), f"non-finite {losses} {norms}"
    prof = _profile(trainer.train_step)
    state_gib = _state_bytes(trainer) / 2**30
    idle = "not measured" if prof["idle"] is None else f"{prof['idle']:.3f}"
    step_ms = gpu_ms / RUN_TIMED
    flagship = (f"phase 10's 4 x 128 flagship: {MEASURED.get('train_steps_s', math.nan):.3f} "
                f"steps/s, busy {MEASURED.get('train_busy_ms', math.nan):.2f} ms, peak "
                f"{MEASURED.get('train_peak_gib', math.nan):.2f} GiB")
    log(tag, f"{label}: dim {vb.to_pred.weight.shape[1]} depth {depth}, {h} x {dh} heads, "
             f"{n_params / 1e6:.1f} M fp32 parameters, bf16 compute, AdamW"
             f"{' ' + str(trainer_kw) if trainer_kw else ''}"
             f"{' remat ' + model_kw['remat_policy'] if model_kw.get('remat') else ''}; batch "
             f"{batch} x {frames} frames + {tokens - frames} registers ({tokens} tokens); "
             f"{RUN_TIMED} timed steps after {TRAIN_WARMUP}: losses "
             f"{[round(x, 4) for x in losses]}, grad norms {[round(x, 3) for x in norms]}, "
             f"K1/K2/K3 a step {per_step['k1']}/{depth}/{depth} at {want}; steps/s "
             f"{RUN_TIMED / (gpu_ms / 1e3):.3f} (CUDA events, {step_ms:.2f} ms a step), "
             f"{RUN_TIMED / wall:.3f} (host clock, steps {[round(t * 1e3, 1) for t in host_s]} "
             f"ms); one profiled step: device busy {prof['busy_ms']:.2f} ms over "
             f"{prof['kernels']} kernels (K1+K2+K3 {prof['attention_ms']:.2f} ms), wall "
             f"{prof['wall_ms']:.2f} ms, idle share {idle} (1 - busy / the timed steps' event "
             f"ms: {1 - prof['busy_ms'] / step_ms:.3f}); peak memory {peak_gib:.2f} GiB, state "
             f"between steps {state_gib:.2f} GiB; largest kernels (name, ms, calls): "
             f"{'; '.join(f'{n} {t:.3f} {c}' for n, t, c in prof['top'][:4])}; {flagship}; "
             f"on {smi}")
    del trainer, cfm, logs
    torch.cuda.empty_cache()
    return {"counts": counts, "tally": tally}


def _serve_run(smi: str, k1: dict, label: str, model_kw: dict, seed: int, frames: int,
               tag: str = "p24") -> dict:
    """One request of `frames` (3 midpoint steps, CFG 1.3, EncodecVoco) from a
    bf16 serving model built on the card from `seed`, after a warm-up
    request: exactly depth x 4 K1 launches at a checked shape, finite audio
    of the expected length; latency, RTF, a profiled request's idle share."""
    def build():
        vb = vbt.VoiceBox(audio_enc_dec=EncodecVoco(), dtype=torch.bfloat16, **model_kw)
        return vbt.ConditionalFlowMatcherWrapper(vb)

    cfm = seeded_on("cuda", build, seed).eval()
    codec, tr = cfm.codec, cfm.voicebox.transformer
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    cond = torch.randn(1, frames, codec.latent_dim, generator=gen, device="cuda")
    ids = torch.randint(0, model_kw["num_cond_tokens"], (1, frames), generator=gen,
                        device="cuda")

    def request():
        return cfm.sample(cond=cond, semantic_token_ids=ids, steps=STEPS, cond_scale=CFG_SCALE,
                          generator=gen)

    request()  # warm-up: allocator, cuFFT plans
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the request's launches start here
    with shape_tally() as tally:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio = request()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    expected = tr.depth * EVALS_PER_REQUEST
    tokens = frames + tr.num_register_tokens
    attn = tr.layers[0][3]
    want = (2, attn.heads, tokens, tokens, attn.dim_head)
    assert counts == {"k1": expected, "k2": 0, "k3": 0, "k4": 0}, counts
    assert dict(tally) == {("k1", want, torch.bfloat16, False): expected}, dict(tally)
    _assert_checked(tally, k1, label)
    assert tuple(audio.shape) == (1, 1, frames * codec.downsample_factor), tuple(audio.shape)
    assert bool(torch.isfinite(audio).all()), "non-finite audio"
    prof = _profile(request)
    idle = "not measured" if prof["idle"] is None else f"{prof['idle']:.3f}"
    audio_s = frames * codec.downsample_factor / codec.sampling_rate
    log(tag, f"{label}: a {audio_s:.1f} s request ({frames} frames in one window, midpoint "
             f"{STEPS} steps, CFG {CFG_SCALE}, EncodecVoco): latency {dt * 1e3:.2f} ms (host "
             f"clock), RTF {dt / audio_s:.5f}, {expected} K1 at {want}, audio finite "
             f"{tuple(audio.shape)}; a profiled request: device busy {prof['busy_ms']:.2f} ms "
             f"over {prof['kernels']} kernels (K1 {prof['attention_ms']:.2f} ms), idle share "
             f"{idle}; peak memory {peak_gib:.2f} GiB on {smi}")
    del cfm, audio
    torch.cuda.empty_cache()
    return {"counts": counts, "tally": tally}


def phase_wide_duration(smi: str, k1: dict, k23: dict) -> dict:
    """(b): the reference DurationPredictor's geometry (dim 512, depth 10,
    fp32, MelVoco, aligner on the 100 mels) at 2 x 256 heads trains through
    `DurationPredictorTrainer` on (text, 10 s wave) items, phonemes bucketed
    to 128."""
    tok = GraphemeTokenizer()

    def build():
        return vbt.DurationPredictor(audio_enc_dec=MelVoco(), tokenizer=tok, aligner_dim_in=100,
                                     aligner_attn_channels=80, **WIDE)

    dp = seeded_on("cuda", build, SEED + 94)
    items = list(zip(_texts(WIDE_DP_ITEMS, SEED + 95),
                     _waves(WIDE_DP_ITEMS, WAVE_SAMPLES, SEED + 96)))
    trainer = vbt.DurationPredictorTrainer(
        dp, batch_size=DP_TRAIN_BATCH, dataset=PairedDataset(items), num_train_steps=1000,
        lr=1e-4, valid_frac=0.0, phoneme_bucket_multiple=DP_PHONEME_BUCKET, log_every=1000,
        save_results_every=1000, seed=SEED,
    )
    depth = DP_DEPTH
    trainer.train_step()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the path's run starts here
    logs = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with shape_tally() as tally:
        start.record()
        for _ in range(WIDE_DP_TIMED):
            before = read_launches()
            logs.append(trainer.train_step())
            step = {k: v - before[k] for k, v in read_launches().items()}
            assert step == {"k1": depth, "k2": depth, "k3": depth, "k4": 0}, (
                f"a 2 x 256 duration step launched {step}, expected {depth} of each")
        end.record()
        torch.cuda.synchronize()
    counts = read_launches()
    gpu_ms = start.elapsed_time(end)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = (DP_TRAIN_BATCH, 2, DP_PHONEME_BUCKET, DP_PHONEME_BUCKET, 256)
    assert {key[:3] for key in tally} == {(k, want, torch.float32) for k in ("k1", "k2", "k3")}, (
        f"2 x 256 duration training launched at {sorted(tally, key=str)}, want {want} fp32")
    _assert_checked(tally, k1, "2 x 256 duration training")
    _assert_k23_checked(tally, k23, "2 x 256 duration training")
    losses = torch.stack([lg["loss"] for lg in logs]).tolist()
    norms = torch.stack([lg["grad_norm"] for lg in logs]).tolist()
    assert all(math.isfinite(x) for x in losses + norms), f"non-finite {losses} {norms}"
    prof = _profile(trainer.train_step)
    idle = prof["idle"]
    log("wide", f"(b) reference DurationPredictor at 2 x 256 heads: dim 512 depth 10 fp32, "
                f"MelVoco, batch {DP_TRAIN_BATCH}, phonemes padded to {DP_PHONEME_BUCKET}; "
                f"{WIDE_DP_TIMED} timed steps: losses {[round(x, 4) for x in losses]}, grad "
                f"norms {[round(x, 3) for x in norms]}, fp32 K1/K2/K3 per step {depth} each at "
                f"{want}; ms per step {gpu_ms / WIDE_DP_TIMED:.2f} (CUDA events); profiled "
                f"step: device busy {prof['busy_ms']:.2f} ms, K1+K2+K3 "
                f"{prof['attention_ms']:.3f} ms of it, idle share "
                f"{'not measured' if idle is None else f'{idle:.3f}'}; peak memory "
                f"{peak_gib:.2f} GiB on {smi}")
    del trainer, dp
    torch.cuda.empty_cache()
    return {"train": counts, "tally": tally}


def phase_wide_card_vs_cpu(heads: dict = WIDE, seed: int = SEED + 97, floor: bool = False,
                           lengths=(96, 90, 93, 96), frames: int = 124, batch: int = 2,
                           **tols) -> None:
    """15b (c) (and 15c (c) at `CHUNKED_SMALL`, to `CHUNKED_CARD_VS_CPU`
    with the summation-order floor; 24 (c) at other widths and lengths):
    phase 7's small fp32 denoiser at 2 x 256 heads, 3 steps on the card
    (K1/K2/K3 at d = 256) and on the CPU from the same weights and draws,
    held as phase 7 holds it. Items of `lengths` frames, batches of `batch`
    bucketed to `frames`."""
    rs = np.random.RandomState(seed)
    items = [(rs.randn(n, 32).astype(np.float32), rs.randint(0, 100, n).astype(np.int32))
             for n in lengths]
    cpu, gpu = (_small_trainer(dev, items, model=heads, batch=batch) for dev in ("cpu", "cuda"))
    floor_run = _small_trainer("cpu", items, model=heads, batch=batch) if floor else None
    _compare_small_runs(cpu, gpu, rs, k1_per_step=SMALL["depth"], heads=heads,
                        floor_run=floor_run, frames=frames, batch=batch, **tols)


def wide_rows(k1: dict, k23: dict, wide: dict) -> list:
    """K1, K2 and K3 on phase 15b's and 15c's paths, each timed at its one
    shape."""
    rows = []
    for key, d in (("flagship", 256), ("chunked", 512)):
        flagship = wide[key]
        rows += tally_rows(k1, k23, flagship["train"], flagship["train_tally"], f"train_d{d}")
        rows += tally_rows(k1, k23, flagship["serve"], flagship["serve_tally"], f"serve_d{d}",
                           kernels_=("k1",))
    dp = wide["dp"]
    rows += tally_rows(k1, k23, dp["train"], dp["tally"], "duration_train_d256")
    return rows


# phase 24: the two configurations of the JAX package's headline that no
# earlier phase ran. (a) The JAX package's default VoiceBox (every field at
# voicebox_tpu/models/voicebox.py's default: dim 1024, depth 24, 16 x 64
# heads, a 1024-wide cond embedding, 16 registers, qk-norm; 711.1 M
# parameters with 500 cond tokens and 128 latent channels), trained at phase
# 10's batch of 8 x 752 frames in three runs: (i) as it is; (ii) under the
# JAX headline's stack (remat saving "dots+attn_probs+qk_rotary+norm_out",
# bf16 Adam moments, bf16 attention scores, a no-op on K1; without the TPU's
# lane-aligned ff_mult 4.125); (iii) at benchmarks/dim1024_remat.py's 8 x
# 128 split; then one 10 s request from a seeded 16 x 64 serving model. (b)
# The 100 s long-context step (PERFORMANCE.md: seq 7504, dim 512, depth 24,
# batch 1): the flagship at batch 1 x 7504 frames + 16 registers, the
# trainer's grid at 16 frames (its default 256 would pad 7504 to 7664 frames,
# 7680 tokens), then a 100 s request (7500 frames) in one window through
# `sample`. (c) Card against CPU at depth 2 in fp32, as phase 15c (c): the
# default's 16 x 64 heads at dim 1024 on 2 x 128 frames, and the flagship's
# geometry on 1 x 4096 frames (4112 tokens, past the JAX package's
# 4096-token `attend` threshold)
DEFAULT_VB = dict(num_cond_tokens=500)
DEFAULT_RUNS = {
    "(i) 16 x 64": ({}, {}),
    "(ii) 16 x 64, headline stack": (
        dict(remat=True, remat_policy="dots+attn_probs+qk_rotary+norm_out",
             attn_scores_dtype=torch.bfloat16), dict(moment_dtype=torch.bfloat16)),
    "(iii) 8 x 128": (dict(heads=8, dim_head=128), {}),
}
LONG_TRAIN_FRAMES = 7504  # 100 s of the JAX headline's long-context step
LONG_BUCKET = 16  # the trainer's grid: 7504 = 469 x 16 stays as it is
LONG_SERVE_FRAMES = 7500  # 100 s at 24 kHz, hop 320
P24_SMALL_DEFAULT = dict(dim=1024, dim_cond_emb=1024, heads=16, dim_head=64,
                         num_register_tokens=16)
P24_SMALL_LONG = dict(dim=512, dim_cond_emb=512, heads=4, dim_head=128, num_register_tokens=16)
P24_CARD_VS_CPU = dict(loss_tol=1e-6, cos_tol=0.9999)


def phase_default_long(smi: str, k1: dict, k23: dict) -> dict:
    """24 (a) and (b): the default VoiceBox's three training runs and its 10 s
    request, then the 100 s long-context step and a 100 s request."""
    runs = {}
    for i, (label, (model_kw, trainer_kw)) in enumerate(DEFAULT_RUNS.items()):
        runs[label] = _train_run(smi, k1, k23, f"(a) default VoiceBox {label}",
                                 {**DEFAULT_VB, **model_kw}, trainer_kw, SEED + 110 + 2 * i,
                                 TRAIN_BATCH, TRAIN_FRAMES)
    runs["serve_default"] = _serve_run(smi, k1, "(a) default VoiceBox 16 x 64", DEFAULT_VB,
                                       SEED + 117, FRAMES)
    runs["train_long"] = _train_run(smi, k1, k23, "(b) 100 s long-context step", FLAGSHIP, {},
                                    SEED + 118, 1, LONG_TRAIN_FRAMES, bucket_multiple=LONG_BUCKET)
    runs["serve_long"] = _serve_run(smi, k1, "(b) flagship", FLAGSHIP, SEED + 120,
                                    LONG_SERVE_FRAMES)
    return runs


def phase_default_long_card_vs_cpu() -> None:
    """24 (c): the default's 16 x 64 heads at dim 1024 on 2 x 128 frames,
    then the flagship's geometry on 1 x 4096 frames (4112 tokens), each at
    depth 2 in fp32, 3 steps card against CPU as phase 15c (c) holds them."""
    for heads, seed, lengths, frames, batch in (
            (P24_SMALL_DEFAULT, SEED + 121, (128, 120, 125, 128), 128, 2),
            (P24_SMALL_LONG, SEED + 122, (4096, 4096), 4096, 1)):
        phase_wide_card_vs_cpu(heads, seed, floor=True, lengths=lengths, frames=frames,
                               batch=batch, **P24_CARD_VS_CPU)


def p24_rows(k1: dict, k23: dict, runs: dict) -> list:
    """K1, K2 and K3 on phase 24's paths, each at its one shape."""
    rows = []
    for label, path in (("(i) 16 x 64", "train_default"),
                        ("(ii) 16 x 64, headline stack", "train_default_headline"),
                        ("(iii) 8 x 128", "train_default_8x128"),
                        ("train_long", "train_long_100s")):
        run = runs[label]
        rows += tally_rows(k1, k23, run["counts"], run["tally"], path)
    for label, path in (("serve_default", "serve_default"), ("serve_long", "serve_long_100s")):
        rows += tally_rows(k1, k23, runs[label]["counts"], runs[label]["tally"], path,
                           kernels_=("k1",))
    return rows


def phase_encodec(smi: str) -> None:
    """Path (c): `EncodecVoco.encode` of a 10 s wave through the SEANet
    encoder at the Encodec 24 kHz geometry (n_filters 32, ratios 8/5/4/2, a
    two-layer 512-wide LSTM over 750 steps) -> (1, 750, 128), then its
    decode through RVQ and Vocos, and the SEANet decoder's."""
    codec = seeded(EncodecVoco, SEED + 40).cuda().eval()
    model = seeded(EncodecModel, SEED + 41).cuda().eval()
    wave = torch.from_numpy(_waves(1, WAVE_SAMPLES, SEED + 42)[0][None]).cuda()
    lat = codec.encode(wave)
    assert tuple(lat.shape) == (1, 750, 128) and bool(torch.isfinite(lat).all()), lat.shape
    audio = codec.decode(lat)
    assert tuple(audio.shape) == (1, 1, WAVE_SAMPLES) and bool(torch.isfinite(audio).all())
    seanet = model.decode_latents(model.encode(wave))
    assert tuple(seanet.shape) == (1, WAVE_SAMPLES) and bool(torch.isfinite(seanet).all())
    t = in_turns({"encode": lambda: codec.encode(wave), "decode": lambda: codec.decode(lat),
                  "seanet_decode": lambda: model.decode_latents(lat)}, iters=5)
    log("encodec", f"(c) EncodecVoco round trip of a 10 s wave: encode -> {tuple(lat.shape)} "
                   f"{t['encode']:.3f} ms (SEANet, LSTM 2 x 512 over 750 steps), decode (RVQ, "
                   f"Vocos, iSTFT) -> {tuple(audio.shape)} {t['decode']:.3f} ms, SEANet decoder "
                   f"(RVQ, LSTM, transposed convs) -> {tuple(seanet.shape)} "
                   f"{t['seanet_decode']:.3f} ms (CUDA events, in turns), all finite, on {smi}")
    del codec, model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phases 17-18
# the semantic stack: HuBERT + k-means, the TextToSemantic seq2seq, its
# decode routes, semantic-mode sampling and serving, its trainer

SMALL_HUBERT = dict(num_clusters=100, conv_dim=64, dim=128, depth=2, heads=2, ff_dim=256,
                    conv_pos_kernel=16, conv_pos_groups=4)
SMALL_T2S = dict(dim=128, num_semantic_token_ids=100, source_depth=2, target_depth=2, heads=2,
                 dim_head=64)
NEAR_TIE = 1e-3  # a top-2 logit gap under this is a tie that rounding may break


def _small_t2s(device, wav2vec=None):
    t2s = vbt.TextToSemantic(**SMALL_T2S, wav2vec=wav2vec, tokenizer=GraphemeTokenizer(),
                             device=device)
    with torch.no_grad():  # eos at 2x: rows end at different lengths
        t2s.net.to_logits.weight[t2s.eos_id] *= 2.0
    return t2s.eval()


def _first_ties(net, text, tokens) -> list:
    """Per row, the first position of `tokens` (a greedy decode of `net`)
    where the top-2 gap of the teacher-forced logits is under NEAR_TIE."""
    with torch.no_grad():
        logits = net(text, tokens).float()[:, : tokens.shape[1]]
    logits[..., net.bos_id] = -1e9
    top2 = logits.topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) < NEAR_TIE
    n = tokens.shape[1]
    return [int(row.nonzero()[0]) if row.any() else n for row in tie.cpu()]


def _equal_before(a, b, ties) -> bool:
    return all(torch.equal(a[r, :t].cpu(), b[r, :t].cpu()) for r, t in enumerate(ties))


def phase_semantic_card_vs_cpu() -> None:
    """Phase 17: the small semantic stack from the same weights on the card
    and the CPU (fp32, TF32 off): HuBERT features and ids, teacher-forced
    logits, greedy / speculative / w8a16 decode, `sample(texts=)` and three
    TextToSemanticTrainer steps."""
    t0 = time.perf_counter()
    hub = {d: seeded(lambda: vbt.HubertWithKmeans(**SMALL_HUBERT), SEED + 60).to(d).eval()
           for d in ("cpu", "cuda")}
    wav = torch.from_numpy(np.stack(_waves(2, 16000, SEED + 61)))
    f_cpu, f_gpu = hub["cpu"].features(wav), hub["cuda"].features(wav.cuda()).cpu()
    feat_err = (f_gpu - f_cpu).abs().max().item()
    ids_cpu, ids_gpu = hub["cpu"](wav), hub["cuda"](wav.cuda()).cpu()
    c = hub["cpu"].cluster_centers.double()
    d = ((f_cpu.double()[..., None, :] - c) ** 2).sum(-1).sort(dim=-1).values
    tie = (d[..., 1] - d[..., 0]) < NEAR_TIE * d[..., 1]
    assert feat_err <= 1e-3 and bool(((ids_cpu == ids_gpu) | tie).all()), (
        f"HuBERT disagrees card vs CPU: features {feat_err:.3e}")
    log("semantic", f"card vs CPU HuBERT (conv 64, dim 128, 2 blocks, 100 clusters), 2 x 1 s: "
                    f"features max_abs_err {feat_err:.3e} (tol 1e-3), ids equal "
                    f"{(ids_cpu == ids_gpu).float().mean().item():.4f} ({int(tie.sum())} "
                    f"near-tie frames excused)")

    t2s = {d: seeded(lambda d=d: _small_t2s(d), SEED + 62) for d in ("cpu", "cuda")}
    texts = ["hello from the semantic stack", "a second, longer line of text to read"]
    text = torch.from_numpy(GraphemeTokenizer().texts_to_tensor_ids(texts)).long()
    sem = torch.randint(0, 100, (2, 40), generator=torch.Generator().manual_seed(SEED + 63))
    with torch.no_grad():
        lg_cpu = t2s["cpu"].net(text, sem)
        reset_launches()
        lg_gpu = t2s["cuda"].net(text.cuda(), sem.cuda()).cpu()
    k1_fwd = read_launches()["k1"]
    logit_err = (lg_gpu - lg_cpu).abs().max().item()
    assert logit_err <= 1e-3 and k1_fwd == SMALL_T2S["source_depth"], (logit_err, k1_fwd)
    max_len = 96
    ref = t2s["cpu"].generate(text, max_length=max_len, return_target_mask=True)
    ties = _first_ties(t2s["cpu"].net, text, ref[0])
    qnet = t2s["cpu"]._serving_net("w8a16", None)
    ref_q = t2s["cpu"].generate(text, max_length=max_len, return_target_mask=True,
                                quantize="w8a16")
    ties_q = _first_ties(qnet, text, ref_q[0])
    routes = {"greedy": ({}, ref, ties), "spec": ({"spec_decode": True}, ref, ties),
              "w8a16": ({"quantize": "w8a16"}, ref_q, ties_q),
              "w8a16_spec": ({"quantize": "w8a16", "spec_decode": True}, ref_q, ties_q)}
    for name, (kw, (r_tok, r_mask), tie_at) in routes.items():
        reset_launches()
        tok, mask = t2s["cuda"].generate(text.cuda(), max_length=max_len,
                                         return_target_mask=True, **kw)
        launched = read_launches()
        ok = _equal_before(tok, r_tok, tie_at) and _equal_before(mask, r_mask, tie_at)
        log("semantic", f"card vs CPU decode {name}: tokens and mask equal before the first "
                        f"near tie (top-2 gap < {NEAR_TIE:g}) at positions {tie_at} of "
                        f"{max_len}: {ok}; fully equal {torch.equal(tok.cpu(), r_tok)}; "
                        f"lengths card {mask.sum(1).tolist()} CPU {r_mask.sum(1).tolist()}; "
                        f"K1/K4 launches {launched['k1']}/{launched['k4']}; decode stats "
                        f"{t2s['cuda'].decode_stats}")
        assert ok, f"the {name} decode disagrees card vs CPU before a near tie"
        assert launched["k1"] == SMALL_T2S["source_depth"], launched
        assert (launched["k4"] > 0) == ("quantize" in kw), launched

    # sample(texts=): the seq2seq in front of a small fp32 denoiser
    def build_cfm(device):
        vb = vbt.VoiceBox(dim_in=32, **{**SMALL, "num_cond_tokens": 100})
        _soften_qk_gains(vb)
        return vbt.ConditionalFlowMatcherWrapper(vb, text_to_semantic=t2s[device],
                                                 device=device).eval()

    cfms = {d: seeded(lambda d=d: build_cfm(d), SEED + 64) for d in ("cpu", "cuda")}
    y0 = torch.randn(2, max_len, 32, generator=torch.Generator().manual_seed(SEED + 65))
    kw = dict(texts=texts, max_semantic_token_ids=max_len, steps=STEPS, cond_scale=CFG_SCALE,
              decode_to_audio=False, return_lengths=True)
    lat_cpu, len_cpu = cfms["cpu"].sample(noise=y0, **kw)
    lat_gpu, len_gpu = cfms["cuda"].sample(noise=y0.cuda(), **kw)
    same_ids = torch.equal(t2s["cuda"].generate(text.cuda(), max_length=max_len).cpu(), ref[0])
    lat_err = (lat_gpu.cpu() - lat_cpu).abs().max().item()
    log("semantic", f"card vs CPU sample(texts=) through a dim-128 depth-2 denoiser, "
                    f"{max_len} ids: ids equal {same_ids}, lengths card {len_gpu.tolist()} "
                    f"CPU {len_cpu.tolist()}, latents max_abs_err {lat_err:.3e} (tol 1e-3)")
    if same_ids:
        assert len_gpu.tolist() == len_cpu.tolist() and lat_err <= 1e-3, "sample(texts=)"

    # three TextToSemanticTrainer steps on the same (text, ids) batches
    rs = np.random.RandomState(SEED + 66)
    items = [(t, rs.randint(0, 100, rs.randint(20, 60))) for t in _texts(8, SEED + 67)]

    def trainer(device):
        model = seeded(lambda: _small_t2s(device), SEED + 68).train()
        return vbt.TextToSemanticTrainer(
            model, batch_size=2, dataset=PairedDataset(items), num_train_steps=3,
            valid_frac=0.0, log_every=1000, prefetch_batches=0, device=device, **SMALL_TRAIN)

    cpu, gpu = trainer("cpu"), trainer("cuda")
    init = {n: p.detach().clone() for n, p in cpu.t2s.named_parameters()}
    losses, depth = [], SMALL_T2S["source_depth"]
    for step in range(3):
        c_loss = cpu.train_step()["loss"].item()
        reset_launches()
        g_loss = gpu.train_step()["loss"].item()
        want = {"k1": depth * (2 if step == 0 else 1), "k2": depth, "k3": depth, "k4": 0}
        assert read_launches() == want, f"step {step} launched {read_launches()}, want {want}"
        losses.append((g_loss, c_loss))
    loss_err = max(abs(g - c) / abs(c) for g, c in losses)
    lr = SMALL_TRAIN["lr"]
    worst, n_off, total, cos_min = _update_gap(init, cpu.t2s, gpu.t2s, lr)
    log("semantic", f"card vs CPU TextToSemanticTrainer, fp32, dim 128 2 + 2 layers, batch 2, 3 "
                    f"steps (lr {lr:g}, clip 0.5): losses card/CPU "
                    f"{[(round(g, 6), round(c, 6)) for g, c in losses]}, max relative diff "
                    f"{loss_err:.2e} (tol 1e-4); fp32 K1/K2/K3 per step {depth}/{depth}/{depth} "
                    f"(+ {depth} K1 of step 0's validation); updates: min per-tensor cosine "
                    f"{cos_min:.6f} (tol > 0.999), max abs diff {worst:.3e} (tol 6 lr), weights "
                    f"off by > 0.01 lr {n_off} of {total} (tol 1e-3 of them)")
    assert loss_err <= 1e-4 and cos_min > 0.999 and worst <= 6 * lr and n_off <= 1e-3 * total
    log("semantic", f"phase 17 took {time.perf_counter() - t0:.1f} s")


# phase 18: the full-width configurations
T2S_FULL = dict(dim=512, num_semantic_token_ids=500, source_depth=6, target_depth=6, heads=8,
                dim_head=64)
HUBERT_SAMPLES = 160_000  # 10 s at 16 kHz: 499 frames
SEM_ENGINE = dict(text_buckets=SEM_ENGINE_TEXT_BUCKETS, batch_buckets=SEM_BATCHES,
                  max_semantic_token_ids=SEM_IDS, spec_decode=True, steps=STEPS,
                  cond_scale=CFG_SCALE, quantize="w8a16")
# one request at batch 1, text bucket 64 (a second at batch 2 went when
# phase 15b's head-dim-256 paths needed room under the script's clock: the
# batcher's four submits still run a group of more than one)
SEM_REQUESTS = (["the semantic engine reads this line aloud"],)
# requests per group; the quantized decode's lengths (its K4 shapes are
# those of any length: every step and verify chunk)
SEM_REPEATS, SEM_TRAIN_TIMED = 1, 4
SEM_QUANT_LENGTHS = (SEM_IDS, 64)  # batch 1 plain, batch 4 speculative
SEM_K1_PER_GROUP = T2S_FULL["source_depth"] + EVALS_PER_REQUEST * FLAGSHIP["depth"]
SEM_K4_PER_GROUP = K4_PER_GROUP


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _assert_k4_checked(tally, k4: dict, path: str) -> None:
    for key, count in tally.items():
        if key[0] == "k4":
            assert key[1] in k4 and k4[key[1]].get("dtype", torch.bfloat16) == key[2], (
                f"{path} ran K4 {count} times at {key[1]} {key[2]}, which no check timed")


def phase_semantic(smi: str, k1: dict, k4: dict, k4_dec: dict) -> dict:
    """Phase 18: HuBERT-base, the TextToSemantic decode routes, semantic-mode
    TTSEngine and TextToSemanticTrainer at full width, random weights."""
    t_phase = time.perf_counter()
    tok = GraphemeTokenizer()
    hubert = seeded(lambda: vbt.HubertWithKmeans(output_layer=9), SEED + 70).cuda().eval()
    waves = torch.from_numpy(np.stack(_waves(8, HUBERT_SAMPLES, SEED + 71))).cuda()
    ids = hubert(waves)
    assert tuple(ids.shape) == (8, 499) and int(ids.max()) < 500 and int(ids.min()) >= 0
    hub_ms = in_turns({"hubert": lambda: hubert(waves)}, iters=3)["hubert"]
    log("semantic", f"HuBERT-base (conv 512, dim 768, 12 heads, ff 3072, pos conv 128/16, layer "
                    f"9 of 12, 500 clusters) on 8 x 10 s at 16 kHz -> ids {tuple(ids.shape)}: "
                    f"{hub_ms:.2f} ms (CUDA events) on {smi}")

    t2s = seeded(lambda: vbt.TextToSemantic(**T2S_FULL, wav2vec=hubert, tokenizer=tok),
                 SEED + 72).eval()

    def decode(texts, max_length=SEM_IDS, **kw):
        """One generate at the engine's text bucket, timed on the host."""
        text = torch.from_numpy(tok.texts_to_tensor_ids(texts)).long()
        bucket = next(b for b in SEM_TEXT_BUCKETS if b >= text.shape[1])
        text = F.pad(text, (0, bucket - text.shape[1]), value=-1)
        (tok_, mask), ms = _timed(lambda: t2s.generate(text, max_length=max_length,
                                                       return_target_mask=True, **kw))
        return tok_, mask, ms, dict(t2s.decode_stats), text

    one = list(ENGINE_REQUESTS[0])  # 31 characters: text bucket 32
    for kw in ({}, {"quantize": "w8a16"}):  # warm-up: allocator, the quantized copy
        decode(one, max_length=32, **kw)
    reset_launches()
    with shape_tally() as dtally:
        g_tok, g_mask, g_ms, g_st, text1 = decode(one)
        s_tok, s_mask, s_ms, s_st, _ = decode(one, spec_decode=True)
        q_tok, q_mask, q_ms, q_st, _ = decode(one, SEM_QUANT_LENGTHS[0], quantize="w8a16")
        four = list(BATCHER_TEXTS)
        qs_tok, qs_mask, qs_ms, qs_st, text4 = decode(four, SEM_QUANT_LENGTHS[1],
                                                      quantize="w8a16", spec_decode=True)
    dec_counts = read_launches()
    ties = _first_ties(t2s.net, text1.cuda(), g_tok)
    spec_ok = _equal_before(s_tok, g_tok, ties) and _equal_before(s_mask, g_mask, ties)
    assert spec_ok, "speculative greedy differs from plain greedy before a near tie"
    prof = _profile(lambda: t2s.generate(text1, max_length=32))
    per_token = prof["kernels"] / 32
    acc = s_st["accepted"] / max(1, s_st["rounds"] * s_st["gamma"])
    qs_acc = qs_st["accepted"] / max(1, qs_st["rounds"] * qs_st["gamma"])
    log("semantic", f"TextToSemantic dim 512 6 + 6 layers 8 x 64 fp32, 500 ids, vocab "
                    f"{tok.vocab_size}, batch 1 text bucket {text1.shape[1]}, max_length "
                    f"{SEM_IDS}: plain greedy "
                    f"{g_st['positions']} positions in {g_ms:.1f} ms = "
                    f"{g_ms / g_st['positions']:.3f} ms per token, {per_token:.1f} kernels per "
                    f"token (profiled over 32 steps and the prefill: device busy "
                    f"{prof['busy_ms']:.2f} of wall "
                    f"{prof['wall_ms']:.2f} ms, idle share "
                    f"{'not measured' if prof['idle'] is None else f'{prof['idle']:.3f}'}); "
                    f"speculative (gamma 5, draft 3 layers) {s_st['positions']} positions in "
                    f"{s_ms:.1f} ms = {s_ms / s_st['positions']:.3f} ms per token over "
                    f"{s_st['rounds']} rounds, acceptance {acc:.3f}; equal to plain greedy "
                    f"before the first near tie (top-2 gap < {NEAR_TIE:g}) at {ties} "
                    f"(lengths {g_mask.sum(1).tolist()}, fully equal "
                    f"{torch.equal(s_tok, g_tok)}) on {smi}")
    log("semantic", f"quantized decode w8a16 (fp32 K4 on every decoder and head matmul): batch "
                    f"1 plain {q_st['positions']} positions {q_ms:.1f} ms = "
                    f"{q_ms / q_st['positions']:.3f} ms per token (lengths "
                    f"{q_mask.sum(1).tolist()}); batch 4 text bucket {text4.shape[1]} speculative "
                    f"{qs_st['positions']} positions {qs_ms:.1f} ms = "
                    f"{qs_ms / qs_st['positions']:.3f} ms per position, acceptance "
                    f"{qs_acc:.3f} (lengths {qs_mask.sum(1).tolist()}); decode launches "
                    f"{dict(dec_counts)}; K4 by shape "
                    f"{ {k[1]: c for k, c in dtally.items() if k[0] == 'k4'} }")
    for t, m in ((g_tok, g_mask), (s_tok, s_mask), (q_tok, q_mask), (qs_tok, qs_mask)):
        assert int(t.max()) < 500 and bool((t[~m] == 0).all())
    _assert_checked(dtally, k1, "the seq2seq decode")
    _assert_k4_checked(dtally, k4_dec, "the quantized decode")
    assert dec_counts["k4"] > 0 and dec_counts["k2"] == dec_counts["k3"] == 0
    qprof = _profile(lambda: t2s.generate(text1, max_length=32, quantize="w8a16"))
    k4_tally = {key[1]: c for key, c in dtally.items() if key[0] == "k4"}
    k4_weighted = (sum(c * k4_dec[shape]["ms"] for shape, c in k4_tally.items())
                   / sum(k4_tally.values()))
    log("semantic", f"decode per token, batch 1 plain greedy, float against w8a16: "
                    f"{g_ms / g_st['positions']:.3f} against {q_ms / q_st['positions']:.3f} ms "
                    f"(host clock over {g_st['positions']} and {q_st['positions']} positions); "
                    f"kernels {per_token:.1f} against {qprof['kernels'] / 32:.1f}, device busy "
                    f"{prof['busy_ms'] / 32:.3f} against {qprof['busy_ms'] / 32:.3f} ms, fp32 K4 "
                    f"{qprof['k4_ms'] / 32:.4f} ms over {qprof['k4_kernels'] / 32:.1f} launches "
                    f"(profiled over 32 steps and the prefill, idle share "
                    f"{'not measured' if qprof['idle'] is None else f'{qprof['idle']:.3f}'}); "
                    f"fp32 K4 launch-weighted over the quantized decodes' "
                    f"{sum(k4_tally.values())} launches {k4_weighted:.4f} ms a launch (the "
                    f"decode check's times at each shape) on {smi}")

    # semantic-mode TTSEngine: the seq2seq in front of the flagship denoiser
    def build_cfm():
        vb = vbt.VoiceBox(audio_enc_dec=EncodecVoco(), dtype=torch.bfloat16,
                          **{**FLAGSHIP, "num_cond_tokens": 500})
        return vbt.ConditionalFlowMatcherWrapper(vb, text_to_semantic=t2s)

    cfm = seeded(build_cfm, SEED + 73).eval()
    engine = vbt.TTSEngine(cfm, **SEM_ENGINE,
                           prompt_seconds_buckets=LONG_ENGINE["prompt_seconds_buckets"])
    t_warm = engine.warmup()
    n_buckets = len(SEM_BATCHES) * len(SEM_ENGINE_TEXT_BUCKETS)
    log("semantic", f"semantic TTSEngine({SEM_ENGINE}) over the flagship bf16 denoiser (500 "
                    f"cond tokens, EncodecVoco): warmup of {n_buckets} buckets in "
                    f"{t_warm:.2f} s")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 74)
    sr, hop = cfm.codec.sampling_rate, cfm.codec.downsample_factor
    per_group = {"k1": SEM_K1_PER_GROUP, "k2": 0, "k3": 0, "k4": SEM_K4_PER_GROUP}
    generate, decode_ms = t2s.generate, []

    def timed_generate(*a, **kw):
        out, ms = _timed(lambda: generate(*a, **kw))
        decode_ms.append(ms)
        return out

    t2s.generate = timed_generate
    reset_launches()
    runs = []
    try:
        with shape_tally() as etally:
            for texts in SEM_REQUESTS:
                for _ in range(SEM_REPEATS):
                    before = read_launches()
                    (audio, lens), ms = _timed(lambda: engine.synthesize(
                        texts, generator=gen, return_lengths=True))
                    launched = {k: v - before[k] for k, v in read_launches().items()}
                    assert launched == per_group, f"a group launched {launched}, want {per_group}"
                    assert bool(torch.isfinite(audio).all()) and audio.shape[-1] == SEM_IDS * hop
                    runs.append((len(texts), ms, decode_ms[-1], lens.tolist()))
            with vbt.DynamicBatcher(engine, max_wait_ms=100.0, seed=SEED) as batcher:
                futures = [batcher.submit(t) for t in BATCHER_TEXTS]
                (clips, b_ms) = _timed(lambda: [f.result(timeout=600) for f in futures])
    finally:
        del t2s.generate
    eng_counts = read_launches()
    groups = len(SEM_REQUESTS) * SEM_REPEATS + batcher.stats["batches"]
    assert eng_counts == {k: v * groups for k, v in per_group.items()}, eng_counts
    assert all(bool(torch.isfinite(c).all()) for c in clips)
    _assert_checked(etally, k1, "semantic serving")
    _assert_k4_checked(etally, k4, "semantic serving")
    horizon_s = SEM_IDS * hop / sr
    for b in sorted({r[0] for r in runs}):
        part = [r for r in runs if r[0] == b]
        lat = [r[1] for r in part]
        share = float(np.median([r[2] / r[1] for r in part]))
        log("semantic", f"semantic request batch {b}: horizon {SEM_IDS} frames = "
                        f"{horizon_s:.2f} s, valid samples {part[0][3]}; latency {_min_median(lat)} (all "
                        f"{[round(x, 1) for x in lat]}), RTF of the horizon median "
                        f"{np.median(lat) / 1e3 / horizon_s:.4f}; the seq2seq decode's share "
                        f"{share:.3f}; K1/K4 launches {per_group['k1']}/{per_group['k4']} each on "
                        f"{smi}")
    log("semantic", f"DynamicBatcher: {len(BATCHER_TEXTS)} concurrent submits as "
                    f"{batcher.stats['batches']} group(s) in {b_ms:.1f} ms; path totals "
                    f"{eng_counts}; K1/K4 by shape "
                    f"{ {(k[0], k[1], str(k[2])[6:]): c for k, c in etally.items()} }")
    # long-form and cloning in semantic mode: an over-bucket text of two
    # segments, both in text bucket 128, generated as one decode at batch 2;
    # a clone from a 3 s raw prompt whose ids come through HuBERT
    long_text, wave = _text_of(220), torch.from_numpy(_waves(1, PROMPT_SAMPLES, SEED + 77)[0])
    drives, sources = [], []
    drive = engine._drive_long

    def spy_drive(cond_ids, exact, **kw):
        drives.append((exact, kw.get("skip_frames", 0)))
        return drive(cond_ids, exact, **kw)

    def spy_generate(source, **kw):
        sources.append(tuple(source.shape))
        return generate(source, **kw)

    engine._drive_long, t2s.generate = spy_drive, spy_generate
    reset_launches()
    try:
        with shape_tally() as ltally:
            (l_clip, l_ms) = _timed(lambda: engine.synthesize([long_text], generator=gen,
                                                              trim=True)[0])
            (c_clip, c_ms) = _timed(lambda: engine.clone("the voice of the prompt reads this",
                                                         wave[None], generator=gen))
    finally:
        del engine._drive_long, t2s.generate
    long_counts = read_launches()
    (l_exact, _), (c_exact, c_skip) = drives
    hop_w = engine.long_window_frames - engine.long_overlap_frames
    wins = [1 + -(-max(e - engine.long_window_frames, 0) // hop_w) for e in (l_exact, c_exact)]
    enc = T2S_FULL["source_depth"]
    assert sources == [(2, 128), (1, 64)], f"the decodes ran at {sources}"
    assert long_counts == {"k1": 2 * enc + K1_PER_WINDOW * sum(wins), "k2": 0, "k3": 0,
                           "k4": K4_PER_WINDOW * sum(wins)}, (long_counts, wins)
    assert l_clip.shape[-1] == l_exact * hop and bool(torch.isfinite(l_clip).all())
    assert c_clip.shape[-1] == (c_exact - c_skip) * hop and bool(torch.isfinite(c_clip).all())
    _assert_checked(ltally, k1, "semantic long-form")
    _assert_k4_checked(ltally, k4, "semantic long-form")
    log("semantic", f"semantic long-form: {len(long_text)} characters in 2 segments, one decode "
                    f"at batch 2 ({sources[0]}), {l_exact} exact frames ({l_exact * hop / sr:.2f}"
                    f" s) in {wins[0]} windows: {l_ms:.1f} ms; clone from a 3 s raw prompt "
                    f"({c_skip} frames, ids through HuBERT), one decode at {sources[1]}, "
                    f"{c_exact - c_skip} frames out in {wins[1]} windows: {c_ms:.1f} ms; launches "
                    f"{long_counts} (a window {K1_PER_WINDOW} K1 + {K4_PER_WINDOW} K4, a decode's "
                    f"encoder {enc} K1); K1/K4 by shape "
                    f"{ {(k[0], k[1], str(k[2])[6:]): c for k, c in ltally.items()} } on {smi}")

    # the request's denoiser half alone, profiled (a whole request's ~6e5
    # kernels take minutes of the profiler's post-processing); the decode
    # half's profile is above
    ids = torch.zeros(1, SEM_IDS, dtype=torch.long, device="cuda")
    den = _profile(lambda: cfm.sample(semantic_token_ids=ids, steps=STEPS,
                                      cond_scale=CFG_SCALE, quantize="w8a16", generator=gen))
    log("semantic", f"profiled denoiser half of a batch-1 request ({SEM_IDS} ids, w8a16, decode "
                    f"to audio): wall {den['wall_ms']:.1f} ms, device busy {den['busy_ms']:.1f} "
                    f"ms over {den['kernels']} kernels, idle share "
                    f"{'not measured' if den['idle'] is None else f'{den['idle']:.3f}'}")
    del cfm, engine
    torch.cuda.empty_cache()

    # TextToSemanticTrainer: (text, 10 s wave) items, targets through HuBERT
    t2s.train()
    items = list(zip(_texts(50, SEED + 75), _waves(50, HUBERT_SAMPLES, SEED + 76)))
    trainer = vbt.TextToSemanticTrainer(
        t2s, batch_size=8, dataset=PairedDataset(items), num_train_steps=1000, lr=3e-4,
        max_grad_norm=0.5, valid_frac=0.2, semantic_bucket_multiple=512,
        text_bucket_multiple=64, log_every=1000, save_results_every=1000, seed=SEED)
    for _ in range(TRAIN_WARMUP):
        trainer.train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    depth = T2S_FULL["source_depth"]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    logs = []
    with shape_tally() as ttally:
        start.record()
        for _ in range(SEM_TRAIN_TIMED):
            before = read_launches()
            logs.append(trainer.train_step())
            step = {k: v - before[k] for k, v in read_launches().items()}
            assert step == {"k1": depth, "k2": depth, "k3": depth, "k4": 0}, step
        end.record()
        torch.cuda.synchronize()
    train_counts = read_launches()
    step_ms = start.elapsed_time(end) / SEM_TRAIN_TIMED
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [lg["loss"].item() for lg in logs]
    assert all(math.isfinite(x) for x in losses)
    _assert_checked(ttally, k1, "seq2seq training")
    batch = trainer._prepare_batch(next(trainer.dl_iter))
    sem = batch["semantic_ids"]
    frames, live = hubert.num_frames(512 * 320), hubert.num_frames(HUBERT_SAMPLES)
    assert sem.shape[1] == frames and bool((sem[:, live:] == -1).all()), sem.shape
    assert bool((sem[:, :live] >= 0).all())
    fields = next(trainer.dl_iter)
    prep_ms = in_turns({"prep": lambda: trainer._prepare_batch(fields)}, iters=3)["prep"]
    log("semantic", f"TextToSemanticTrainer batch 8 x (text 40-120 characters, 10 s wave at 16 "
                    f"kHz, ids through HuBERT: {frames} frames, {live} live, bucket 512), "
                    f"lr 3e-4, clip "
                    f"0.5: {SEM_TRAIN_TIMED} timed steps, losses {[round(x, 4) for x in losses]},"
                    f" {step_ms:.2f} ms per step = {1e3 / step_ms:.3f} steps/s (CUDA events); "
                    f"HuBERT + batch preparation alone {prep_ms:.2f} ms = "
                    f"{prep_ms / step_ms:.3f} of a step; fp32 K1/K2/K3 per step "
                    f"{depth}/{depth}/{depth}; K1 by shape "
                    f"{ {k[1]: c for k, c in ttally.items() if k[0] == 'k1'} }; peak memory "
                    f"{peak:.2f} GiB on {smi}")
    log("semantic", f"phase 18 took {time.perf_counter() - t_phase:.1f} s")
    del trainer, t2s, hubert
    torch.cuda.empty_cache()
    return {"decode": (dec_counts, dtally), "serve": (eng_counts, etally),
            "train": (train_counts, ttally), "long": (long_counts, ltally)}


# ---------------------------------------------------------------------------
# phase 19: trained weights. The quality canaries of `voicebox_tpu_torch/
# canaries/` at the JAX scripts' budgets and seeds (the generalization split
# at tests/test_e2e_quality.py's shortened one), and the full-width seq2seq
# overfit and decoded. The gates are tests/test_e2e_quality.py's.
CANARY_BUDGET = dict(tts_steps=400, cfm_steps=2000)
DURATION_BUDGET = dict(dp_steps=400, cfm_steps=2000)
GEN_SPLIT = dict(n_train=16, n_held=4, tts_steps=600, cfm_steps=900)
CANARY_ODE_STEPS, GEN_ODE_STEPS = 16, 12
ORACLE_ANCHOR_SEED = 98  # the oracle ids' untrained anchor, as the JAX test draws it
# decodes timed per variant (the JAX script times 24): the script's time limit
SPEC_TIMED_REPS = 8


def _assert_k23_checked(tally, k23: dict, path: str) -> None:
    """Every K2 and K3 launch of a path ran at a shape, dtype and masking
    that phase 4 held against the plain backward and timed."""
    for key, count in tally.items():
        if key[0] not in ("k2", "k3"):
            continue
        _, shape, dtype, masked = key
        found = [n for n, r in k23.items() if tuple(r["shape"]) == shape and r["dtype"] == dtype
                 and r["masked"] == masked and "times" in r]
        assert found, (f"{path} ran {key[0]} {count} times at {shape} {dtype} masked={masked}, "
                       "which no check timed")


def _gate(label: str, msd: float, untrained: float, cross=None) -> str:
    """tests/test_e2e_quality.py's gates: trained < 0.5 x untrained and, with
    a cross-utterance anchor, own-utterance < cross-utterance."""
    assert math.isfinite(msd) and math.isfinite(untrained), (label, msd, untrained)
    assert msd < 0.5 * untrained, (
        f"{label}: trained msd {msd:.2f} not below 0.5 x untrained {untrained:.2f}")
    line = f"msd {msd:.2f} < 0.5 x untrained {untrained:.2f}"
    if cross is not None:
        assert msd < cross, f"{label}: own-utterance msd {msd:.2f} >= cross {cross:.2f}"
        line += f", < cross-utterance {cross:.2f}"
    return line


def _train_line(train: dict) -> str:
    return ", ".join(f"{name} {steps} steps in {sec:.2f} s ({steps / sec:.1f} steps/s, final "
                     f"loss {loss:.4f})" for name, (steps, sec, loss) in train.items())


def phase_trained(smi: str, k1: dict, k23: dict, k4_dec: dict) -> tuple:
    """Phase 19: the port trained to convergence on the card. The semantic
    and duration canaries at full budget, the generalization split, the
    semantic and duration canaries' denoisers sampled again under w8a16
    (fp32 K4: the GEMV route at one text's 123 tokens, the tiled route at
    four texts' 492), then the full-width TextToSemantic overfit and decoded
    plainly, speculatively and under w8a16. Every K1, K2, K3 and K4 launch
    is tallied by shape and must be one phases 3-5 checked and timed."""
    from voicebox_tpu_torch.canaries import e2e_generalization_canary as gen_canary
    from voicebox_tpu_torch.canaries import e2e_quality_canary as canary
    from voicebox_tpu_torch.canaries import e2e_quality_canary_duration as dur_canary
    from voicebox_tpu_torch.canaries import spec_decode_trained as spec

    def quiet(*_):
        pass

    t_phase = time.perf_counter()
    reset_launches()  # the path's run starts here
    with shape_tally() as tally:
        # the semantic canary (text -> seq2seq -> ids -> CFM)
        t0 = time.perf_counter()
        pipe, gt = canary.build_and_train(**CANARY_BUDGET, device="cuda", verbose=quiet)
        msd = canary.mel_msd(canary.sample_from_text(pipe, steps=CANARY_ODE_STEPS), gt)
        msd0 = canary.mel_msd(canary.sample_from_text(pipe, cfm=canary.untrained_cfm(pipe),
                                                      steps=CANARY_ODE_STEPS), gt)
        cross = canary.cross_utterance(gt)
        msd_q = canary.mel_msd(canary.sample_from_text(pipe, steps=CANARY_ODE_STEPS,
                                                       quantize="w8a16"), gt)
        log("trained", f"semantic canary: {_gate('semantic canary', msd, msd0, cross)}; "
                       f"{_train_line(pipe['train'])}; {time.perf_counter() - t0:.1f} s in all "
                       f"(dB L2 a frame, {CANARY_ODE_STEPS} midpoint steps) on {smi}")
        log("trained", f"semantic canary under w8a16 (fp32 K4, GEMV route at m = 123): msd "
                       f"{msd_q:.2f} beside float {msd:.2f}; "
                       f"{_gate('semantic canary w8a16', msd_q, msd0)}")
        del pipe

        # the duration canary (text -> predictor + aligner + MAS -> CFM)
        t0 = time.perf_counter()
        pipe, gt = dur_canary.build_and_train_duration(**DURATION_BUDGET, device="cuda",
                                                       verbose=quiet)
        msd = canary.mel_msd(dur_canary.sample_from_text_duration(pipe, steps=CANARY_ODE_STEPS),
                             gt)
        msd0 = canary.mel_msd(dur_canary.sample_from_text_duration(
            pipe, cfm=canary.untrained_cfm(pipe), steps=CANARY_ODE_STEPS), gt)
        cross = canary.cross_utterance(gt)
        msd_q = canary.mel_msd(dur_canary.sample_from_text_duration(
            pipe, steps=CANARY_ODE_STEPS, quantize="w8a16"), gt)
        log("trained", f"duration canary: {_gate('duration canary', msd, msd0, cross)}; "
                       f"{_train_line(pipe['train'])}; {time.perf_counter() - t0:.1f} s in all "
                       f"on {smi}")
        log("trained", f"duration canary under w8a16 (fp32 K4, tiled route at m = 492): msd "
                       f"{msd_q:.2f} beside float {msd:.2f}; "
                       f"{_gate('duration canary w8a16', msd_q, msd0)}")
        del pipe

        # the generalization split: held-out texts and oracle ids
        t0 = time.perf_counter()
        pipe, _, held, _, gt_he = gen_canary.build_and_train_gen(**GEN_SPLIT, device="cuda",
                                                                 verbose=quiet)
        msd = canary.mel_msd(gen_canary.sample_texts(pipe, held, steps=GEN_ODE_STEPS), gt_he)
        msd0 = canary.mel_msd(gen_canary.sample_texts(pipe, held, cfm=canary.untrained_cfm(pipe),
                                                      steps=GEN_ODE_STEPS), gt_he)
        oracle = canary.mel_msd(gen_canary.sample_oracle_ids(pipe, pipe["sem_held"],
                                                             steps=GEN_ODE_STEPS), gt_he)
        oracle0 = canary.mel_msd(gen_canary.sample_oracle_ids(
            pipe, pipe["sem_held"], cfm=canary.untrained_cfm(pipe, ORACLE_ANCHOR_SEED),
            steps=GEN_ODE_STEPS), gt_he)
        cross = canary.cross_utterance(gt_he)
        log("trained", f"generalization split ({GEN_SPLIT['n_train']} train / "
                       f"{GEN_SPLIT['n_held']} held out): held-out full pipeline "
                       f"{_gate('held-out pipeline', msd, msd0)}; oracle ids "
                       f"{_gate('held-out oracle ids', oracle, oracle0)}; cross-utterance "
                       f"{cross:.2f} (not gated at this split); {_train_line(pipe['train'])}; "
                       f"{time.perf_counter() - t0:.1f} s in all on {smi}")
        del pipe

        # the full-width seq2seq, overfit, then decoded
        t0 = time.perf_counter()
        t2s, text_ids, sem_ids, trained = spec.train("cuda", verbose=quiet)
        report = spec.decode_report(t2s, text_ids, sem_ids, reps=SPEC_TIMED_REPS)
        one = text_ids[:1]
        prof = _profile(lambda: t2s.generate(one, max_length=spec.MAX_LENGTH))
        positions = t2s.decode_stats["positions"]
        log("trained", f"full-width TextToSemantic (dim 512, 6 + 6, 8 x 64, fp32, 500 ids): "
                       f"loss {trained['loss']:.5f} after {trained['steps']} steps in "
                       f"{trained['seconds']:.1f} s ({trained['steps'] / trained['seconds']:.1f} "
                       f"steps/s); greedy pattern accuracy {report['pattern_accuracy']:.4f}, "
                       f"emitted {report['emitted']} of a {spec.MAX_LENGTH}-id buffer, "
                       f"speculative == greedy {report['spec_equals_greedy']}; greedy "
                       f"{report['greedy_ms']:.1f} ms ({report['greedy_ms_per_token']:.3f} ms a "
                       f"position), speculative (gamma {spec.GAMMA}) {report['spec_ms']:.1f} ms, "
                       f"speedup {report['speedup']:.3f}, acceptance "
                       f"{report['acceptance']:.3f} over {report['rounds']} rounds; "
                       f"{report['timed']} on {smi}")
        log("trained", f"trained decode profiled: {positions} positions, "
                       f"{prof['wall_ms'] / positions:.3f} ms and "
                       f"{prof['kernels'] / positions:.1f} kernels a position, busy "
                       f"{prof['busy_ms'] / positions:.4f} ms a position, idle "
                       f"{prof['idle']:.3f}; w8a16 decode: token agreement with the float "
                       f"decode {report['w8a16_agreement']:.4f}, mask equal "
                       f"{report['w8a16_mask_equal']}, pattern accuracy "
                       f"{report['w8a16_pattern_accuracy']:.4f}, emitted "
                       f"{report['w8a16_emitted']}, {report['w8a16_ms']:.1f} ms "
                       f"({report['w8a16_ms_per_token']:.3f} ms a position) beside float "
                       f"{report['greedy_ms_per_token']:.3f}; {time.perf_counter() - t0:.1f} s "
                       f"in all")
        assert report["pattern_accuracy"] >= 0.99, report
        assert report["spec_equals_greedy"], report
        assert report["emitted"] < spec.MAX_LENGTH, f"no eos before the buffer ended: {report}"
        del t2s
    counts = read_launches()
    assert min(counts.values()) > 0, f"the trained-weight path skipped a kernel: {counts}"
    _assert_checked(tally, k1, "trained weights")
    _assert_k23_checked(tally, k23, "trained weights")
    _assert_k4_checked(tally, k4_dec, "trained weights")
    log("trained", f"launches {counts}; by shape "
                   f"{ {(k[0], k[1], str(k[2])[6:]): c for k, c in tally.items()} }; phase 19 "
                   f"took {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return counts, tally


def trained_rows(k1: dict, k23: dict, k4_dec: dict, counts: dict, tally) -> list:
    """Rows of phase 19's path: fp32 K1, K2, K3 and K4 at the shapes it
    launched them at, launch-weighted (`_path_row`)."""
    rows = tally_rows(k1, k23, counts, tally, "trained")
    k4 = tally_rows(k1, k23, counts, tally, "trained_w8a16", ("k4",), k4_dec)[0]
    k4["library"] = "cuBLAS fp32 (TF32 off) on the weight dequantized ahead of time"
    return rows + [k4]


# ---------------------------------------------------------------------------
# phase 20: files and HTTP. A user's path with a folder of recordings: the
# port's native reader, BASELINE config 2's mel training and config 5's
# seq2seq trained from files, and `examples/serve_http.py` answering
# concurrent requests.
FILES_CLIPS, FILES_TURN_STEPS, FILES_SEQ2SEQ_STEPS = 8, 5, 3  # 2 turns each from files, memory
FILES_SR = 24000
HTTP_TEXTS = ("hello from the card", "a second short line", "four requests at once",
              "the last of them")  # each in text bucket 32: one batch of four
HTTP_PROMPT_SAMPLES = 48_000  # a 2 s prompt at 24 kHz
HTTP_MAX_WAIT_MS = 50.0


def _write_wav16(path, pcm: np.ndarray, sample_rate: int) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.astype("<i2").tobytes())


def _flac_writer():
    """`write_flac` of tests/flac_ref_encoder.py (numpy only), loaded by path."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "flac_ref_encoder.py")
    spec = importlib.util.spec_from_file_location("flac_ref_encoder", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.write_flac


def _pcm16(waves) -> list:
    return [np.round(np.clip(w, -1.0, 32767 / 32768) * 32768).astype(np.int16) for w in waves]


def _host_ms_per(fn, items) -> float:
    t0 = time.perf_counter()
    for it in items:
        fn(it)
    return (time.perf_counter() - t0) * 1e3 / len(items)


def _steps_timed(trainer, steps: int) -> tuple:
    """(losses, CUDA-event ms per step, host-clock ms per step) of `steps`
    training steps."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    logs = [trainer.train_step() for _ in range(steps)]
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / steps
    losses = torch.stack([lg["loss"] for lg in logs]).tolist()
    return losses, start.elapsed_time(end) / steps, host


def tally_rows(k1: dict, k23: dict, counts: dict, tally, path: str, kernels_=("k1", "k2", "k3"),
               k4_table=None) -> list:
    """One row per kernel of a path from the shapes it launched it at
    (`shape_tally`), launch-weighted (`_path_row`); each shape must be one
    that phases 3-5 checked and timed, and the launches must equal the
    path's count."""
    def part(kernel, key):
        _, shape, dtype = key[:3]
        if kernel == "k4":
            return k4_table[shape]
        if kernel == "k1":
            return next(r for r in k1.values() if tuple(r["shape"]) == shape
                        and r["dtype"] == dtype and r["masked"] == key[3] and "ms" in r)
        r = next(r for r in k23.values() if tuple(r["shape"]) == shape and r["dtype"] == dtype
                 and r["masked"] == key[3] and "times" in r)
        err = r["max_abs_err"][0] if kernel == "k2" else max(r["max_abs_err"][1:])
        return {**_k23_timed_row(r, kernel), "shape": r["shape"], "max_abs_err": err}

    rows = []
    for kernel in kernels_:
        parts = [(c, {**part(kernel, key), "dtype": key[2]})
                 for key, c in sorted(tally.items(), key=str) if key[0] == kernel]
        row = _path_row(kernel, f"{NAMES[kernel]}[{path}]", parts, path)
        assert row["launches"] == counts[kernel], (kernel, row["launches"], counts[kernel])
        rows.append(row)
    return rows


def _files_mel(smi: str, k1: dict, k23: dict, folder: str, waves_read: list) -> tuple:
    """(b): phase 14's trainer over `AudioDataset(folder)` of the FLAC clips,
    prefetch on, against the same trainer over `ArrayDataset` of the decoded
    waves, at the same seed."""
    decode_ms = []

    class TimedAudio(AudioDataset):  # times each item's decode on the thread that asks
        def __getitem__(self, idx):
            t0 = time.perf_counter()
            out = super().__getitem__(idx)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            return out

    def trainer_over(dataset):
        def build():
            vb = vbt.VoiceBox(audio_enc_dec=MelVoco(), dtype=torch.bfloat16,
                              param_dtype=torch.float32, **MEL_FLAGSHIP)
            return vbt.ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2)

        return vbt.VoiceBoxTrainer(
            seeded(build, SEED + 20), batch_size=TRAIN_BATCH, dataset=dataset,
            num_train_steps=1000, lr=1e-4, wd=1e-2, max_grad_norm=0.5, valid_frac=0.0,
            log_every=1000, save_results_every=1000, seed=SEED, prefetch_batches=2)

    depth = MEL_FLAGSHIP["depth"]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same batches give the same losses
    try:
        trainers = {
            "files": trainer_over(TimedAudio(folder, audio_extension=".flac",
                                             sample_rate=FILES_SR)),
            "memory": trainer_over(vbt.ArrayDataset(waves_read)),
        }
        # warm-up (with step 0's validation): the allocator, cuFFT's plans
        losses = {k: _steps_timed(tr, TRAIN_WARMUP)[0] for k, tr in trainers.items()}
        ms, host = {k: [] for k in trainers}, {k: [] for k in trainers}
        counts, tally = collections.Counter(), collections.Counter()
        for which in ("files", "memory", "memory", "files"):  # in turns
            reset_launches()  # the path's run (the file-backed turns): counted and tallied
            with shape_tally() as turn:
                got, step_ms, step_host = _steps_timed(trainers[which], FILES_TURN_STEPS)
            if which == "files":
                counts.update(read_launches())
                tally.update(turn)
            losses[which] += got
            ms[which].append(step_ms)
            host[which].append(step_host)
        want = {"k1": 2 * depth * FILES_TURN_STEPS, "k2": 2 * depth * FILES_TURN_STEPS,
                "k3": 2 * depth * FILES_TURN_STEPS, "k4": 0}
        assert dict(counts) == want, f"file-backed mel training launched {counts}, expected {want}"
        _assert_checked(tally, k1, "file-backed mel training")
        _assert_k23_checked(tally, k23, "file-backed mel training")
        prof = _profile(trainers["files"].train_step)
        del trainers
        torch.cuda.empty_cache()
        f_losses, m_losses = losses["files"], losses["memory"]
        f_ms, m_ms = (sum(ms[k]) / 2 for k in ("files", "memory"))
        f_host, m_host = (sum(host[k]) / 2 for k in ("files", "memory"))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(f_losses, m_losses))
    assert all(math.isfinite(x) for x in f_losses), f_losses
    assert rel <= 1e-6, f"losses from files {f_losses} vs from memory {m_losses}: rel {rel:.3e}"
    per_batch = sum(decode_ms) / len(decode_ms) * TRAIN_BATCH
    idle = prof["idle"]
    log("files", f"(b) flagship mel training (dim 512, depth 24, 4 x 128 heads, bf16 over fp32, "
                 f"vocos-mel-24khz MelVoco), batch {TRAIN_BATCH} x 10 s from AudioDataset of "
                 f"{FILES_CLIPS} FLAC clips, prefetch 2: {TRAIN_WARMUP} + {2 * FILES_TURN_STEPS} "
                 f"steps (warm-up + timed in turns with the in-memory run), losses "
                 f"{[round(x, 5) for x in f_losses]}; from ArrayDataset of the same decoded "
                 f"waves at the same seed: max relative difference {rel:.3e} (tol 1e-6)")
    log("files", f"steps/s over {2 * FILES_TURN_STEPS} timed steps each (turns files, memory, "
                 f"memory, files of {FILES_TURN_STEPS} steps) from files {1e3 / f_ms:.3f} "
                 f"({f_ms:.2f} ms a step, CUDA events; host "
                 f"clock {1e3 / f_host:.3f}), from memory {1e3 / m_ms:.3f} ({m_ms:.2f} ms; host "
                 f"{1e3 / m_host:.3f}); the prefetch thread's decode {per_batch:.2f} ms a batch "
                 f"of {TRAIN_BATCH} ({len(decode_ms)} items decoded, "
                 f"{sum(decode_ms) / len(decode_ms):.2f} ms each, host clock); profiled "
                 f"file-backed step: wall {prof['wall_ms']:.2f} ms, device busy "
                 f"{prof['busy_ms']:.2f} ms over {prof['kernels']} kernels, idle share "
                 f"{'not measured' if idle is None else f'{idle:.3f}'} on {smi}")
    return counts, tally


def _files_seq2seq(smi: str, k1: dict, k23: dict, folder: str) -> tuple:
    """(c): phase 18's TextToSemanticTrainer over `SpeechTextDataset` of 8
    WAV + transcript pairs at 16 kHz, the targets through HuBERT-base."""
    hubert = seeded(lambda: vbt.HubertWithKmeans(output_layer=9), SEED + 70).cuda().eval()
    t2s = seeded(lambda: vbt.TextToSemantic(**T2S_FULL, wav2vec=hubert,
                                            tokenizer=GraphemeTokenizer()), SEED + 72)
    trainer = vbt.TextToSemanticTrainer(
        t2s, batch_size=FILES_CLIPS,
        dataset=SpeechTextDataset(folder, audio_extension=".wav", sample_rate=16000),
        num_train_steps=1000, lr=3e-4, max_grad_norm=0.5, valid_frac=0.0,
        semantic_bucket_multiple=512, text_bucket_multiple=64, log_every=1000,
        save_results_every=1000, seed=SEED)
    depth = T2S_FULL["source_depth"]
    trainer.train_step()  # warm-up, with step 0's validation
    reset_launches()
    with shape_tally() as tally:
        losses, ms, host = _steps_timed(trainer, FILES_SEQ2SEQ_STEPS)
    counts = read_launches()
    want = {"k1": depth * FILES_SEQ2SEQ_STEPS, "k2": depth * FILES_SEQ2SEQ_STEPS,
            "k3": depth * FILES_SEQ2SEQ_STEPS, "k4": 0}
    assert counts == want, f"file-backed seq2seq training launched {counts}, expected {want}"
    assert all(math.isfinite(x) for x in losses), losses
    _assert_checked(tally, k1, "file-backed seq2seq training")
    _assert_k23_checked(tally, k23, "file-backed seq2seq training")
    log("files", f"(c) TextToSemanticTrainer (dim 512, 6 + 6 layers, 8 x 64 heads, fp32; "
                 f"HuBERT-base layer 9, 500 clusters) over SpeechTextDataset of {FILES_CLIPS} "
                 f"WAV + .txt pairs (10 s at 16 kHz), batch {FILES_CLIPS}: "
                 f"{FILES_SEQ2SEQ_STEPS} steps, losses {[round(x, 4) for x in losses]}, "
                 f"{1e3 / ms:.3f} steps/s ({ms:.2f} ms a step, CUDA events; host clock "
                 f"{1e3 / host:.3f}); K1 by shape "
                 f"{ {k[1]: c for k, c in tally.items() if k[0] == 'k1'} } on {smi}")
    del trainer, t2s, hubert
    torch.cuda.empty_cache()
    return counts, tally


def _http_call(url: str, body=None) -> tuple:
    """(status, body, ms) of one request."""
    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            code, data = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, data = e.code, e.read()
    return code, data, (time.perf_counter() - t0) * 1e3


def _wav_frames(body: bytes) -> int:
    with wave.open(io.BytesIO(body), "rb") as w:
        assert (w.getframerate(), w.getsampwidth(), w.getnchannels()) == (24000, 2, 1), (
            w.getframerate(), w.getsampwidth(), w.getnchannels())
        return w.getnframes()


def _files_http(smi: str, k1: dict) -> tuple:
    """(d): `examples/serve_http.py`'s engine, warmed, behind `make_server`
    on 127.0.0.1:0: four `/synthesize` and one `/clone` sent at once, then
    `/healthz`, a malformed body and an unknown path."""
    with shape_tally() as wtally:
        engine = serve_http.build_engine()
        warm_s = engine.warmup()
    _assert_checked(wtally, k1, "the example server's warmup")
    batcher = vbt.DynamicBatcher(engine, max_wait_ms=HTTP_MAX_WAIT_MS)
    server = serve_http.make_server(batcher, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, name="http", daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address
    rs = np.random.RandomState(SEED + 80)
    prompt = (0.2 * np.sin(2 * np.pi * 180.0 * np.arange(HTTP_PROMPT_SAMPLES) / 24000)
              + 0.02 * rs.randn(HTTP_PROMPT_SAMPLES)).astype(np.float32)
    clone = json.dumps({"text": "in the voice of the prompt",
                        "prompt_wav": base64.b64encode(serve_http.to_wav_bytes(prompt)).decode()})
    try:
        reset_launches()  # the path's run: the requests
        with shape_tally() as tally:
            with ThreadPoolExecutor(len(HTTP_TEXTS) + 1) as pool:
                futures = [pool.submit(_http_call, base + "/synthesize",
                                       json.dumps({"text": t}).encode()) for t in HTTP_TEXTS]
                futures.append(pool.submit(_http_call, base + "/clone", clone.encode()))
                answers = [f.result() for f in futures]
            torch.cuda.synchronize()
        counts = read_launches()
        for (code, body, _), what in zip(answers, [*HTTP_TEXTS, "clone"]):
            assert code == 200, f"{what}: {code} {body[:200]!r}"
            assert _wav_frames(body) > 0, what
        code, body, _ = _http_call(base + "/healthz")
        stats = json.loads(body)
        assert code == 200 and stats["requests"] == len(answers), stats
        assert stats["occupancy_sum"] > stats["batches"], f"no batch of more than 1: {stats}"
        bad = _http_call(base + "/synthesize", b"{not json")[0]
        missing = _http_call(base + "/nowhere")[0]
        assert (bad, missing) == (400, 404), (bad, missing)
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    thread.join(30)
    assert not thread.is_alive() and not batcher._thread.is_alive(), "the server did not close"
    _assert_checked(tally, k1, "the example server's requests")
    assert counts["k1"] > 0 and counts["k2"] == counts["k3"] == counts["k4"] == 0, counts
    ms = [a[2] for a in answers]
    log("files", f"(d) examples/serve_http.py on the card (TextToSemantic dim 128 2 + 2 layers 4 "
                 f"x 32 fp32, 512 ids; VoiceBox dim 256 depth 4 4 x 64 bf16; MelVoco; text "
                 f"buckets {HTTP_TEXT_BUCKETS}, batch buckets {HTTP_BATCHES}): warmup "
                 f"{warm_s:.1f} s; {len(HTTP_TEXTS)} POST /synthesize and 1 POST /clone (2 s "
                 f"prompt) at once, max_wait_ms {HTTP_MAX_WAIT_MS:g}: latencies "
                 f"{', '.join(f'{m:.1f}' for m in ms[:-1])} ms, clone {ms[-1]:.1f} ms (host "
                 f"clock, request to response); healthz {stats}; 400 and 404 as expected; K1 "
                 f"launches {counts['k1']} on {smi}")
    del engine
    torch.cuda.empty_cache()
    return counts, tally


def phase_files(smi: str, k1: dict, k23: dict) -> dict:
    """Phase 20: (a) 8 seeded 10 s clips written as 16-bit FLAC and WAV and
    read back bit for bit through the native reader, with decode times;
    (b) mel training from the FLAC folder against the same waves in
    memory; (c) seq2seq training from WAV + transcripts; (d) the example
    HTTP server. Every K1, K2 and K3 launch is tallied by shape."""
    t_phase = time.perf_counter()
    assert native.native_available() and native.flac_available(), (
        "the native WAV / FLAC reader did not build")
    write_flac = _flac_writer()
    out = {}
    with tempfile.TemporaryDirectory(prefix="phase20_") as tmp:
        flac_dir, wav_dir, pair_dir = (os.path.join(tmp, d) for d in ("flac", "wav", "pairs"))
        for d in (flac_dir, wav_dir, pair_dir):
            os.makedirs(d)
        pcm = _pcm16(_waves(FILES_CLIPS, WAVE_SAMPLES, SEED + 81))
        t0 = time.perf_counter()
        flacs, wavs = [], []
        for i, p in enumerate(pcm):
            flacs.append(os.path.join(flac_dir, f"clip{i}.flac"))
            wavs.append(os.path.join(wav_dir, f"clip{i}.wav"))
            write_flac(flacs[-1], p[None].astype(np.int64), FILES_SR, block_size=4096)
            _write_wav16(wavs[-1], p, FILES_SR)
        write_s = time.perf_counter() - t0
        want = [p.astype(np.float32) / np.float32(32768) for p in pcm]
        for reader, paths in ((native.flac_read, flacs), (native.wav_read, wavs)):
            for path, w in zip(paths, want):
                got, sr = reader(path)
                assert sr == FILES_SR and np.array_equal(got, w), f"{path} read back differently"
        batch, lengths = native.wav_read_batch(wavs, WAVE_SAMPLES)
        assert lengths.tolist() == [WAVE_SAMPLES] * FILES_CLIPS
        assert np.array_equal(batch, np.stack(want))
        flac_ms = _host_ms_per(native.flac_read, flacs)
        wav_ms = _host_ms_per(native.wav_read, wavs)
        t0 = time.perf_counter()
        native.wav_read_batch(wavs, WAVE_SAMPLES)
        batch_ms = (time.perf_counter() - t0) * 1e3 / FILES_CLIPS
        log("files", f"(a) {FILES_CLIPS} seeded 10 s mono 24 kHz clips written as 16-bit FLAC "
                     f"(tests/flac_ref_encoder.py, blocks of 4096) and WAV in {write_s:.1f} s, "
                     f"read back bit for bit by the native reader: FLAC {flac_ms:.3f} ms, WAV "
                     f"{wav_ms:.3f} ms, wav_read_batch {batch_ms:.3f} ms a 10 s clip (host "
                     f"clock, mean over {FILES_CLIPS})")
        out["mel"] = _files_mel(smi, k1, k23, flac_dir, want)
        texts = _texts(FILES_CLIPS, SEED + 82)
        for i, (w, text) in enumerate(zip(_pcm16(_waves(FILES_CLIPS, HUBERT_SAMPLES,
                                                         SEED + 83)), texts)):
            _write_wav16(os.path.join(pair_dir, f"utt{i}.wav"), w, 16000)
            with open(os.path.join(pair_dir, f"utt{i}.txt"), "w") as f:
                f.write(text + "\n")
        out["seq2seq"] = _files_seq2seq(smi, k1, k23, pair_dir)
    out["http"] = _files_http(smi, k1)
    log("files", f"phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return out


def files_rows(k1: dict, k23: dict, files: dict) -> list:
    """Phase 20's rows: bf16 K1, K2 and K3 on mel training from files, fp32
    K1, K2 and K3 on seq2seq training from files, and K1 on the example
    server's requests (the bf16 denoiser and the fp32 encoder apart)."""
    rows = tally_rows(k1, k23, *files["mel"], "files_mel_train")
    rows += tally_rows(k1, k23, *files["seq2seq"], "files_seq2seq_train")
    counts, tally = files["http"]
    for dtype, path in ((torch.bfloat16, "http_serve"), (torch.float32, "http_serve_encoder")):
        part = collections.Counter({k: c for k, c in tally.items() if k[2] == dtype})
        rows += tally_rows(k1, k23, {"k1": sum(part.values())}, part, path, ("k1",))
    assert sum(r["launches"] for r in rows[-2:]) == counts["k1"], (rows[-2:], counts)
    return rows


def semantic_rows(k1: dict, k4: dict, k4_dec: dict, k23: dict, sem: dict) -> list:
    """Rows of the semantic paths from the shapes each launched its kernels
    at: K1 on the seq2seq encoder (decode and serving, fp32) and the
    denoiser under the generated mask (bf16), bf16 K4 in the quantized
    denoiser, fp32 K4 on the quantized decode, fp32 K1/K2/K3 in training."""
    def parts(tally, kernel, dtype, table):
        out = []
        for key, count in tally.items():
            if key[0] != kernel or key[2] != dtype:
                continue
            if kernel == "k1":
                r = next(r for r in table.values() if tuple(r["shape"]) == key[1]
                         and r["dtype"] == dtype and r["masked"] == key[3] and "ms" in r)
            else:
                r = table[key[1]]
            out.append((count, {**r, "dtype": dtype}))
        return out

    dec_tally, serve_tally, train_tally = sem["decode"][1], sem["serve"][1], sem["train"][1]
    rows = []
    for path, kernel, dtype, tallies, table, extra in (
        ("semantic_encoder", "k1", torch.float32, (dec_tally, serve_tally), k1, {}),
        ("semantic_serve", "k1", torch.bfloat16, (serve_tally,), k1, {}),
        ("semantic_serve", "k4", torch.bfloat16, (serve_tally,), k4,
         {"library": "cuBLAS bf16 on the weight dequantized ahead of time"}),
        ("semantic_decode_w8a16", "k4", torch.float32, (dec_tally,), k4_dec,
         {"library": "cuBLAS fp32 (TF32 off) on the weight dequantized ahead of time",
          "routes": {"gemv": [list(t) for t in K4_TILES[torch.float32][1:]],
                     "tiled": list(K4_TILES[torch.float32][0]),
                     "gemv_max_rows": K4_GEMV_ROWS}}),
        ("seq2seq_train", "k1", torch.float32, (train_tally,), k1, {}),
    ):
        merged = collections.Counter()
        for t in tallies:
            merged.update(t)
        row = _path_row(kernel, f"{NAMES[kernel]}[{path}]", parts(merged, kernel, dtype, table))
        rows.append({**row, "path": path, **extra})
    train_counts = sem["train"][0]
    rows += [_k23_row(kk, "seq2seq_train", k23["dp_train_f32"], train_counts[kk])
             for kk in ("k2", "k3")]
    return rows


def _path_row(kernel: str, name: str, parts, path: str = "serve_w8a16") -> dict:
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
        "name": name, "path": path, "route": "cuda", "source": SOURCES[kernel],
        "replaces": REPLACES[kernel], "launches": total,
        "max_abs_err": max(r["max_abs_err"] for _, r in parts),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
        "bound_by": heaviest["bound_by"], "library_ms": mean("library_ms"),
        "timed_as": "mean per launch over the path's shapes, weighted by their launches",
        "per_shape": [{"shape": list(r["shape"]), "dtype": str(r["dtype"])[6:], "launches": c,
                       **{k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                            "bound_by", "max_abs_err", "int8pack_ms", "tile",
                                            "share_of_bound", "vs_library", "tile_ms")
                          if k in r}}
                      for c, r in parts],
    }


def engine_rows(k1: dict, k4: dict, tally, path: str = "serve_w8a16") -> list:
    """The K1 rows (the denoiser's bf16 calls, the duration predictor's or
    the seq2seq encoder's fp32 calls) and the K4 row of a quantized serving
    path (by default the duration-mode engine's), each from the shapes the
    path launched it at (`shape_tally`). Fails if the path ran a kernel at a
    shape that phases 3 and 5 did not hold against the plain version and
    time."""
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
    k4_name = NAMES["k4"] if path == "serve_w8a16" else f"{NAMES['k4']}[{path}]"
    fp32_role = "duration_predictor" if path != "semantic_long" else "encoder"
    return [_path_row("k1", f"{NAMES['k1']}[{path}]", by_role["denoiser"], path),
            _path_row("k1", f"{NAMES['k1']}[{path}_{fp32_role}]", by_role["predictor"], path),
            {**_path_row("k4", k4_name, by_role["k4"], path),
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


def _k1_row(path: str, r: dict, launches: int) -> dict:
    """K1's row on one path, timed at that path's shape (phase 3)."""
    return {
        "name": f"{NAMES['k1']}[{path}]", "path": path, "route": "cuda", "source": SOURCES["k1"],
        "replaces": REPLACES["k1"], "launches": launches, "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": list(r["shape"]),
        "dtype": str(r["dtype"])[6:],
    }


def _k23_row(kk: str, path: str, r: dict, launches: int, name: str = None) -> dict:
    """K2's or K3's row on one path, timed at that path's shape (phase 4)."""
    return {
        "name": name or f"{NAMES[kk]}[{path}]", "path": path, "route": "cuda",
        "source": SOURCES[kk], "replaces": REPLACES[kk], "launches": launches,
        # K3's error is the larger of dk's and dv's
        "max_abs_err": r["max_abs_err"][0] if kk == "k2" else max(r["max_abs_err"][1:]),
        **_k23_timed_row(r, kk),
        "plain_and_library_compute": "dq, dk and dv together",
    }


# phase 21: LoRA fine-tuning and data-parallel training at full width
LORA_RANK, LORA_ALPHA, LORA_LR = 8, 16, 1e-3
LORA_WARMUP, LORA_TIMED = 2, 4  # 10 timed steps until phase 15b needed room
# 1 + 1 steps (2 + 3 until phase 22 took the script past its clock, 1 + 2
# until phase 24 needed its time)
DP_WORLD, DP_WARMUP, DP_TIMED, DP_ITEMS = 2, 1, 1, 16
DP_MODES = ("replicated", "fsdp")
DP_TIMEOUT_S = 600
# The single-process reference takes the global batch as 2 micro-batches of
# 4 rows: the rows, draws and kernel shapes of the two ranks, summed in the
# same order, so "replicated" must equal it to the bit. "fsdp" clips by a
# norm summed over the shards in another order: its losses within
# DP_FSDP_RTOL, its parameters within DP_UPDATE_RTOL of the single
# process's update (after DP_WARMUP + DP_TIMED steps). (A reference at 8 rows a micro-batch differs
# from either by bf16 rounding that the flagship's chaotic gradients at unit
# qk gains amplify: 2.4e-3 of the loss after one step on the H100.)
# The flagship at unit qk gains is chaotic (ROADMAP Queue 3: gradient norms
# of 1e12 at init): the clip's norm summed in another order moved "fsdp"'s
# loss by 1.2e-3 two steps later on the H100. Phase 21 (b) trains at qk
# gains of 0.25 (`_soften_qk_gains`), where rounding stays rounding.
DP_FSDP_RTOL, DP_UPDATE_RTOL = 1e-5, 1e-3
DP_QK_GAIN = 0.25
# the fold: folded against hooked in units of hooked bf16 against fp32,
# for the whole forward and for each adapted Linear on its own
FOLD_FLOOR_TIMES = 2.0
FOLD_QK_GAIN = 0.25


def _lora_flagship():
    vb = vbt.VoiceBox(audio_enc_dec=EncodecVoco(), dtype=torch.bfloat16,
                      param_dtype=torch.float32, **FLAGSHIP)
    return vbt.ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2)


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def phase_lora(smi: str, k1: dict, k4: dict) -> tuple:
    """(a): rank-8 adapters on the seeded flagship (EncodecVoco attached, bf16
    compute over fp32 weights), Adam on the adapters only at batch 8 x 752
    frames; then folded, and the folded model served under w8a16."""
    cfm = seeded(_lora_flagship, SEED + 41)
    vb = cfm.voicebox
    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
    lora = lora_init(vb, rank=LORA_RANK, generator=gen)
    n_lora = sum(p.numel() for p in lora_parameters(lora))
    n_base = sum(p.numel() for p in vb.parameters())
    merge_lora_params(vb, lora)
    base = {n: p.detach().clone() for n, p in vb.named_parameters()}
    start_a = [ab["lora_a"].detach().clone() for ab in lora.values()]
    scale = lora_scale(LORA_ALPHA, LORA_RANK)
    opt = torch.optim.Adam(lora_parameters(lora), lr=LORA_LR)
    x = torch.randn(TRAIN_BATCH, TRAIN_FRAMES, LATENT_DIM, generator=gen, device="cuda")
    ids = torch.randint(0, FLAGSHIP["num_cond_tokens"], (TRAIN_BATCH, TRAIN_FRAMES),
                        generator=gen, device="cuda")
    mask = torch.ones(TRAIN_BATCH, TRAIN_FRAMES, dtype=torch.bool, device="cuda")
    cfm.train()

    def step():
        with lora_dense(scale):
            loss = cfm.loss_fn(x, mask=mask, cond_token_ids=ids, generator=gen)
            loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    for _ in range(LORA_WARMUP):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    depth = FLAGSHIP["depth"]
    reset_launches()  # the LoRA path's run starts here
    losses = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with shape_tally() as tally:
        start.record()
        for _ in range(LORA_TIMED):
            before = read_launches()
            losses.append(step())
            after = read_launches()
            got = {k: after[k] - before[k] for k in after}
            assert got == {"k1": depth, "k2": depth, "k3": depth, "k4": 0}, (
                f"a LoRA step launched {got}, expected {depth} of K1, K2 and K3")
        end.record()
        torch.cuda.synchronize()
    counts = read_launches()
    gpu_ms = start.elapsed_time(end)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = torch.stack(losses).tolist()
    assert all(math.isfinite(v) for v in losses), losses
    _assert_checked(tally, k1, "the LoRA step")
    changed = [n for n, p in vb.named_parameters() if not torch.equal(p, base[n])]
    assert not changed, f"LoRA training moved base parameters: {changed[:5]}"
    frozen = [n for n, ab in lora.items() if not ab["lora_b"].detach().any()]
    frozen += [n for (n, ab), a0 in zip(lora.items(), start_a) if torch.equal(ab["lora_a"], a0)]
    assert not frozen, f"adapters that did not move: {frozen[:5]}"
    prof = _profile(step)
    idle = prof["idle"]
    log("lora", f"flagship + rank-{LORA_RANK} adapters (alpha {LORA_ALPHA}, scale {scale}) on "
                f"{len(lora)} Linears: {n_lora:,} adapter weights beside {n_base:,} base "
                f"({n_base / n_lora:.1f}x fewer trainable, {100 * n_lora / n_base:.3f}%); Adam "
                f"lr {LORA_LR} on the adapters only, batch {TRAIN_BATCH} x {TRAIN_FRAMES} frames; "
                f"{LORA_TIMED} timed steps after {LORA_WARMUP}: losses "
                f"{[round(v, 4) for v in losses]}, K1/K2/K3 {depth}/{depth}/{depth} a step; "
                f"every base parameter bit-identical, every adapter moved")
    log("lora", f"steps/s {LORA_TIMED / (gpu_ms / 1e3):.3f} (CUDA events, "
                f"{gpu_ms / LORA_TIMED:.2f} ms/step) beside phase 10's full step "
                f"{MEASURED.get('train_steps_s', float('nan')):.3f}; peak memory {peak_gib:.2f} "
                f"GiB beside phase 10's {MEASURED.get('train_peak_gib', float('nan')):.2f} GiB; "
                f"profiled step: wall {prof['wall_ms']:.2f} ms, busy {prof['busy_ms']:.2f} ms, "
                f"{prof['kernels']} kernels, idle share "
                f"{'not measured' if idle is None else f'{idle:.3f}'} on {smi}")

    # the fold: the folded bf16 forward against the hooked one, beside the
    # hooked bf16 forward against the same in fp32 compute, at soft qk gains
    cfm.eval()
    _soften_qk_gains(vb, FOLD_QK_GAIN)
    folded = fold_lora(vb, lora, scale)
    twin = vbt.VoiceBox(audio_enc_dec=vb.audio_enc_dec, dtype=torch.float32,
                        **FLAGSHIP).cuda()
    twin.load_state_dict(vb.state_dict())
    merge_lora_params(twin, lora)
    cond = torch.randn(1, FRAMES, LATENT_DIM, generator=gen, device="cuda")
    fids = torch.randint(0, FLAGSHIP["num_cond_tokens"], (1, FRAMES), generator=gen,
                         device="cuda")
    kw = dict(times=torch.full((1,), 0.4, device="cuda"), cond=cond, cond_token_ids=fids,
              cond_drop_mask=torch.zeros(1, dtype=torch.bool, device="cuda"))
    xt = torch.randn(1, FRAMES, LATENT_DIM, generator=gen, device="cuda")
    with torch.no_grad():
        with lora_dense(scale):
            hooked, hooked32 = vb(xt, **kw), twin(xt, **kw)
        plain = folded(xt, **kw)
    floor, gap = _rel(hooked, hooked32), _rel(plain, hooked)
    del twin
    # each adapted Linear on its own: the folded bf16 product and the hooked
    # one against the hooked product in fp32, on N(0, 1) rows
    ratios = []
    with torch.no_grad():
        for name, ab in lora.items():
            lin, flin = vb.get_submodule(name), folded.get_submodule(name)
            xs = torch.randn(FRAMES, lin.in_features, generator=gen, device="cuda")
            ref = F.linear(xs, lin.weight) + scale * ((xs @ ab["lora_a"]) @ ab["lora_b"])
            with lora_dense(scale):
                hooked_lin = lin(xs.to(torch.bfloat16))
            ratios.append(_rel(flin(xs.to(torch.bfloat16)), ref) / _rel(hooked_lin, ref))
    log("lora", f"fold (qk gains {FOLD_QK_GAIN}): whole forward ||folded - hooked|| / ||hooked|| "
                f"= {gap:.3e} against the bf16 floor ||hooked bf16 - hooked fp32|| / ||fp32|| = "
                f"{floor:.3e} (the depth-24 forward at random weights amplifies bf16 rounding); "
                f"per adapted Linear, error of the folded bf16 product / error of the hooked one "
                f"(both against hooked fp32): max {max(ratios):.3f}, median "
                f"{float(np.median(ratios)):.3f} over {len(ratios)} (bound {FOLD_FLOOR_TIMES})")
    assert gap <= FOLD_FLOOR_TIMES * floor, (gap, floor)
    assert max(ratios) <= FOLD_FLOOR_TIMES, ratios

    # the folded model served under w8a16: one 750-frame request at CFG 1.3
    served = vbt.ConditionalFlowMatcherWrapper(folded)
    reset_launches()  # the folded request's run starts here
    with shape_tally() as serve_tally:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio = served.sample(cond=cond, semantic_token_ids=fids, steps=STEPS,
                              cond_scale=CFG_SCALE, quantize="w8a16", generator=gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    serve_counts = read_launches()
    want = (1, 1, FRAMES * served.codec.downsample_factor)
    assert tuple(audio.shape) == want and bool(torch.isfinite(audio).all()), audio.shape
    assert (serve_counts["k1"], serve_counts["k4"]) == (K1_PER_WINDOW, K4_PER_WINDOW), (
        f"the folded w8a16 request launched {serve_counts}, expected {K1_PER_WINDOW} K1 and "
        f"{K4_PER_WINDOW} K4")
    parts = {"k1": [], "k4": []}
    for key, count in sorted(serve_tally.items(), key=str):
        if key[0] == "k1":
            _, shape, dtype, masked = key
            found = [r for r in k1.values() if tuple(r["shape"]) == shape and r["dtype"] == dtype
                     and r["masked"] == masked and "ms" in r]
        else:
            _, shape, dtype = key
            found = [k4[shape]] if dtype == torch.bfloat16 and shape in k4 else []
        assert found, f"the folded request ran {key[0]} at {shape} {dtype}, which no check timed"
        parts[key[0]].append((count, {**found[0], "dtype": dtype}))
    log("lora", f"folded + w8a16: one request of {FRAMES} frames ({STEPS} steps, CFG "
                f"{CFG_SCALE}): latency {dt * 1e3:.1f} ms (host clock, the quantized copy built "
                f"in it), K1 {serve_counts['k1']} and K4 {serve_counts['k4']} launches at "
                f"{len(serve_tally)} checked shapes, audio finite {want}")
    del cfm, vb, folded, served, opt, lora, base
    torch.cuda.empty_cache()
    return counts, tally, parts


def lora_rows(k1: dict, k23: dict, counts: dict, parts: dict) -> list:
    rows = [_k1_row("lora_train", k1["train_bf16"], counts["k1"])]
    rows += [_k23_row(kk, "lora_train", k23["train_bf16"], counts[kk]) for kk in ("k2", "k3")]
    rows.append(_path_row("k1", f"{NAMES['k1']}[lora_folded_w8a16]", parts["k1"],
                          "lora_folded_w8a16"))
    rows.append({**_path_row("k4", f"{NAMES['k4']}[lora_folded_w8a16]", parts["k4"],
                             "lora_folded_w8a16"),
                 "library": "cuBLAS bf16 on the weight dequantized ahead of time"})
    return rows


def _dp_items(same: bool = False) -> list:
    rs = np.random.RandomState(SEED + 51)
    items = [(rs.randn(TRAIN_FRAMES, LATENT_DIM).astype(np.float32),
              rs.randint(0, FLAGSHIP["num_cond_tokens"], TRAIN_FRAMES).astype(np.int32))
             for _ in range(1 if same else DP_ITEMS)]
    return items * TRAIN_BATCH if same else items


def _dp_trainer(items, seed: int, batch_size: int = TRAIN_BATCH, dtype=torch.bfloat16,
                depth: int = FLAGSHIP["depth"], **kw):
    """Phase 10's flagship trainer on cuda:0 (both ranks share the card),
    its weights made there from `seed` (`seeded_on`: each rank and the
    single process build the same ones, with no host init); `dtype` and
    `depth` change the denoiser's compute dtype and depth."""
    def build():
        vb = vbt.VoiceBox(dim_in=LATENT_DIM, dtype=dtype, param_dtype=torch.float32,
                          **{**FLAGSHIP, "depth": depth})
        _soften_qk_gains(vb, DP_QK_GAIN)
        return vbt.ConditionalFlowMatcherWrapper(vb, cond_drop_prob=0.2, device="cuda:0")

    return vbt.VoiceBoxTrainer(
        seeded_on("cuda:0", build, seed), batch_size=batch_size, dataset=vbt.ArrayDataset(items),
        num_train_steps=1000, lr=1e-4, wd=1e-2, max_grad_norm=0.5, valid_frac=0.0,
        log_every=1000, save_results_every=1000, seed=SEED, device="cuda:0", **kw)


def _first_gradients(trainer) -> dict:
    """Wrap `trainer._apply_gradients` so that its first call's gradients
    (the step's mean, before the clip) land in the returned dict, on the
    host, by parameter name."""
    grads, apply = {}, trainer._apply_gradients

    def applied(loss, g):
        if not grads:
            grads.update({n: x.detach().float().cpu() for (n, _), x in
                          zip(trainer.named_params, g)})
        return apply(loss, g)

    trainer._apply_gradients = applied
    return grads


def _dp_explicit_draws(steps: int) -> list:
    """Explicit draws of whole steps' global batches, the same on every rank."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 55)
    m = TRAIN_BATCH
    return [dict(noise=torch.randn(m, TRAIN_FRAMES, LATENT_DIM, generator=gen, device="cuda"),
                 times=torch.rand(m, generator=gen, device="cuda"),
                 cond_mask=torch.rand(m, TRAIN_FRAMES, generator=gen, device="cuda") < 0.7,
                 cond_drop_mask=torch.rand(m, generator=gen, device="cuda") < 0.2)
            for _ in range(steps)]


def dp_worker(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """One rank of phase 21 (b), run as `chip_smoke.py --dp-worker`: gloo at
    world 2, both ranks on cuda:0; under "replicated" and "fsdp" DP_WARMUP
    warm-up and DP_TIMED timed steps, held (rank 0) to the single process's
    losses and parameters; then an "orbax" save after 1 step and a resume
    into ranks built from other weights; then phase 22 (`tp_sp_worker`).
    Writes rank{r}.json."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # the bit-identical resume below
    assert maybe_initialize_distributed(f"file://{init_file}", world, rank, backend="gloo")
    import torch.distributed as dist

    out = Path(out_dir)
    res = {"rank": rank}
    single = torch.load(out / "single.pt") if rank == 0 else None
    depth = FLAGSHIP["depth"]
    for mode in DP_MODES:
        trainer = _dp_trainer(_dp_items(), SEED + 52, param_sharding=mode)
        dp = trainer.data_parallel
        collective_s = []

        def timed(fn):
            def call(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = fn(*a)
                torch.cuda.synchronize()
                collective_s.append(time.perf_counter() - t0)
                return got
            return call

        dp.reduce, dp.gather_params = timed(dp.reduce), timed(dp.gather_params)
        # the timed window's peak (`window`), and each part's beside it: the
        # peak counter is read and reset at each part's start and end, so
        # the window's is the largest over every stretch, inside a part or
        # between two (the clip, the batch's copy, the live copies' swaps)
        part_peaks, window = collections.defaultdict(float), [0]

        def stretch() -> int:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            window[0] = max(window[0], peak)
            return peak

        def peaked(name, fn):
            def call(*a, **kw):
                stretch()
                got = fn(*a, **kw)
                part_peaks[name] = max(part_peaks[name], stretch())
                return got
            return call

        draws = iter(_dp_explicit_draws(DP_WARMUP + DP_TIMED))
        losses = [trainer.train_step(**next(draws))["loss"] for _ in range(DP_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # the timed window starts here
        collective_s.clear()
        trainer._gradients = peaked("forward and backward", trainer._gradients)
        dp.reduce = peaked("reduction", dp.reduce)
        trainer.optimizer.step = peaked("AdamW", trainer.optimizer.step)
        dp.gather_params = peaked("gather", dp.gather_params)
        reset_launches()  # this rank's data-parallel run starts here
        step_s = []
        with shape_tally() as tally:
            for _ in range(DP_TIMED):
                before = read_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(trainer.train_step(**next(draws))["loss"])
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                after = read_launches()
                got = {k: after[k] - before[k] for k in after}
                assert got == {"k1": depth, "k2": depth, "k3": depth, "k4": 0}, (mode, got)
        stretch()  # the timed window ends here
        r = {"launches": read_launches(), "step_ms": [t * 1e3 for t in step_s],
             "collective_ms": sum(collective_s) * 1e3 / DP_TIMED,
             "peak_gib": window[0] / 2 ** 30,
             "part_peaks_gib": {k: v / 2 ** 30 for k, v in part_peaks.items()},
             "losses": torch.stack(losses).tolist(),
             "shapes": [[k[0], list(k[1]), str(k[2]), k[3], c] for k, c in tally.items()],
             "split": sum(dp.sharded)}
        if rank == 0:
            r["n_differ"] = sum(not torch.equal(p.detach().cpu(), single["params"][n])
                                for n, p in trainer.named_params)
            update = sum(float((single["params"][n] - single["init"][n]).square().sum())
                         for n, _ in trainer.named_params)
            gap = sum(float((p.detach().cpu() - single["params"][n]).square().sum())
                      for n, p in trainer.named_params)
            r["update_rel_gap"] = math.sqrt(gap / update)
            r["max_abs_gap"] = max(float((p.detach().cpu() - single["params"][n]).abs().max())
                                   for n, p in trainer.named_params)
        res[mode] = r
        # the timing wrappers hold `dp` in a cycle: collect it before the next
        # layout's peak, or its whole weights would count there
        del trainer, dp, peaked, timed, stretch
        gc.collect()
        torch.cuda.empty_cache()

    # "orbax": every item the same (a checkpoint keeps no loader position),
    # explicit draws; the run saves after 1 step and takes a second, ranks
    # built from other weights load the save and take the same second step
    draws = _dp_explicit_draws(2)
    kw = dict(param_sharding="fsdp", checkpoint_backend="orbax", ema_decay=0.999,
              results_folder=str(out / "orbax"))
    a = _dp_trainer(_dp_items(same=True), SEED + 53, **kw)
    a.train_step(**draws[0])
    t0 = time.perf_counter()
    path = a.save()
    save_s = time.perf_counter() - t0
    loss_a = a.train_step(**draws[1])["loss"]
    b = _dp_trainer(_dp_items(same=True), SEED + 54, **kw)
    t0 = time.perf_counter()
    b.load(1)
    load_s = time.perf_counter() - t0
    assert b.steps == 1, b.steps
    loss_b = b.train_step(**draws[1])["loss"]
    torch.cuda.synchronize()
    differ = [n for (n, p), q in zip(a.named_params, b.params) if not torch.equal(p, q)]
    differ += [f"{key} {n}" for (n, _), p, q in zip(a.named_params, a.opt_params, b.opt_params)
               for key in ("exp_avg", "exp_avg_sq")
               if not torch.equal(a.optimizer.state[p][key], b.optimizer.state[q][key])]
    differ += [f"ema {n}" for (n, _), x, y in zip(a.named_params, a.ema.shadow, b.ema.shadow)
               if not torch.equal(x, y)]
    res["orbax"] = {"loss": [loss_a.item(), loss_b.item()],
                    "same_loss": bool(torch.equal(loss_a, loss_b)), "differ": differ[:5],
                    "n_differ": len(differ), "save_s": save_s, "load_s": load_s,
                    "files": sorted(p.name for p in path.iterdir()),
                    "mib": sum(p.stat().st_size for p in path.iterdir()) / 2 ** 20}
    del a, b
    torch.cuda.empty_cache()
    res.update(tp_sp_worker(rank, world, out))
    res["pp"] = pp_worker(rank, world, out)
    dist.barrier()
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def phase_dp(smi: str, k1: dict, k23: dict) -> dict:
    """(b): the single-process trainer at the global batch here, then two
    ranks spawned under gloo on this card (`dp_worker`); their results."""
    out = kernels.BUILD_DIR.parent / "phase21"  # in the checkout, ignored by git
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as the ranks run
    try:
        # the global batch as the ranks' two micro-batches of 4 rows
        single = _dp_trainer(_dp_items(), SEED + 52, batch_size=TRAIN_BATCH // DP_WORLD,
                             grad_accum_every=DP_WORLD)
        init = {n: p.detach().cpu().clone() for n, p in single.named_params}
        t0 = time.perf_counter()
        single_losses = [single.train_step(**d)["loss"]
                         for d in _dp_explicit_draws(DP_WARMUP + DP_TIMED)]
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        torch.save({"init": init, "params": {n: p.detach().cpu() for n, p in
                                             single.named_params}}, out / "single.pt")
        single_losses = torch.stack(single_losses).tolist()
        init_names = list(init)
        del single, init
        torch.cuda.empty_cache()
        tp_sp_ref = phase_tp_sp_references(out)
        pp_ref = phase_pp_references(out)

        env = dict(os.environ, OMP_NUM_THREADS="4")
        logs = [open(out / f"rank{r}.log", "w") for r in range(DP_WORLD)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker",
                                   str(r), str(DP_WORLD), str(out / "init"), str(out)],
                                  env=env, stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(DP_WORLD)]
        try:
            for p in procs:
                p.wait(timeout=max(1.0, DP_TIMEOUT_S - (time.perf_counter() - t0)))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        spawn_s = time.perf_counter() - t0
        for r, p in enumerate(procs):
            assert p.returncode == 0, (f"data-parallel rank {r} exited {p.returncode}:\n"
                                       + (out / f"rank{r}.log").read_text()[-6000:])
        ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(DP_WORLD)]
    finally:
        torch.backends.cudnn.deterministic = was
        shutil.rmtree(out / "orbax", ignore_errors=True)
        for name in ("single.pt", "single8.pt", "grads_f32.pt", "long_inputs.pt", "long_ref.pt",
                     "pp_out.pt", "pp_grads.pt"):
            (out / name).unlink(missing_ok=True)

    log("dp", f"two ranks under gloo sharing cuda:0, batch {TRAIN_BATCH} x {TRAIN_FRAMES} frames "
              f"({TRAIN_BATCH // DP_WORLD} rows a rank); single process: losses "
              f"{[round(v, 5) for v in single_losses]} ({single_s:.1f} s for "
              f"{len(single_losses)} steps); the ranks' processes {spawn_s:.1f} s")
    result = {}
    for mode in DP_MODES:
        r0 = ranks[0][mode]
        for rk in ranks:
            _assert_checked(collections.Counter({
                (k, tuple(shape), getattr(torch, dt[6:]), masked): c
                for k, shape, dt, masked, c in rk[mode]["shapes"] if k == "k1"}), k1,
                f"data-parallel rank {rk['rank']} ({mode})")
        if mode == "replicated":
            assert r0["losses"] == single_losses and r0["n_differ"] == 0, (
                f"replicated differs from the single process: losses {r0['losses']} against "
                f"{single_losses}, {r0['n_differ']} parameters")
        else:
            np.testing.assert_allclose(r0["losses"], single_losses, rtol=DP_FSDP_RTOL, atol=0)
            assert r0["update_rel_gap"] <= DP_UPDATE_RTOL, (mode, r0["update_rel_gap"])
        per_rank = "; ".join(
            f"rank {rk['rank']}: {np.mean(m['step_ms']):.1f} ms/step "
            f"({', '.join(f'{t:.1f}' for t in m['step_ms'])}), reduction "
            f"{m['collective_ms']:.1f} ms ({m['collective_ms'] / np.mean(m['step_ms']):.3f}), "
            f"peak {m['peak_gib']:.2f} GiB" for rk in ranks for m in [rk[mode]])
        bound = "to the bit" if mode == "replicated" else (
            f"losses within rtol {DP_FSDP_RTOL}, update gap bound {DP_UPDATE_RTOL}")
        log("dp", f"{mode}: rank 0 losses {r0['losses']} against the single process's "
                  f"({bound}); parameters after {DP_WARMUP + DP_TIMED} steps: "
                  f"{r0['n_differ']} of {len(init_names)} differ, "
                  f"||rank 0 - single|| / ||single's update|| = {r0['update_rel_gap']:.3e}, "
                  f"max |gap| {r0['max_abs_gap']:.3e}; {r0['split']} parameters split over the "
                  f"ranks; "
                  f"K1/K2/K3 a step {FLAGSHIP['depth']} each on every rank; {per_rank} (gloo "
                  f"through the host, not NVLink) on {smi}")
        result[mode] = {kk: sum(rk[mode]["launches"][kk] for rk in ranks)
                        for kk in ("k1", "k2", "k3")}
    ob = ranks[0]["orbax"]
    log("dp", f"orbax (fsdp, EMA): saved after 1 step ({ob['mib']:.0f} MiB in "
              f"{', '.join(ob['files'])}; {ob['save_s']:.2f} s), loaded into ranks built from "
              f"other weights ({ob['load_s']:.2f} s); second step loss uninterrupted "
              f"{ob['loss'][0]:.6f} resumed {ob['loss'][1]:.6f}; tensors that differ "
              f"(parameters, moment and EMA shards) on rank 0 / 1: "
              f"{ranks[0]['orbax']['n_differ']} / {ranks[1]['orbax']['n_differ']}")
    for rk in ranks:
        assert rk["orbax"]["same_loss"] and rk["orbax"]["n_differ"] == 0, rk["orbax"]
    assert {"__0_0.distcp", "__1_0.distcp", ".metadata"} <= set(ob["files"]), ob["files"]
    peaks = [(rk["fsdp"]["peak_gib"], rk["replicated"]["peak_gib"]) for rk in ranks]
    log("dp", "peak a rank over the timed steps (max_memory_allocated), fsdp against "
              "replicated: " + "; ".join(
        f"rank {r}: {f:.3f} against {p:.3f} GiB" for r, (f, p) in enumerate(peaks))
        + "; rank 0's by part of the step, fsdp against replicated: " + ", ".join(
            f"{k} {ranks[0]['fsdp']['part_peaks_gib'][k]:.3f} against "
            f"{ranks[0]['replicated']['part_peaks_gib'][k]:.3f}"
            for k in ranks[0]["fsdp"]["part_peaks_gib"])
        + "; gloo took every collective's CUDA tensors itself")
    log("tp_sp", f"phase 22 (in phase 21 (b)'s ranks; the single-process references "
                 f"before them)")
    result["tp_sp"] = phase_tp_sp_report(smi, k1, k23, ranks, tp_sp_ref, single_losses)
    log("pp", "phase 22 (c) (in phase 21 (b)'s ranks, after (a) and (b); the single-process "
              "reference before them)")
    result["pp"] = phase_pp_report(smi, k1, k23, ranks, pp_ref)
    assert all(f < p for f, p in peaks), f"fsdp's peak is not under replicated's: {peaks}"
    return result


def dp_rows(k1: dict, k23: dict, dp: dict) -> list:
    rows = []
    for mode in DP_MODES:
        counts = dp[mode]
        path = f"data_parallel_{mode}"
        rows.append({**_k1_row(path, k1["rank_train_bf16"], counts["k1"]),
                     "launches_are": "both ranks' timed steps"})
        rows += [{**_k23_row(kk, path, k23["rank_train_bf16"], counts[kk]),
                  "launches_are": "both ranks' timed steps"} for kk in ("k2", "k3")]
    return rows


# phase 22: tensor and sequence parallelism at full width, in phase 21 (b)'s
# two rank processes. Both layouts run phase 10's global batch (8 x 752) on
# each rank, so they are held against one single-process run at 8 rows a
# micro-batch. Neither is bitwise: "tp" sums the row-parallel partial
# products of 2 heads (and 2 halves of the gathered feed-forward) where one
# process sums 4, and the ring merges the blocks' bf16 outputs by their lse
# where one launch sums all keys; each moves every layer's output by
# rounding. The bounds are set from the distance between two single-process
# runs that differ only in summation order (phase 21 (b)'s reference at two
# micro-batches of 4 rows against this one): TP_SP_TIMES_FLOOR times it,
# for the losses over the DP_WARMUP + DP_TIMED steps. Neither the
# parameters after the steps nor the gradients of the bf16 depth-24 model
# can be held: two single-process runs that differ only in summation order
# are 1.36 of the update apart after 3 steps (Adam moves each weight whose
# gradient is rounding noise by ~lr), and their first step's gradients 1.44
# apart over all leaves (the depth-24 backward at random weights amplifies
# a rounding to the gradient's size; both on an NVIDIA H100 80GB HBM3 at
# 700.00 W, PR 16), so the parameters' distance is printed only. The
# gradients are held in a model where rounding stays rounding
# (TP_SP_GRAD_MODEL: fp32 compute at depth 4, the flagship's width, heads
# and registers, one step on the same draws): each layout's first reduced
# gradients, gathered whole, before the clip and Adam, over every leaf and
# leaf by leaf, within TP_SP_GRAD_TOL of one process's, the bound fp32 K2
# and K3 are held to against autograd (phase 4). They read 1.2e-5 to 1.6e-5
# on the H100 (PR 16; 7-9x two single-process runs' batch-order floor of
# 1.7e-6: the split sums and the ring's merge reorder more); a gradient
# that lost one rank's share reads ~0.5, a zero one 1, a flipped one 2.
# Ring attention alone is held on the card against the plain ring first
# (`ring_card_check`). The long
# utterance's field (4080 frames, 2040 a rank) in bf16 is held to
# SP_LONG_TIMES_FLOOR times the bf16 forward's distance from the fp32
# forward of the same weights and inputs. At depth 24 and random weights
# that distance is most of the field (0.88 on the H100): the stack
# amplifies a rounding ~1000x (fp32 K1 differs from the plain version by
# ~1e-6 and the fp32 ring's field from one process's by 1.05e-3 at depth
# 24), so that check only catches a gross fault. The tight one is the same
# field in fp32 at depth SP_LONG_F32_DEPTH, held to SP_LONG_F32_TOL: ~1e-6
# a layer, a few times that after 4 (4.8e-6 on the CPU), where a misplaced
# block, halo or rotary offset moves it by O(1).
TP_SP_TIMES_FLOOR, TP_SP_GRAD_TOL = 4.0, 1e-4
TP_SP_GRAD_MODEL = dict(dtype=torch.float32, depth=4)
SP_LONG_FRAMES, SP_LONG_TIMES_FLOOR = 4080, 1.0
SP_LONG_F32_DEPTH, SP_LONG_F32_TOL = 4, 1e-4
TP_SP_PER_STEP = {"tp": 1, "sp": 2}  # K1, K2 and K3 launches a layer on a rank


@contextlib.contextmanager
def collective_clock():
    """Host seconds inside torch.distributed's collectives (synchronized
    before and after each), summed in `clock["s"]`."""
    import torch.distributed as dist

    clock = {"s": 0.0, "calls": 0}
    names = ("all_reduce", "all_to_all_single", "all_gather_into_tensor",
             "reduce_scatter_tensor", "broadcast")
    saved = {n: getattr(dist, n) for n in names}

    def timed(fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(*a, **kw)
            torch.cuda.synchronize()
            clock["s"] += time.perf_counter() - t0
            clock["calls"] += 1
            return got
        return call

    for n in names:
        setattr(dist, n, timed(saved[n]))
    try:
        yield clock
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def _long_model(dtype, depth: int = FLAGSHIP["depth"]):
    def build():
        vb = vbt.VoiceBox(dim_in=LATENT_DIM, dtype=dtype, param_dtype=torch.float32,
                          **{**FLAGSHIP, "depth": depth})
        _soften_qk_gains(vb, DP_QK_GAIN)
        return vb.eval()
    return seeded_on("cuda:0", build, SEED + 56)


def _long_inputs() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 57)
    n = SP_LONG_FRAMES
    span = torch.zeros(1, n, dtype=torch.bool, device="cuda")
    span[:, n // 4: 3 * n // 4] = True  # the middle half to generate
    return {"x": torch.randn(1, n, LATENT_DIM, generator=gen, device="cuda"),
            "cond": torch.randn(1, n, LATENT_DIM, generator=gen, device="cuda"),
            "cond_mask": span, "times": torch.full((1,), 0.5, device="cuda"),
            "ids": torch.randint(0, FLAGSHIP["num_cond_tokens"], (1, n), generator=gen,
                                 device="cuda")}


def _long_field(vb, inp) -> torch.Tensor:
    with torch.no_grad():
        return vb(inp["x"], times=inp["times"], cond=inp["cond"], cond_mask=inp["cond_mask"],
                  cond_token_ids=inp["ids"],
                  cond_drop_mask=torch.zeros(1, dtype=torch.bool, device="cuda")).float()


def _leaf_gaps(got: dict, ref: dict) -> dict:
    """||got - ref|| / ||ref|| per leaf and over every leaf together."""
    sq = {n: (float((got[n].double() - r.double()).square().sum()),
              float(r.double().square().sum())) for n, r in ref.items()}
    return {"leaves": {n: math.sqrt(a / max(b, 1e-300)) for n, (a, b) in sq.items()},
            "all": math.sqrt(sum(a for a, _ in sq.values())
                             / sum(b for _, b in sq.values()))}


def _ring_check_inputs(rank: int, world: int, prefixed: bool) -> dict:
    """A sequence-parallel rank's bf16 ring operands at phase 22's training
    shape (8 rows, 4 heads of 128, 376 frames a rank, the 16 registers as
    the prefix), the same draws on every rank: qk-norm'd q and k at scale
    10; key padding at each row's end over the whole sequence, row 1 with
    none of its keys on the last rank and (without the prefix) row 2 with no
    key anywhere."""
    b, h, d = TRAIN_BATCH, FLAGSHIP["heads"], FLAGSHIP["dim_head"]
    p, n = FLAGSHIP["num_register_tokens"], TRAIN_FRAMES // world
    gen = torch.Generator(device="cuda").manual_seed(SEED + 58)
    q, k, v, do = (torch.randn(b, h, p + world * n, d, generator=gen, device="cuda")
                   for _ in range(4))
    q, k = (l2norm(t) * d ** 0.5 for t in (q, k))
    lengths = torch.randint(n // 3, world * n + 1, (b,), generator=gen, device="cuda")
    lengths[0], lengths[1], lengths[2] = world * n, (world - 1) * n - 10, 0 if not prefixed \
        else n // 2
    frames = torch.arange(world * n, device="cuda")[None, :] < lengths[:, None]
    mine = slice(p + rank * n, p + (rank + 1) * n)
    mask = frames[:, rank * n:(rank + 1) * n]
    if prefixed:
        mask = torch.cat([torch.ones(b, p, dtype=torch.bool, device="cuda"), mask], dim=1)
    rows = [torch.cat([t[:, :, :p], t[:, :, mine]], dim=2) if prefixed else t[:, :, mine]
            for t in (q, k, v, do)]
    out = {x: t.to(torch.bfloat16).contiguous() for x, t in zip(("q", "k", "v", "do"), rows)}
    return {**out, "mask": mask.contiguous(), "p": p if prefixed else 0}


def _ring_run(inp, group) -> list:
    """Ring attention's output and the gradients of q, k and v under `inp`'s
    output gradient (the prefix rows' on every rank): [out, dq, dk, dv]."""
    qkv = [inp[x].clone().requires_grad_() for x in "qkv"]
    if inp["p"]:
        out_p, out_l = ring_attention_prefixed(*qkv, inp["p"], inp["mask"], 10.0, group)
        out = torch.cat([out_p, out_l], dim=2)
    else:
        out = ring_attention(*qkv, inp["mask"], 10.0, group)
    out.backward(inp["do"])
    return [out.detach()] + [x.grad for x in qkv]


# ring attention on the card in bf16 against the plain fp32 ring, per output
# (out, dq, dk, dv): within RING_BF16_TIMES_FLOOR x the distance of the same
# route run by the kernels' plain versions on the host. The floor is the
# route's: at qk-norm's scale 10 a row's softmax is peaked, so dS = P (dP -
# delta) is a small difference of bf16-rounded terms and dq, dk read ~7e-3
# to 9e-3 from fp32 by either run (on the H100, 9e-3 from each other); the
# plain ring's autograd rounds elsewhere and reads 2.5e-3. The bf16 check
# holds the kernels; a fault of the route's own logic moves the host's run
# too, and the fp32 check holds that (9e-6 against NORM_TOL's 1e-4 on the
# H100): a gradient sent to the wrong rank reads ~1 there, a keyless row
# counted once per block 1e-2 (both planted on the CPU)
RING_BF16_TIMES_FLOOR = 2.0


@contextlib.contextmanager
def _ring_route(device: str, route):
    """Ring attention on `device`'s tensors by `route` while the block runs."""
    saved = ring_module._ROUTES[device]
    ring_module._ROUTES[device] = route
    try:
        yield
    finally:
        ring_module._ROUTES[device] = saved


def ring_card_check(rank: int, world: int, group) -> dict:
    """Ring attention on the card (`_kernel_ring`: K1 per block, delta, K2 +
    K3 per block against the merged lse, the keys' gradients sent home),
    with and without the prefix, ragged (row 1 with no key on the last rank)
    and, without the prefix, a row with no key anywhere; out, dq, dk and dv,
    ||err|| / ||ref|| against the plain ring (`_plain_ring`, autograd through
    per-block plain attention) in fp32 on the same values: fp32 within
    NORM_TOL's bound against autograd; bf16 within RING_BF16_TIMES_FLOOR x
    the bf16 floor of the route, the same route's distance on the host's
    copies, where each kernel is its plain version. Printed beside: bf16
    against the host's run directly, and the plain ring's own distance in
    bf16. Launches of the check are no path's."""
    res = {}
    for prefixed in (True, False):
        bf16 = _ring_check_inputs(rank, world, prefixed)
        f32 = {**bf16, **{x: bf16[x].float() for x in ("q", "k", "v", "do")}}
        host = {x: t.cpu() if torch.is_tensor(t) else t for x, t in bf16.items()}
        runs, launches = {}, {}
        for key, inp, route in (("kernels_bf16", bf16, ring_module._kernel_ring),
                                ("kernels_f32", f32, ring_module._kernel_ring),
                                ("plain_bf16", bf16, ring_module._plain_ring),
                                ("plain_f32", f32, ring_module._plain_ring)):
            with _ring_route("cuda", route):
                before = read_launches()
                runs[key] = _ring_run(inp, group)
                after = read_launches()
            launches[key] = {k: after[k] - before[k] for k in after}
        with _ring_route("cpu", ring_module._kernel_ring):
            runs["host_bf16"] = _ring_run(host, group)
        torch.cuda.synchronize()

        def errs(key, ref):
            return [_norm_err(a.cpu(), b.cpu()) for a, b in zip(runs[key], runs[ref])]

        res["prefixed" if prefixed else "ring"] = {
            "shape": list(bf16["q"].shape), "f32": errs("kernels_f32", "plain_f32"),
            "bf16": errs("kernels_bf16", "plain_f32"), "floor": errs("host_bf16", "plain_f32"),
            "vs_host": errs("kernels_bf16", "host_bf16"),
            "plain_bf16": errs("plain_bf16", "plain_f32"),
            "finite": all(bool(torch.isfinite(t).all()) for key in runs for t in runs[key]),
            "launches": [launches[k] for k in ("kernels_bf16", "kernels_f32")],
            "plain_launches": [launches[k] for k in ("plain_bf16", "plain_f32")]}
    return res


def tp_sp_worker(rank: int, world: int, out: Path) -> dict:
    """Phase 22 on one rank (called by `dp_worker` after phase 21 (b)):
    ring attention alone (`ring_card_check`); "tp" at model `world` and
    sequence parallelism at seq `world`, each DP_WARMUP warm-up and
    DP_TIMED timed steps of phase 10's trainer on the explicit draws, then
    one step of TP_SP_GRAD_MODEL whose reduced gradients are kept; then the
    long utterance's field on this rank's frames."""
    import torch.distributed as dist
    from voicebox_tpu_torch.parallel.mesh import make_mesh
    from voicebox_tpu_torch.parallel.sequence_parallel import sp_forward

    single = torch.load(out / "single8.pt") if rank == 0 else None
    depth, res = FLAGSHIP["depth"], {}
    res["ring_check"] = ring_card_check(rank, world, dist.group.WORLD)
    for layout in ("tp", "sp"):
        kw = (dict(param_sharding="tp", mesh=make_mesh(model_parallel=world, device_type="cuda"))
              if layout == "tp" else dict(seq_parallel=world))
        trainer = _dp_trainer(_dp_items(), SEED + 52, **kw)
        dp = trainer.data_parallel
        draws = iter(_dp_explicit_draws(DP_WARMUP + DP_TIMED))
        losses = [trainer.train_step(**next(draws))["loss"] for _ in range(DP_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()  # this rank's run of the layout starts here
        step_s = []
        per = TP_SP_PER_STEP[layout] * depth
        with shape_tally() as tally, collective_clock() as clock:
            for _ in range(DP_TIMED):
                before = read_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(trainer.train_step(**next(draws))["loss"])
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                after = read_launches()
                got = {k: after[k] - before[k] for k in after}
                assert got == {"k1": per, "k2": per, "k3": per, "k4": 0}, (layout, got)
        r = {"launches": read_launches(), "step_ms": [t * 1e3 for t in step_s],
             "collective_ms": clock["s"] * 1e3 / DP_TIMED, "collectives": clock["calls"],
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "losses": torch.stack(losses).tolist(),
             "shapes": [[k[0], list(k[1]), str(k[2]), k[3], c] for k, c in tally.items()]}
        state = dp.module_state(trainer.module)  # every rank: the pieces gathered whole
        if rank == 0:
            names = [n for n, _ in trainer.named_params]
            update = sum(float((single["params"][n] - single["init"][n]).square().sum())
                         for n in names)
            gap = sum(float((state[n].detach().cpu() - single["params"][n]).square().sum())
                      for n in names)
            r["update_rel_gap"] = math.sqrt(gap / update)
            r["held_bytes"] = sum(p.numel() * p.element_size() for p in trainer.params)
        del trainer, dp, state
        gc.collect()
        torch.cuda.empty_cache()
        # the gradient check: TP_SP_GRAD_MODEL's first step's reduced
        # gradients, whole, before the clip
        trainer = _dp_trainer(_dp_items(), SEED + 59, **TP_SP_GRAD_MODEL, **kw)
        dp, first = trainer.data_parallel, {}

        def reduced(g, scalars, reduce=dp.reduce):
            got = reduce(g, scalars)
            wholes = dp.whole([x.detach() for x in got[0]])
            first.update({n: x.float().cpu() for n, x in zip(dp.names, wholes)})
            return got

        dp.reduce = reduced
        trainer.train_step(**_dp_explicit_draws(1)[0])
        if rank == 0:
            r["grad_gap"] = _leaf_gaps(first, torch.load(out / "grads_f32.pt"))
        res[layout] = r
        del trainer, dp, first, reduced
        gc.collect()
        torch.cuda.empty_cache()

    # the long utterance: the vector field on this rank's frames, one forward
    inp = torch.load(out / "long_inputs.pt")
    n_local = SP_LONG_FRAMES // world
    frames = slice(rank * n_local, (rank + 1) * n_local)
    refs = torch.load(out / "long_ref.pt")
    reset_launches()
    with shape_tally() as tally:
        for dtype, depth in ((torch.bfloat16, FLAGSHIP["depth"]),
                             (torch.float32, SP_LONG_F32_DEPTH)):
            vb = _long_model(dtype, depth)
            t0 = time.perf_counter()
            with torch.no_grad():
                field = sp_forward(vb, dist.group.WORLD)(
                    inp["x"][:, frames], inp["times"], inp["cond"][:, frames],
                    cond_mask=inp["cond_mask"][:, frames], cond_token_ids=inp["ids"]).float()
            torch.cuda.synchronize()
            name = f"{str(dtype)[6:]}_d{depth}"
            res[f"sp_long_{name}"] = {
                "s": time.perf_counter() - t0, "finite": bool(torch.isfinite(field).all()),
                "rel_gap": _rel(field, refs[name][:, frames].cuda())}
            del vb, field
            torch.cuda.empty_cache()
    res["sp_long"] = {"launches": read_launches(),
                      "shapes": [[k[0], list(k[1]), str(k[2]), k[3], c]
                                 for k, c in tally.items()]}
    return res


def _tally_of(shapes) -> collections.Counter:
    return collections.Counter({(k, tuple(shape), getattr(torch, dt[6:]), masked): c
                                for k, shape, dt, masked, c in shapes})


def phase_tp_sp_references(out: Path) -> dict:
    """Phase 22's single-process references, before the ranks start: phase
    10's trainer at 8 rows a micro-batch on the explicit draws, and the long
    utterance's field in bf16 and fp32."""
    single = _dp_trainer(_dp_items(), SEED + 52)
    init = {n: p.detach().cpu().clone() for n, p in single.named_params}
    losses = [single.train_step(**d)["loss"] for d in _dp_explicit_draws(DP_WARMUP + DP_TIMED)]
    torch.save({"init": init, "params": {n: p.detach().cpu() for n, p in single.named_params}},
               out / "single8.pt")
    losses = torch.stack(losses).tolist()
    del single, init
    # the gradient check's: the first step of TP_SP_GRAD_MODEL
    single = _dp_trainer(_dp_items(), SEED + 59, **TP_SP_GRAD_MODEL)
    grads = _first_gradients(single)
    single.train_step(**_dp_explicit_draws(1)[0])
    torch.save(grads, out / "grads_f32.pt")
    del single, grads
    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    inp = _long_inputs()
    torch.save(inp, out / "long_inputs.pt")
    fields = {}
    for dtype, depth in ((torch.bfloat16, FLAGSHIP["depth"]), (torch.float32, FLAGSHIP["depth"]),
                         (torch.float32, SP_LONG_F32_DEPTH)):
        vb = _long_model(dtype, depth)
        name = f"{str(dtype)[6:]}_d{depth}"
        t0 = time.perf_counter()
        fields[name] = _long_field(vb, inp).cpu()
        torch.cuda.synchronize()
        fields[f"{name}_s"] = time.perf_counter() - t0
        del vb
        torch.cuda.empty_cache()
    torch.save(fields, out / "long_ref.pt")
    # the summation-order floor of the parameters: phase 21 (b)'s reference
    # at two micro-batches of 4 rows against this one at 8, after the same
    # DP_WARMUP + DP_TIMED steps
    four, eight = torch.load(out / "single.pt"), torch.load(out / "single8.pt")
    update = sum(float((eight["params"][n] - eight["init"][n]).square().sum())
                 for n in eight["params"])
    gap = sum(float((four["params"][n] - eight["params"][n]).square().sum())
              for n in eight["params"])
    deep = FLAGSHIP["depth"]
    return {"losses": losses, "update_floor": math.sqrt(gap / update),
            "long_floor": _rel(fields[f"bfloat16_d{deep}"], fields[f"float32_d{deep}"]),
            "long_s": fields[f"bfloat16_d{deep}_s"]}


def phase_tp_sp_report(smi: str, k1: dict, k23: dict, ranks: list, ref: dict,
                       dp_single: list) -> dict:
    """Phase 22's checks and lines from both ranks' results."""
    for name in ranks[0]["ring_check"]:
        checks = [rk["ring_check"][name] for rk in ranks]
        tol = NORM_TOL[torch.float32][1]

        def by_rank(key):
            return "; ".join("/".join(f"{x:.2e}" for x in c[key]) for c in checks)

        log("tp_sp", f"ring attention on the card ({name}, q {tuple(checks[0]['shape'])}, "
                     f"ragged{'' if name == 'prefixed' else ', a row with no key'}), "
                     f"||err|| / ||ref|| of out/dq/dk/dv by rank against the plain fp32 ring on "
                     f"the same values: fp32 {by_rank('f32')} (tol {tol:g}); bf16 "
                     f"{by_rank('bf16')} (tol {RING_BF16_TIMES_FLOOR:g} x the route's floor on "
                     f"the host, each kernel's plain version: {by_rank('floor')}); for "
                     f"information, bf16 against the host's run {by_rank('vs_host')}, the plain "
                     f"ring's in bf16 {by_rank('plain_bf16')}; launches a rank (bf16, fp32) "
                     f"{checks[0]['launches']}, the plain ring's {checks[0]['plain_launches']}")
        for c in checks:
            assert c["finite"] and max(c["f32"]) <= tol, (name, c)
            assert all(e <= RING_BF16_TIMES_FLOOR * f for e, f in zip(c["bf16"], c["floor"])), (
                name, c)
            assert all(min(n[k] for k in ("k1", "k2", "k3")) > 0 for n in c["launches"]), c
            assert not any(v for n in c["plain_launches"] for v in n.values()), (name, c)
    floor = max(abs(a - b) / abs(b) for a, b in zip(dp_single, ref["losses"]))
    counts = {}
    for layout in ("tp", "sp"):
        r0 = ranks[0][layout]
        for rk in ranks:
            tally = _tally_of(rk[layout]["shapes"])
            _assert_checked(tally, k1, f"phase 22 rank {rk['rank']} ({layout})")
            _assert_k23_checked(tally, k23, f"phase 22 rank {rk['rank']} ({layout})")
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref["losses"]))
        bound = TP_SP_TIMES_FLOOR * max(floor, 1e-6)
        per_rank = "; ".join(
            f"rank {rk['rank']}: {np.mean(m['step_ms']):.1f} ms/step "
            f"({', '.join(f'{t:.1f}' for t in m['step_ms'])}), collectives "
            f"{m['collective_ms']:.1f} ms ({m['collective_ms'] / np.mean(m['step_ms']):.3f}, "
            f"{m['collectives'] // DP_TIMED} calls a step), peak {m['peak_gib']:.2f} GiB, "
            f"K1/K2/K3 {m['launches']['k1']}/{m['launches']['k2']}/{m['launches']['k3']} "
            f"launches, no collective staged by hand"
            for rk in ranks for m in [rk[layout]])
        tally = sum((_tally_of(rk[layout]["shapes"]) for rk in ranks), collections.Counter())
        shapes = sorted({(k, sh) for (k, sh, *_) in tally})
        means = {}
        for kk, results in (("k1", k1), ("k2", k23), ("k3", k23)):
            timed = {tuple(r["shape"]): (r["ms"] if kk == "k1" else r["times"][kk])
                     for r in results.values() if r["dtype"] == torch.bfloat16
                     and ("ms" in r if kk == "k1" else "times" in r)}
            n = sum(c for (k, *_), c in tally.items() if k == kk)
            means[kk] = sum(timed[sh] * c for (k, sh, *_), c in tally.items() if k == kk) / n
        gaps = r0["grad_gap"]  # TP_SP_GRAD_MODEL's first step
        worst = max(gaps["leaves"], key=gaps["leaves"].get)
        log("tp_sp", f"{layout} at {DP_WORLD} ranks (phase 10's batch of {TRAIN_BATCH} x "
                     f"{TRAIN_FRAMES} on each): rank 0 losses {[round(v, 6) for v in r0['losses']]} "
                     f"against the single process's {[round(v, 6) for v in ref['losses']]}, "
                     f"largest relative gap {loss_gap:.3e} (bound {bound:.3e} = "
                     f"{TP_SP_TIMES_FLOOR} x the summation-order floor {floor:.3e}); the first "
                     f"step's gradients in fp32 at depth {TP_SP_GRAD_MODEL['depth']} "
                     f"||rank 0 - single|| / ||single|| over all {len(gaps['leaves'])} leaves "
                     f"{gaps['all']:.3e}, largest leaf {worst} {gaps['leaves'][worst]:.3e} (bound "
                     f"{TP_SP_GRAD_TOL:g} each); parameters after "
                     f"{DP_WARMUP + DP_TIMED} steps ||rank 0 - single|| / ||single's update|| = "
                     f"{r0['update_rel_gap']:.3e} (the floor {ref['update_floor']:.3e}; for "
                     f"information: Adam moves a weight whose gradient is rounding noise by ~lr); "
                     f"{r0['held_bytes'] / 2 ** 20:.0f} MiB of parameters a rank; K1/K2/K3 at "
                     f"{shapes}, mean ms "
                     f"{means['k1']:.4f}/{means['k2']:.4f}/{means['k3']:.4f}; {per_rank} (gloo "
                     f"through the host, not NVLink) on {smi}")
        assert loss_gap <= bound, (layout, r0["losses"], ref["losses"], floor)
        assert max(gaps["all"], gaps["leaves"][worst]) <= TP_SP_GRAD_TOL, (layout, gaps["all"],
                                                                           worst)
        counts[layout] = {kk: sum(rk[layout]["launches"][kk] for rk in ranks)
                          for kk in ("k1", "k2", "k3")}
        counts[f"{layout}_tally"] = tally
    bf, f32 = ([rk[f"sp_long_{n}"] for rk in ranks]
               for n in (f"bfloat16_d{FLAGSHIP['depth']}", f"float32_d{SP_LONG_F32_DEPTH}"))
    f32_gaps = ", ".join(f"{r['rel_gap']:.3e}" for r in f32)
    log("tp_sp", f"a {SP_LONG_FRAMES}-frame utterance's vector field (one forward, "
                 f"{SP_LONG_FRAMES // DP_WORLD} frames + 16 registers a rank, ring attention and "
                 f"the halo conv) against the single process's of the same dtype, relative "
                 f"gap by rank: bf16 {[round(r['rel_gap'], 6) for r in bf]} (bound "
                 f"{SP_LONG_TIMES_FLOOR} x the bf16-vs-fp32 floor {ref['long_floor']:.3e}), fp32 "
                 f"at depth {SP_LONG_F32_DEPTH} [{f32_gaps}] (bound {SP_LONG_F32_TOL}); bf16 "
                 f"{[round(r['s'], 3) for r in bf]} s by rank against {ref['long_s']:.3f} s in one "
                 f"process (host clock, first call)")
    for rk, b_, f_ in zip(ranks, bf, f32):
        _assert_checked(_tally_of(rk["sp_long"]["shapes"]), k1,
                        f"phase 22 rank {rk['rank']} (long)")
        assert b_["finite"] and f_["finite"], rk["rank"]
        assert b_["rel_gap"] <= SP_LONG_TIMES_FLOOR * ref["long_floor"], (rk["rank"], b_)
        assert f_["rel_gap"] <= SP_LONG_F32_TOL, (rk["rank"], f_)
    counts["sp_long"] = {kk: sum(rk["sp_long"]["launches"][kk] for rk in ranks)
                         for kk in ("k1", "k2", "k3")}
    counts["sp_long_tally"] = sum((_tally_of(rk["sp_long"]["shapes"]) for rk in ranks),
                                  collections.Counter())
    return counts


def tp_sp_rows(k1: dict, k23: dict, counts: dict) -> list:
    """K1, K2 and K3 rows of phase 22: "tp" at a rank's heads, each ring
    block's shape in training and on the long utterance; launches are both
    ranks' timed steps (or the long forward)."""
    rows = []
    for path, cases in (("train_tp", ("tp_rank_bf16",)),
                        ("train_sp", ("sp_own_bf16", "sp_remote_bf16")),
                        ("sp_long", ("sp_long_own_bf16", "sp_long_remote_bf16",
                                     "sp_long_own_f32", "sp_long_remote_f32"))):
        tally = counts[f"{path[6:] if path.startswith('train_') else path}_tally"]
        for case in cases:
            shape, dtype = tuple(k1[case]["shape"]), k1[case]["dtype"]
            for kk in ("k1",) if path == "sp_long" else ("k1", "k2", "k3"):
                n = sum(c for (k, sh, dt, _), c in tally.items()
                        if k == kk and sh == shape and dt == dtype)
                row = (_k1_row(path, k1[case], n) if kk == "k1"
                       else _k23_row(kk, path, k23[case], n))
                rows.append({**row, "name": f"{NAMES[kk]}[{path}:{case}]",
                             "launches_are": "both ranks' timed steps" if path != "sp_long"
                             else "both ranks' one forward"})
    return rows


# phase 22 (c): pipeline parallelism at full width, in phase 21 (b)'s two
# rank processes. The flagship's transformer as VoiceBox builds it (dim
# 512, depth 24, 4 x 128 heads, 16 registers, qk-norm at gains 0.25,
# adaptive RMSNorm on the 2048-wide time embedding, bf16 compute over fp32
# weights) with the U-Net skips on, so that the V-cycle's skip buffers run;
# PP_STAGES = 2 stages over the two ranks, PP_MICRO = 4 microbatches of
# PP_ROWS = 2 x 752 frames, every frame real (mask all True). Each stage
# holds 6 front and 6 back layers on the card and launches 2 x 6 x 4 = 48
# K1 a step, and 48 K2 and 48 K3. The same kernels run at the same shapes
# as in one process and the ring moves bytes, so each microbatch's output
# must equal the unpipelined module's to the bit. The gradients sum the
# microbatches' shares in another order than one process does: they are
# held, gathered over every leaf, within TP_SP_TIMES_FLOOR of the distance
# between two single-process runs that differ only in that order (the
# microbatches' forwards made in reverse). Two ranks share one card, so the
# phase records correctness and overhead, not speed-up; the schedule's
# predicted bubble is (2S - 1) / (M + 2S - 1) = 3/7.
PP_STAGES, PP_MICRO, PP_ROWS = 2, 4, 2
PP_MODEL = dict(dim=FLAGSHIP["dim"], depth=FLAGSHIP["depth"], dim_head=FLAGSHIP["dim_head"],
                heads=FLAGSHIP["heads"], num_register_tokens=FLAGSHIP["num_register_tokens"],
                attn_qk_norm=True, adaptive_rmsnorm=True,
                adaptive_rmsnorm_cond_dim_in=4 * FLAGSHIP["dim"], use_unet_skip_connection=True)
PP_PER_STEP = 2 * (PP_MODEL["depth"] // 2 // PP_STAGES) * PP_MICRO  # K1, K2, K3 a rank a step
PP_WARMUP, PP_TIMED = 1, 2


def _pp_model():
    """The pipeline phase's transformer, on the host from a seed: every
    rank and the single process build the same weights."""
    def build():
        tr = vbt.Transformer(**PP_MODEL, dtype=torch.bfloat16, param_dtype=torch.float32)
        _soften_qk_gains(tr, DP_QK_GAIN)
        return tr
    return seeded(build, SEED + 80)


def _pp_inputs() -> dict:
    """The microbatches (M, b, n, dim) in bf16, as VoiceBox hands the
    transformer its input, the fp32 time condition and the mask."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 81)
    shape = (PP_MICRO, PP_ROWS, TRAIN_FRAMES)
    return {"x": torch.randn(*shape, PP_MODEL["dim"], generator=gen,
                             device="cuda").to(torch.bfloat16),
            "cond": torch.randn(*shape[:2], PP_MODEL["adaptive_rmsnorm_cond_dim_in"],
                                generator=gen, device="cuda"),
            "mask": torch.ones(shape, dtype=torch.bool, device="cuda")}


def _pp_loss(out: torch.Tensor) -> torch.Tensor:
    return out.float().square().mean()


def phase_pp_references(out: Path) -> dict:
    """The pipeline phase's single-process references, before the ranks
    start: the unpipelined transformer on the card over each microbatch and
    the loss's gradients (run A); run B, the microbatches' forwards in
    reverse and the same loss (the summation-order floor of the gradients),
    whose seconds and peak memory stand beside the ranks'."""
    tr = _pp_model().cuda()
    inp = _pp_inputs()
    grads, timing = [], {}
    for order in (range(PP_MICRO), reversed(range(PP_MICRO))):
        tr.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs = {m: tr(inp["x"][m], inp["mask"][m], inp["cond"][m]) for m in order}
        outs = torch.stack([outs[m] for m in range(PP_MICRO)])
        _pp_loss(outs).backward()
        torch.cuda.synchronize()
        timing.update(s=time.perf_counter() - t0,
                      peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        grads.append({n: p.grad.detach().clone() for n, p in tr.named_parameters()})
        if len(grads) == 1:
            torch.save(outs.detach().cpu(), out / "pp_out.pt")
            torch.save({n: g.cpu() for n, g in grads[0].items()}, out / "pp_grads.pt")
    floor = _leaf_gaps({n: g.cpu() for n, g in grads[1].items()},
                       {n: g.cpu() for n, g in grads[0].items()})
    del tr, grads, outs
    torch.cuda.empty_cache()
    return {**timing, "floor": floor["all"], "leaves": len(floor["leaves"])}


def pp_worker(rank: int, world: int, out: Path) -> dict:
    """Phase 22 (c) on one rank (after `tp_sp_worker`): the flagship
    transformer pipelined over the two ranks, PP_WARMUP + PP_TIMED
    forwards and backwards of the PP_MICRO microbatches, the first one's
    output (rank 0) and gradients (every rank) against the single process's."""
    import torch.distributed as dist
    from voicebox_tpu_torch.parallel import make_pp_forward

    tr = _pp_model()
    fn = make_pp_forward(tr, dist.group.WORLD, num_microbatches=PP_MICRO, device="cuda:0")
    inp = _pp_inputs()
    held = sum(p.numel() * p.element_size() for p in tr.parameters() if p.is_cuda)
    res = {"held_gib": held / 2 ** 30}
    first = fn(inp["x"], inp["mask"], inp["cond"])
    _pp_loss(first).backward()
    torch.cuda.synchronize()
    if rank == 0:
        ref = torch.load(out / "pp_out.pt")
        got = first.detach().cpu()
        res["same_bits"] = [bool(torch.equal(got[m], ref[m])) for m in range(PP_MICRO)]
        res["max_abs"] = float((got.float() - ref.float()).abs().max())
        res["finite"] = bool(torch.isfinite(got).all())
    ref = torch.load(out / "pp_grads.pt")
    sq = {n: (float((p.grad.double().cpu() - ref[n].double()).square().sum()),
              float(ref[n].double().square().sum()))
          for n, p in tr.named_parameters() if p.grad is not None}
    res["grad_sq"] = sq
    res["grad_same_bits"] = sum(torch.equal(p.grad.cpu(), ref[n]) for n, p in tr.named_parameters()
                                if p.grad is not None)
    res["grad_finite"] = all(bool(torch.isfinite(p.grad).all()) for p in tr.parameters()
                             if p.grad is not None)
    del ref, first
    for _ in range(PP_WARMUP - 1):
        tr.zero_grad(set_to_none=True)
        _pp_loss(fn(inp["x"], inp["mask"], inp["cond"])).backward()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # this rank's pipelined run starts here
    step_s = []
    with shape_tally() as tally, collective_clock() as clock:
        for _ in range(PP_TIMED):
            tr.zero_grad(set_to_none=True)
            before = read_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _pp_loss(fn(inp["x"], inp["mask"], inp["cond"])).backward()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            after = read_launches()
            got = {k: after[k] - before[k] for k in after}
            want = {"k1": PP_PER_STEP, "k2": PP_PER_STEP, "k3": PP_PER_STEP, "k4": 0}
            assert got == want, (rank, got)
    res.update(launches=read_launches(), step_ms=[t * 1e3 for t in step_s],
               collective_ms=clock["s"] * 1e3 / PP_TIMED, collectives=clock["calls"] // PP_TIMED,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               shapes=[[k[0], list(k[1]), str(k[2]), k[3], c] for k, c in tally.items()])
    del fn, tr
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_pp_report(smi: str, k1: dict, k23: dict, ranks: list, ref: dict) -> dict:
    """Phase 22 (c)'s checks and lines from both ranks' results."""
    pp = [rk["pp"] for rk in ranks]
    r0 = pp[0]
    sq = {}
    for r in pp:
        sq.update(r["grad_sq"])
    leaves = {n: math.sqrt(a / max(b, 1e-300)) for n, (a, b) in sq.items()}
    gap = math.sqrt(sum(a for a, _ in sq.values()) / sum(b for _, b in sq.values()))
    worst = max(leaves, key=leaves.get)
    bound = TP_SP_TIMES_FLOOR * max(ref["floor"], 1e-6)
    bubble = (2 * PP_STAGES - 1) / (PP_MICRO + 2 * PP_STAGES - 1)
    per_rank = "; ".join(
        f"rank {i}: {np.mean(r['step_ms']):.1f} ms a forward and backward of the {PP_MICRO} "
        f"microbatches ({', '.join(f'{t:.1f}' for t in r['step_ms'])}), collectives "
        f"{r['collective_ms']:.1f} ms ({r['collective_ms'] / np.mean(r['step_ms']):.3f}, "
        f"{r['collectives']} calls a step), peak {r['peak_gib']:.2f} GiB with "
        f"{r['held_gib']:.2f} GiB of weights on the card, K1/K2/K3 "
        f"{r['launches']['k1']}/{r['launches']['k2']}/{r['launches']['k3']} launches"
        for i, r in enumerate(pp))
    log("pp", f"pipeline at {PP_STAGES} stages over the two ranks, {PP_MICRO} microbatches of "
              f"{PP_ROWS} x {TRAIN_FRAMES} frames, the flagship transformer with U-Net skips "
              f"(bf16): rank 0's outputs equal the single process's to the bit "
              f"{r0['same_bits']} (max |diff| {r0['max_abs']:.3e}); the gradients over "
              f"all {len(leaves)} leaves ||pipeline - single|| / ||single|| {gap:.3e} (bound "
              f"{bound:.3e} = {TP_SP_TIMES_FLOOR} x the summation-order floor "
              f"{ref['floor']:.3e}), largest leaf {worst} {leaves[worst]:.3e}, "
              f"{sum(r['grad_same_bits'] for r in pp)} leaves equal to the bit; predicted bubble "
              f"(2S-1)/(M+2S-1) = {bubble:.4f}; {per_rank}; one process: "
              f"{ref['s'] * 1e3:.1f} ms for the same forward and backward (host clock, second "
              f"call), peak {ref['peak_gib']:.2f} GiB (gloo through the host, not NVLink) on "
              f"{smi}")
    assert all(r0["same_bits"]) and r0["finite"], r0
    assert all(r["grad_finite"] for r in pp), "non-finite pipeline gradients"
    # every leaf on exactly one rank
    assert len(sq) == ref["leaves"] == sum(len(r["grad_sq"]) for r in pp), (len(sq), ref)
    assert gap <= bound, (gap, bound, worst)
    for i, r in enumerate(pp):
        _assert_checked(_tally_of(r["shapes"]), k1, f"phase 22 (c) rank {i}")
        _assert_k23_checked(_tally_of(r["shapes"]), k23, f"phase 22 (c) rank {i}")
    return {kk: sum(r["launches"][kk] for r in pp) for kk in ("k1", "k2", "k3")}


def pp_rows(k1: dict, k23: dict, counts: dict) -> list:
    """K1, K2 and K3 rows of the pipeline (both ranks' timed steps)."""
    case = "pp_stage_bf16"
    return [{**(_k1_row("train_pp", k1[case], counts["k1"]) if kk == "k1"
                else _k23_row(kk, "train_pp", k23[case], counts[kk])),
             "name": f"{NAMES[kk]}[train_pp:{case}]", "launches_are": "both ranks' timed steps"}
            for kk in ("k1", "k2", "k3")]


def phase_dryrun(smi: str) -> None:
    """Phase 23: the multi-chip dry run (`voicebox_tpu_torch/dryrun.py`, one
    step of "fsdp+tp", the stage trainers, sequence and pipeline
    parallelism on tiny shapes) over two gloo ranks sharing cuda:0."""
    from voicebox_tpu_torch.dryrun import dryrun_multichip

    res = dryrun_multichip(DP_WORLD)
    assert res["placement"] == "shared", res
    log("dryrun", f"dryrun_multichip({DP_WORLD}): {res['seconds']:.1f} s of wall, the spawns "
                  f"included ({res['rank_seconds']:.1f} s inside rank 0), gloo ranks sharing "
                  f"cuda:0; losses: fsdp+tp "
                  f"{res['fsdp_tp']['loss']:.4f} at mesh {res['fsdp_tp']['mesh']}, stage trainers "
                  f"{res['stages']}, sequence-parallel {res['sp']['loss']:.4f} over "
                  f"{res['sp']['frames']} frames, pipeline {res['pp']['loss']:.4f} over "
                  f"{res['pp']['stages']} stages; every loss and gradient finite, on {smi}")


def kernel_line(k1, k23, serve_k1, engine, train_counts, levers_counts, levers_per_step,
                raw, semantic, long_rows) -> str:
    """One row per kernel and main path: K1 on the serving path (timed at the
    serving shape), on the quantized duration-mode path (`engine_rows`: the
    denoiser's and the duration predictor's calls) and on the training path
    (at the training shape); K2 and K3 on the training path; K4 on the
    quantized duration-mode path; K1, K2 and K3 on the training levers' path
    (phase 12, at the training shape, with the launches per step of each
    configuration); K1, K2 and K3 on the raw-wave mel training path and K1
    on its sampling (phase 14); fp32 K1, K2 and K3 on duration training and
    K1 on the trained predictor's sampling call (phase 15); the semantic
    paths' rows (phase 18, `semantic_rows`, and its long-form requests', with
    the later phases' rows after them, phase 24's last: `p24_rows`); the
    long-form and cloning path's rows (phase 9b: the windows' bf16 K1, the
    predictor's fp32 K1, K4)."""
    rows = [_k1_row("serve", k1["flagship_cfg_bf16"], serve_k1),
            _k1_row("train", k1["train_bf16"], train_counts["k1"])]
    rows += engine[:2]
    for kk in ("k2", "k3"):
        rows.append({**_k23_row(kk, "train", k23["train_bf16"], train_counts[kk],
                                name=NAMES[kk]),
                     "reference_split": _k23_timed_row(k23["reference_split_bf16"], kk)})
    rows.append(engine[2])
    for kk in ("k1", "k2", "k3"):
        base = next(r for r in rows if r["name"].startswith(NAMES[kk]) and r["path"] == "train")
        rows.append({**base, "name": f"{NAMES[kk]}[train_levers]", "path": "train_levers",
                     "launches": levers_counts[kk],
                     "launches_per_step": {n: c[kk] for n, c in levers_per_step.items()}})
    mel, dp = raw["mel"], raw["dp"]
    rows.append(_k1_row("mel_train", k1["mel_train_bf16"], mel["train"]["k1"]))
    rows += [_k23_row(kk, "mel_train", k23["mel_train_bf16"], mel["train"][kk])
             for kk in ("k2", "k3")]
    rows.append(_k1_row("mel_serve", k1["mel_serve_bf16"], mel["serve_k1"]))
    rows.append(_k1_row("duration_train", k1["dp_train_f32"], dp["train"]["k1"]))
    rows += [_k23_row(kk, "duration_train", k23["dp_train_f32"], dp["train"][kk])
             for kk in ("k2", "k3")]
    rows.append({**_k1_row("duration_sample", k1["dp_sample_f32"], dp["sample_k1_dp"]),
                 "note": f"the predictor's launches of the request; its denoiser launched "
                         f"{dp['sample_k1_denoiser']} bf16 K1 at mel_serve's shape"})
    rows += long_rows + semantic
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
    k4_dec = phase_k4_decode_check(smi)
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
    phase_long_card_vs_cpu()
    long_counts, long_tally = phase_long(smi)
    assert long_counts["k1"] > 0 and long_counts["k4"] > 0, (
        f"the long-form and cloning path skipped a kernel: {long_counts}"
    )
    long_rows = engine_rows(k1, k4, long_tally, path="serve_long")
    train_counts, trainer, untrained = phase_train(smi)
    assert min(train_counts[k] for k in ("k1", "k2", "k3")) > 0, (
        f"the training path skipped a kernel: {train_counts}"
    )
    phase_grad_witness(trainer, untrained, smi)
    del trainer
    torch.cuda.empty_cache()
    levers_counts, levers_per_step = phase_levers(smi)
    assert min(levers_counts[k] for k in ("k1", "k2", "k3")) > 0, (
        f"the training levers' path skipped a kernel: {levers_counts}"
    )
    phase_resume(smi)
    phase_levers_card_vs_cpu()
    phase_raw_card_vs_cpu()
    raw = {"mel": phase_mel(smi, k1), "dp": phase_duration(smi, k1)}
    assert min(raw["mel"]["train"][k] for k in ("k1", "k2", "k3")) > 0, raw["mel"]
    assert raw["mel"]["serve_k1"] > 0 and raw["dp"]["sample_k1"] > 0, raw
    assert min(raw["dp"]["train"][k] for k in ("k1", "k2", "k3")) > 0, raw["dp"]
    wide = {"flagship": phase_wide_flagship(smi, k1, k23), "dp": phase_wide_duration(smi, k1, k23)}
    phase_wide_card_vs_cpu()
    wide["chunked"] = phase_wide_flagship(smi, k1, k23, CHUNKED, SEED + 100, "15c (a)")
    phase_wide_card_vs_cpu(CHUNKED_SMALL, SEED + 104, floor=True, **CHUNKED_CARD_VS_CPU)
    assert min(wide[p]["train"][k] for p in wide for k in ("k1", "k2", "k3")) > 0, wide
    assert wide["flagship"]["serve"]["k1"] > 0 and wide["chunked"]["serve"]["k1"] > 0, wide
    p24 = phase_default_long(smi, k1, k23)
    phase_default_long_card_vs_cpu()
    for label, run in p24.items():
        kernels_ = ("k1",) if label.startswith("serve") else ("k1", "k2", "k3")
        assert min(run["counts"][k] for k in kernels_) > 0, (label, run["counts"])
    phase_encodec(smi)
    phase_semantic_card_vs_cpu()
    sem = phase_semantic(smi, k1, k4, k4_dec)
    for path, (counts, _) in sem.items():
        assert counts["k1"] > 0, f"the semantic {path} path launched no K1: {counts}"
    assert sem["decode"][0]["k4"] > 0 and sem["serve"][0]["k4"] > 0, sem
    assert sem["train"][0]["k2"] > 0 and sem["train"][0]["k3"] > 0, sem["train"][0]
    semantic = semantic_rows(k1, k4, k4_dec, k23, sem)
    semantic += engine_rows(k1, k4, sem["long"][1], path="semantic_long")
    trained_counts, trained_tally = phase_trained(smi, k1, k23, k4_dec)
    semantic += trained_rows(k1, k23, k4_dec, trained_counts, trained_tally)
    files = phase_files(smi, k1, k23)
    for path, (counts, _) in files.items():
        assert counts["k1"] > 0, f"the {path} path of phase 20 launched no K1: {counts}"
    assert min(files[p][0][k] for p in ("mel", "seq2seq") for k in ("k2", "k3")) > 0, files
    semantic += files_rows(k1, k23, files)
    lora_counts, _, lora_parts = phase_lora(smi, k1, k4)
    assert min(lora_counts[k] for k in ("k1", "k2", "k3")) > 0, lora_counts
    assert all(lora_parts[k] for k in ("k1", "k4")), "the folded request skipped a kernel"
    semantic += lora_rows(k1, k23, lora_counts, lora_parts)
    dp = phase_dp(smi, k1, k23)
    assert all(min(dp[m].values()) > 0 for m in DP_MODES), dp
    semantic += dp_rows(k1, k23, dp)
    tp_sp = dp["tp_sp"]
    assert all(min(tp_sp[p][k] for k in ("k1", "k2", "k3")) > 0 for p in ("tp", "sp")), tp_sp
    assert tp_sp["sp_long"]["k1"] > 0, tp_sp["sp_long"]
    semantic += tp_sp_rows(k1, k23, tp_sp)
    assert all(dp["pp"][k] == DP_WORLD * PP_TIMED * PP_PER_STEP for k in ("k1", "k2", "k3")), \
        dp["pp"]
    semantic += pp_rows(k1, k23, dp["pp"])
    semantic += wide_rows(k1, k23, wide)
    semantic += p24_rows(k1, k23, p24)
    phase_dryrun(smi)
    print(kernel_line(k1, k23, serve_k1, engine, train_counts, levers_counts, levers_per_step,
                      raw, semantic, long_rows), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:  # one rank of phase 21 (b)
        dp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        sys.exit(0)
    sys.exit(main())
