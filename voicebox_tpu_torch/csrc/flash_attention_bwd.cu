// K2 and K3: the attention backward (FlashAttention-2 math from the saved lse),
// for Hopper (sm_90a).
//
// Replaces voicebox_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel (K2) and
// ::_flash_bwd_dkv_kernel (K3), the Pallas TPU kernels driven by
// _flash_backward. They compute the same function, not the same blocks: with
// s = q.k * scale in fp32, p = exp(s - lse) from the forward's per-row lse,
// dp = dO.v and delta = rowsum(dO * O) (computed by the caller, fp32),
//   ds = p * (dp - delta) * scale,
//   K2: dQ = sum_j ds_ij K_j,
//   K3: dV = sum_i p_ij dO_i and dK = sum_i ds_ij Q_i,
// with fp32 sums and the results in the input dtype.
//
// Where the two differ from the Pallas kernels, on purpose (the port follows
// reference_attention, the plain softmax):
//  * masked keys get p = 0 by a select, never exp(s - lse) * keep: under
//    qk-norm a masked key's raw logit reaches 10 d = 1280, exp overflows to
//    inf, and inf * 0 is NaN. Keys past kv and query rows past n get p = 0
//    the same way, and tile rows past the ragged edge are zero in shared
//    memory, so no operand is padded;
//  * a row whose keys are all masked (K1 stores lse = fill + log kv, which
//    rounds back to the fill -0.7 * FLT_MAX; detected as lse < fill / 2) is
//    the uniform softmax over the kv real keys with its logits cut off from
//    q and k: p = 1 / kv on every real key and ds = 0. So dQ = dK = 0 there
//    and dV_j gains sum_i dO_i / kv, the plain softmax's gradient.
//
// What bounds them on the H100. At the training shape (batch 8, 4 heads, 768
// rows and keys, head dim 128, bf16) K2 does 6 b h n kv d = 14.5 GFLOP over
// ~31 MB (q, k, v, dO read, dQ written) and K3 8 b h n kv d = 19.3 GFLOP over
// ~38 MB: both far above the card's bf16 ridge (~295 FLOP per byte), so the
// tensor cores bound them (~15 and ~20 us at 989 TFLOP/s).
//
// bf16, what the design does about it (K1's building blocks, hopper.cuh):
//  * two kernels and no atomics: K2 is one block per (batch, head, 64 query
//    rows), K3 one block per (batch, head, 64 keys); each block owns its
//    output rows, so dQ, dK and dV are the same bit for bit from run to run.
//    One consumer warpgroup a block: at the training shape and the
//    reference head split, 128 owned rows on two warpgroups (a whole
//    producer warpgroup and setmaxnreg, as K1 has) lost to the 64-row
//    blocks or tied with them, so only the 64-row blocks are built;
//  * the owned tiles (K2: Q and dO; K3: K and V) arrive once by TMA; a
//    producer warp streams the other two (K2: K and V; K3: Q and dO) in
//    64-row tiles through a 2-stage ring of full/empty mbarriers, 128-byte
//    swizzle, zero fill past n or kv. In K3 the producer warp also puts the
//    tile's 64 lse and delta values into the stage with plain loads, and
//    each of its 32 lanes arrives on the full barrier after its stores;
//  * each consumer warpgroup runs the two score products as SS wgmma
//    (m64n64k16, both operands K-major): K2 S = Q K^T and dP = dO V^T, K3
//    S^T = K Q^T and dP^T = V dO^T. P and dS are computed on the fp32
//    accumulators in registers, repacked to bf16 A registers, and fed to
//    the RS wgmma that accumulates the gradients with the streamed tile read
//    MN-major (the transpose bit): K2 dQ += dS K, K3 dV += P^T dO and
//    dK += dS^T Q. The one swizzled tile serves as a K-major B and as an
//    MN-major B. No score, probability or gradient tile passes through
//    shared memory;
//  * dQ, dK and dV stay in fp32 registers across the whole loop and are
//    stored once, as bf16 pairs; rows past n or kv are not stored.
//  * head dim 256 (2 x 256-wide heads): the tiles stay 64 rows (K2 195 KB
//    of shared memory, K3 211 KB). K2's dQ takes 128 registers a thread
//    beside S and dP (32 each), within one warpgroup's 255. K3's dK and dV
//    would take 256, so K3 runs two consumer warpgroups, one gradient each,
//    with P handed from the dV warpgroup to the dK warpgroup in fp32
//    through shared memory (flash_bwd_dkv_bf16 says how).
//  * past head dim 256 (either dtype): a block owns a 256-column chunk of
//    its gradients, and S and dP stream all four operands in 64-column
//    slices (flash_bwd_dq_bf16_wide says how); no atomics across chunks.
// fp32, the duration predictor's training (batch 8 x 8 heads, 128 rows and
// keys, head dim 64): K2 does 403 MFLOP over ~10 MB and K3 537 MFLOP over
// ~12 MB, above the card's fp32 ridge (67 TFLOP/s over 3.35 TB/s, 20
// FLOP per byte), so its CUDA cores bound them (6.0 and 8.0 us). wgmma has
// no fp32 mode and TF32 would break the fp32 contract that the card-vs-CPU
// checks hold the trainer to, so all four products stay on FMAs, and what
// the design does is feed them (as K1's fp32 path does):
//  * register micro-tiles: a thread owns 4 owned rows x STR / 16 streamed
//    rows of S and dP, and 4 owned rows x D / 16 columns of the gradients,
//    and reads its operands as 16-byte vectors from tiles whose rows are
//    padded by 16 bytes; a warp is 4 row groups x 8 streamed rows, so each
//    read is one wavefront shared by 4 or 8 lanes. S and dP sum along d one
//    FMA after another, as the plain product does;
//  * P and dS go through shared memory once, transposed (one row per
//    streamed row, one column per owned row), so that the second products
//    read 4 owned rows as one vector; the two warps of a row group sync on
//    a named barrier, not the block;
//  * the gradients stay in registers across the whole streamed loop and are
//    stored once: each block owns its rows and sums in a fixed order (no
//    atomics, no zeroing pass, the same bits on every launch);
//  * the owned tiles arrive once by cp.async, the streamed ones through two
//    stages, the next tile's copies in flight while this one computes (one
//    block barrier a tile), rows past n or kv zero-filled; K3 reads each
//    tile's lse and delta, K2 its key flags, into registers before the
//    products, which hide their latency;
//  * blocks of 64 owned rows (256 threads), streamed tiles of 64 rows at
//    d <= 64, 32 at d = 128 and 16 at d = 256 (F32Tile says why). Head dims
//    16 and 32 (fp32 only, the narrow heads of small models) run the same
//    code: a thread's D / 16 gradient columns are 1 or 2 neighbouring floats
//    (F32Cols), nothing is padded to 64 columns.
// Both launch on the caller's stream and allocate nothing; the host encodes
// the four tensor maps of a bf16 launch on each call.

#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kMaskFill = -0.7f * 3.402823466e38f;
constexpr float kEmptyRowLse = 0.5f * kMaskFill;  // below: every key was masked
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ fp32: layout

// A block of 4 OWN threads owns OWN rows (K2: query rows, K3: keys) and
// streams the other side in tiles of STR rows. Thread (ty, tx), ty <
// OWN / 4, tx < 16, owns rows ty + (OWN / 4) i (i < 4) of the block's rows;
// of each streamed tile, rows tx + 16 c (c < STR / 16); of the gradients,
// the D / 16 columns F32Cols<D> gives tx (4 at 64 g + 4 tx at d = 64 and
// 128, 2 at 2 tx at d = 32, tx at d = 16). A warp holds 4 ty x 8 tx, so
// that a 16-byte read of an owned row is shared by 8 lanes and one of a
// streamed row by 4, and each reads one 128-byte wavefront from shared
// memory: rows of D + 4 floats put the 8 streamed rows' 16-byte reads in
// distinct banks at every D of 16 to 256 (row starts 20, 36, 68, 132 or 260
// floats apart cover all 32 banks once over 8 rows).
// OWN is 64; STR is 64 at d <= 64, 32 at d = 128, where 64 streamed rows
// would take 238 KB of K3's shared memory, past the 227 KB a block can have,
// and 16 at d = 256, where 32 would take 277 KB (16 take 204 KB; at d = 32 a
// block takes 90 KB).
template <int D>
struct F32Tile {
  static constexpr int OWN = 64;
  static constexpr int STR = D == 256 ? 16 : D == 128 ? 32 : 64;
  static constexpr int kThreads = 4 * OWN;
  static constexpr int kTy = OWN / 4;       // row groups
  static constexpr int kNc = STR / 16;      // streamed rows of a thread
  static constexpr int kLd = D + 4;         // operand rows, padded (cp_async_rows)
  static constexpr int kLdT = OWN + 4;      // rows of P^T and dS^T, padded
  // shared memory in floats: the two owned tiles (K2: Q, dO; K3: K, V), two
  // stages of the two streamed tiles (K2: K, V; K3: Q, dO), then dS^T (and
  // in K3 P^T), one row per streamed row, one column per owned row
  static constexpr int kOwnA = 0;
  static constexpr int kOwnB = kOwnA + OWN * kLd;
  static constexpr int kStage = 2 * STR * kLd;
  static constexpr int kStages = kOwnB + OWN * kLd;
  static constexpr int kT = kStages + 2 * kStage;
  static constexpr int kTile = STR * kLdT;
  static constexpr int kBytesDq = (kT + kTile) * 4;
  static constexpr int kBytesDkv = (kT + 2 * kTile) * 4;
};

// the thread's (ty, tx): a warp is 4 row groups x 8 streamed rows, two
// warps cover the 16 tx of one 4 row groups
__device__ __forceinline__ int f32_ty() { return 4 * (threadIdx.x / 64) + threadIdx.x % 32 / 8; }
__device__ __forceinline__ int f32_tx() { return 8 * (threadIdx.x / 32 % 2) + threadIdx.x % 8; }

// acc[i][c] += own row (ty + 16 i) . streamed row (tx + 16 c) over COLS
// columns of tiles whose rows lie ld floats apart, one FMA after another
// along d, the order of the plain version's fp32 product (at logits of ~1e3
// another order moves them by ulps, and exp by as much)
template <int NC, int COLS>
__device__ __forceinline__ void f32_dot(float (&acc)[4][NC], const float* own, const float* str,
                                        int ld, int ty, int tx) {
#pragma unroll
  for (int d = 0; d < COLS; d += 4) {
    float4 b[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      b[c] = *reinterpret_cast<const float4*>(str + (tx + 16 * c) * ld + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(own + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c] = fmaf(a.w, b[c].w, fmaf(a.z, b[c].z, fmaf(a.y, b[c].y,
                                                             fmaf(a.x, b[c].x, acc[i][c]))));
      }
    }
  }
}

// acc[i][c] = own row (ty + kTy i) . streamed row (tx + 16 c) over D
template <int D, int NC>
__device__ __forceinline__ void f32_scores(float (&acc)[4][NC], const float* own,
                                           const float* str, int ty, int tx) {
  static_assert(F32Tile<D>::kTy == 16, "f32_dot's row groups");
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  f32_dot<NC, D>(acc, own, str, F32Tile<D>::kLd, ty, tx);
}

// a thread's gradient: 4 owned rows x its F32Cols<D> columns
template <int D>
using F32Acc = float[4][F32Cols<D>::G][F32Cols<D>::W];

// acc[i][g][e] += sum over streamed rows r < rows (rounded up to 16; the
// rows past it hold zeros in both operands) of t[r][4 ty + i] *
// op[r][F32Cols<D>::col(g, tx) + e]: t is P^T or dS^T, whose column 4 ty +
// i is owned row ty + kTy i, and op the streamed operand (K2: K; K3: dO or
// Q)
template <int D>
__device__ __forceinline__ void f32_accumulate(F32Acc<D>& acc, const float* t, const float* op,
                                               int rows, int ty, int tx) {
  using C = F32Cols<D>;
  constexpr int kLd = F32Tile<D>::kLd, kLdT = F32Tile<D>::kLdT;
  for (int r0 = 0; r0 < rows; r0 += 16) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int r = r0 + u;
      const float4 a = *reinterpret_cast<const float4*>(t + r * kLdT + 4 * ty);
      const float ai[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < C::G; ++g) {
        float b[C::W];
        ld_f32<C::W>(b, op + r * kLd + C::col(g, tx));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < C::W; ++e) acc[i][g][e] = fmaf(ai[i], b[e], acc[i][g][e]);
        }
      }
    }
  }
}

// rows ty + kTy i of a gradient into out rows [row0, ...) of an (n_rows,
// ld) matrix at columns col0 + F32Cols<D>::col(g, tx), once; rows past
// n_rows and columns past n_cols are not stored
template <int D>
__device__ __forceinline__ void f32_store(const F32Acc<D>& acc, float* __restrict__ out, int ld,
                                          int col0, int n_cols, int row0, int n_rows, int ty,
                                          int tx) {
  using C = F32Cols<D>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + F32Tile<D>::kTy * i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int g = 0; g < C::G; ++g) {
      if (col0 + C::col(g, 0) >= n_cols) break;
      st_f32<C::W>(out + (size_t)row * ld + col0 + C::col(g, tx), acc[i][g]);
    }
  }
}

template <int D>
__device__ __forceinline__ void f32_zero(F32Acc<D>& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int g = 0; g < F32Cols<D>::G; ++g) {
#pragma unroll
      for (int e = 0; e < F32Cols<D>::W; ++e) acc[i][g][e] = 0.0f;
    }
  }
}

// p = exp(s scale - lse) and ds = p (dp - delta) scale, each product and
// difference rounded as the plain version rounds it
__device__ __forceinline__ float f32_prob(float s, float scale, float lse) {
  return expf(__fsub_rn(__fmul_rn(s, scale), lse));
}
__device__ __forceinline__ float f32_ds(float p, float dp, float delta, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

// K2: dS^T of a streamed tile into ds_t, one row per key, one column per
// owned query row (ldt floats a row): kept keys (the thread's, `kept`) of
// live rows, 0 elsewhere (a select, never exp(.) * 0)
template <int NC>
__device__ __forceinline__ void f32_ds_tile(float* ds_t, int ldt, const float (&s)[4][NC],
                                            const float (&dp)[4][NC], const bool (&live)[4],
                                            const float (&lse_r)[4], const float (&delta_r)[4],
                                            const bool (&kept)[NC], int ty, int tx,
                                            float scale) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float ds[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ds[i] = live[i] && kept[c]
                  ? f32_ds(f32_prob(s[i][c], scale, lse_r[i]), dp[i][c], delta_r[i], scale)
                  : 0.0f;
    }
    *reinterpret_cast<float4*>(ds_t + (tx + 16 * c) * ldt + 4 * ty) =
        make_float4(ds[0], ds[1], ds[2], ds[3]);
  }
}

// K3: P^T and dS^T of a streamed tile into p_t and ds_t (ldt floats a row):
// p = exp(s scale - lse) on kept keys of rows that have one, 1 / kv on
// every real key of a fully-masked row, 0 elsewhere; ds 0 but on kept keys
// of rows that have one
template <int NC>
__device__ __forceinline__ void f32_pt_tile(float* p_t, float* ds_t, int ldt,
                                            const float (&st)[4][NC], const float (&dpt)[4][NC],
                                            const bool (&valid)[NC], const float (&lse_c)[NC],
                                            const float (&delta_c)[NC], const bool (&real)[4],
                                            const bool (&kept)[4], int ty, int tx, float inv_kv,
                                            float scale) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const bool empty = lse_c[c] < kEmptyRowLse;
    float p[4], ds[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool keep = valid[c] && !empty && kept[i];
      p[i] = keep ? f32_prob(st[i][c], scale, lse_c[c])
                  : (valid[c] && empty && real[i] ? inv_kv : 0.0f);
      ds[i] = keep ? f32_ds(p[i], dpt[i][c], delta_c[c], scale) : 0.0f;
    }
    const int at = (tx + 16 * c) * ldt + 4 * ty;
    *reinterpret_cast<float4*>(p_t + at) = make_float4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<float4*>(ds_t + at) = make_float4(ds[0], ds[1], ds[2], ds[3]);
  }
}

// ------------------------------------------------------------ fp32: K2

// grid (query tiles of OWN rows, heads, batch). q, dout, dq (b, h, n_q, D);
// k, v (b, h, n_kv, D); mask (b, n_kv) bytes or null; lse, delta (b, h,
// n_q) fp32. The owned Q and dO arrive once; K and V stream through two
// stages, the next tile's cp.async in flight while this one computes.
template <int D>
__global__ void __launch_bounds__(F32Tile<D>::kThreads, 1)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const uint8_t* __restrict__ mask,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq, int heads,
                     int n_q, int n_kv, float scale) {
  using L = F32Tile<D>;
  constexpr int OWN = L::OWN, STR = L::STR, TY = L::kTy, NC = L::kNc;
  extern __shared__ float4 smem_f32[];
  float* sm = reinterpret_cast<float*>(smem_f32);
  const float* q_s = sm + L::kOwnA;
  const float* do_s = sm + L::kOwnB;
  float* ds_t = sm + L::kT;

  const int ty = f32_ty(), tx = f32_tx();
  const int q0 = blockIdx.x * OWN;
  const int batch = blockIdx.z;
  const size_t bh = (size_t)batch * heads + blockIdx.y;
  const float* k_bh = k + bh * n_kv * D;
  const float* v_bh = v + bh * n_kv * D;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)batch * n_kv;
  const int n_tiles = (n_kv + STR - 1) / STR;

  cp_async_rows<D, OWN, L::kThreads>(sm + L::kOwnA, q + bh * n_q * D, q0, n_q);
  cp_async_rows<D, OWN, L::kThreads>(sm + L::kOwnB, dout + bh * n_q * D, q0, n_q);
  cp_async_rows<D, STR, L::kThreads>(sm + L::kStages, k_bh, 0, n_kv);
  cp_async_rows<D, STR, L::kThreads>(sm + L::kStages + STR * L::kLd, v_bh, 0, n_kv);
  cp_async_commit();

  // the thread's owned rows: lse, delta; rows past n and fully-masked rows
  // (uniform p, ds = 0) take no part in dQ
  float lse_r[4], delta_r[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + TY * i;
    const bool valid = row < n_q;
    lse_r[i] = valid ? lse[bh * n_q + row] : 0.0f;
    delta_r[i] = valid ? delta[bh * n_q + row] : 0.0f;
    live[i] = valid && !(lse_r[i] < kEmptyRowLse);
  }
  F32Acc<D> acc;
  f32_zero<D>(acc);

  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed, and every thread is done with tile t - 1, whose
    // stage and dS^T are refilled next
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) {
      float* next = sm + L::kStages + ((t + 1) & 1) * L::kStage;
      cp_async_rows<D, STR, L::kThreads>(next, k_bh, (t + 1) * STR, n_kv);
      cp_async_rows<D, STR, L::kThreads>(next + STR * L::kLd, v_bh, (t + 1) * STR, n_kv);
      cp_async_commit();
    }
    const float* k_s = sm + L::kStages + (t & 1) * L::kStage;
    const float* v_s = k_s + STR * L::kLd;
    const int k0 = t * STR;
    bool kept[NC];  // a real, unmasked key: loaded now, first read after the products
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int key = k0 + tx + 16 * c;
      kept[c] = key < n_kv && (mask_b == nullptr || mask_b[key]);
    }

    float s[4][NC], dp[4][NC];
    f32_scores<D>(s, q_s, k_s, ty, tx);    // S = Q K^T
    f32_scores<D>(dp, do_s, v_s, ty, tx);  // dP = dO V^T

    f32_ds_tile(ds_t, L::kLdT, s, dp, live, lse_r, delta_r, kept, ty, tx, scale);
    // the 16 tx of these row groups are this warp and its neighbour
    named_bar_sync(1 + threadIdx.x / 64, 64);

    f32_accumulate<D>(acc, ds_t, k_s, min(STR, n_kv - k0), ty, tx);  // dQ += dS K
  }
  f32_store<D>(acc, dq + bh * n_q * D, D, 0, D, q0, n_q, ty, tx);
}

// ------------------------------------------------------------ fp32: K3

// grid (key tiles of OWN keys, heads, batch); the same operands, dk and dv
// (b, h, n_kv, D). The owned K and V arrive once; Q and dO stream through
// two stages; each tile's query rows' lse and delta are read into
// registers before the products that hide their latency.
template <int D>
__global__ void __launch_bounds__(F32Tile<D>::kThreads, 1)
    flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const uint8_t* __restrict__ mask,
                      const float* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int heads, int n_q, int n_kv, float scale) {
  using L = F32Tile<D>;
  constexpr int OWN = L::OWN, STR = L::STR, TY = L::kTy, NC = L::kNc;
  extern __shared__ float4 smem_f32[];
  float* sm = reinterpret_cast<float*>(smem_f32);
  const float* k_s = sm + L::kOwnA;
  const float* v_s = sm + L::kOwnB;
  float* p_t = sm + L::kT;
  float* ds_t = p_t + L::kTile;

  const int ty = f32_ty(), tx = f32_tx();
  const int k0 = blockIdx.x * OWN;
  const int batch = blockIdx.z;
  const size_t bh = (size_t)batch * heads + blockIdx.y;
  const float* q_bh = q + bh * n_q * D;
  const float* do_bh = dout + bh * n_q * D;
  const float* lse_bh = lse + bh * n_q;
  const float* delta_bh = delta + bh * n_q;
  const int n_tiles = (n_q + STR - 1) / STR;
  const float inv_kv = 1.0f / (float)n_kv;

  cp_async_rows<D, OWN, L::kThreads>(sm + L::kOwnA, k + bh * n_kv * D, k0, n_kv);
  cp_async_rows<D, OWN, L::kThreads>(sm + L::kOwnB, v + bh * n_kv * D, k0, n_kv);
  cp_async_rows<D, STR, L::kThreads>(sm + L::kStages, q_bh, 0, n_q);
  cp_async_rows<D, STR, L::kThreads>(sm + L::kStages + STR * L::kLd, do_bh, 0, n_q);
  cp_async_commit();

  bool real[4], kept[4];  // the thread's owned keys
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + TY * i;
    real[i] = key < n_kv;
    kept[i] = real[i] && (mask == nullptr || mask[(size_t)batch * n_kv + key]);
  }
  F32Acc<D> dk_acc, dv_acc;
  f32_zero<D>(dk_acc);
  f32_zero<D>(dv_acc);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();  // as in K2
    __syncthreads();
    if (t + 1 < n_tiles) {
      float* next = sm + L::kStages + ((t + 1) & 1) * L::kStage;
      cp_async_rows<D, STR, L::kThreads>(next, q_bh, (t + 1) * STR, n_q);
      cp_async_rows<D, STR, L::kThreads>(next + STR * L::kLd, do_bh, (t + 1) * STR, n_q);
      cp_async_commit();
    }
    const float* q_s = sm + L::kStages + (t & 1) * L::kStage;
    const float* do_s = q_s + STR * L::kLd;
    const int q0 = t * STR;
    float lse_c[NC], delta_c[NC];
    bool valid[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int row = q0 + tx + 16 * c;
      valid[c] = row < n_q;
      lse_c[c] = valid[c] ? lse_bh[row] : 0.0f;
      delta_c[c] = valid[c] ? delta_bh[row] : 0.0f;
    }

    float st[4][NC], dpt[4][NC];
    f32_scores<D>(st, k_s, q_s, ty, tx);    // S^T = K Q^T
    f32_scores<D>(dpt, v_s, do_s, ty, tx);  // dP^T = V dO^T

    // P^T and dS^T (ds = 0 on a fully-masked row)
    f32_pt_tile(p_t, ds_t, L::kLdT, st, dpt, valid, lse_c, delta_c, real, kept, ty, tx, inv_kv,
                scale);
    named_bar_sync(1 + threadIdx.x / 64, 64);  // as in K2

    const int rows = min(STR, n_q - q0);
    f32_accumulate<D>(dv_acc, p_t, do_s, rows, ty, tx);  // dV += P^T dO
    f32_accumulate<D>(dk_acc, ds_t, q_s, rows, ty, tx);  // dK += dS^T Q
  }
  f32_store<D>(dk_acc, dk + bh * n_kv * D, D, 0, D, k0, n_kv, ty, tx);
  f32_store<D>(dv_acc, dv + bh * n_kv * D, D, 0, D, k0, n_kv, ty, tx);
}

// ------------------------------------------------ fp32: head dims past 256

// As the bf16 chunked kernels below (flash_bwd_dq_bf16_wide says why): a
// block owns a 256-column chunk of its 64 rows' gradients (K2: dQ; K3: dK
// and dV; F32Cols<256>'s 64 registers a gradient, as at d = 256), and the
// scores S and dP, sums over the whole d, come from both sides' operands
// streamed in 64-column slices, still one FMA after another along d. The
// loads are one stream of items: for each streamed tile of 32 rows, its d /
// 64 slices (the owned rows' and the tile's, of both operand pairs), then
// the tile's chunk of the operands that the gradients take (K2: K; K3: Q
// and dO); cp.async keeps two items in flight in K2 (three slice buffers:
// 194 KB of shared memory) and one in K3 (two: 184 KB), at every d.
constexpr int kWideCols = 256;  // gradient columns a block owns
constexpr int kSliceCols = 64;  // columns of a streamed slice

struct F32Wide {
  static constexpr int OWN = 64, STR = 32, kNc = STR / 16, kThreads = 4 * OWN;
  static constexpr int kLdS = kSliceCols + 4;
  static constexpr int kLdC = kWideCols + 4;  // F32Tile<256>::kLd: f32_accumulate<256>'s
  static constexpr int kLdT = OWN + 4;        // F32Tile<256>::kLdT
  // a stage: the owned rows' slices of two operands (K2: Q, dO; K3: K, V),
  // then the streamed tile's (K2: K, V; K3: Q, dO)
  static constexpr int kOwnB = OWN * kLdS;
  static constexpr int kStrA = 2 * OWN * kLdS;
  static constexpr int kStrB = kStrA + STR * kLdS;
  static constexpr int kStage = 2 * (OWN + STR) * kLdS;
  static constexpr int kChunk = STR * kLdC;
  static constexpr int kTile = STR * kLdT;
  static constexpr int kStagesDq = 3;  // then K's chunk and dS^T
  static constexpr int kBytesDq = (kStagesDq * kStage + kChunk + kTile) * 4;
  static constexpr int kStagesDkv = 2;  // then Q's and dO's chunks, P^T and dS^T
  static constexpr int kBytesDkv = (kStagesDkv * kStage + 2 * kChunk + 2 * kTile) * 4;
};
static_assert(F32Wide::kLdC == F32Tile<kWideCols>::kLd && F32Wide::kLdT == F32Tile<kWideCols>::kLdT,
              "the chunk tiles are laid out as f32_accumulate<256> reads them");

// slice `r` (columns r kSliceCols ...) of rows [own0, own0 + OWN) of own_a and
// own_b and of rows [str0, str0 + STR) of str_a and str_b into a stage
__device__ __forceinline__ void f32_wide_slices(float* st, const float* own_a, const float* own_b,
                                                int n_own, int own0, const float* str_a,
                                                const float* str_b, int n_str, int str0, int d,
                                                int r) {
  using L = F32Wide;
  const int c0 = r * kSliceCols;
  cp_async_window<L::OWN, kSliceCols, L::kThreads>(st, own_a, n_own, d, own0, c0);
  cp_async_window<L::OWN, kSliceCols, L::kThreads>(st + L::kOwnB, own_b, n_own, d, own0, c0);
  cp_async_window<L::STR, kSliceCols, L::kThreads>(st + L::kStrA, str_a, n_str, d, str0, c0);
  cp_async_window<L::STR, kSliceCols, L::kThreads>(st + L::kStrB, str_b, n_str, d, str0, c0);
}

// grid (query tiles of OWN rows x chunks of 256 columns, heads, batch); the
// operands as flash_bwd_dq_f32's at head dim d
__global__ void __launch_bounds__(F32Wide::kThreads, 1)
    flash_bwd_dq_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const uint8_t* __restrict__ mask,
                          const float* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ dq, int heads,
                          int n_q, int n_kv, int d, float scale) {
  using L = F32Wide;
  constexpr int OWN = L::OWN, STR = L::STR, NC = L::kNc, NS = L::kStagesDq;
  extern __shared__ float4 smem_f32[];
  float* sm = reinterpret_cast<float*>(smem_f32);
  float* kc_s = sm + NS * L::kStage;
  float* ds_t = kc_s + L::kChunk;

  const int ty = f32_ty(), tx = f32_tx();
  const int n_chunks = (d + kWideCols - 1) / kWideCols;
  const int chunk = blockIdx.x % n_chunks;
  const int q0 = blockIdx.x / n_chunks * OWN;
  const int col0 = chunk * kWideCols;
  const int batch = blockIdx.z;
  const size_t bh = (size_t)batch * heads + blockIdx.y;
  const float* q_bh = q + bh * n_q * d;
  const float* do_bh = dout + bh * n_q * d;
  const float* k_bh = k + bh * n_kv * d;
  const float* v_bh = v + bh * n_kv * d;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)batch * n_kv;
  const int slices = d / kSliceCols;
  const int per_tile = slices + 1;
  const int items = (n_kv + STR - 1) / STR * per_tile;

  // item i: of key tile i / per_tile, slice i % per_tile or, last, K's
  // chunk; past the last item an empty group, so that every iteration
  // waits alike
  auto fetch = [&](int i) {
    if (i < items) {
      const int t = i / per_tile, r = i % per_tile;
      if (r < slices) {
        f32_wide_slices(sm + (t * slices + r) % NS * L::kStage, q_bh, do_bh, n_q, q0, k_bh,
                        v_bh, n_kv, t * STR, d, r);
      } else {
        cp_async_window<STR, kWideCols, L::kThreads>(kc_s, k_bh, n_kv, d, t * STR, col0);
      }
    }
    cp_async_commit();
  };

  // the thread's owned rows, as in flash_bwd_dq_f32
  float lse_r[4], delta_r[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool valid = row < n_q;
    lse_r[i] = valid ? lse[bh * n_q + row] : 0.0f;
    delta_r[i] = valid ? delta[bh * n_q + row] : 0.0f;
    live[i] = valid && !(lse_r[i] < kEmptyRowLse);
  }
  F32Acc<kWideCols> acc;
  f32_zero<kWideCols>(acc);
  float s[4][NC], dp[4][NC];
  bool kept[NC];

  fetch(0);
  fetch(1);
  for (int i = 0; i < items; ++i) {
    cp_async_wait<1>();  // item i has landed
    __syncthreads();     // for every thread, and every thread is done with item i - 1
    fetch(i + 2);        // into buffers no thread reads any more
    const int t = i / per_tile, r = i % per_tile;
    const int k0 = t * STR;
    if (r < slices) {
      if (r == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < NC; ++c) s[j][c] = dp[j][c] = 0.0f;
        }
        // the tile's key flags, read long before their use
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int key = k0 + tx + 16 * c;
          kept[c] = key < n_kv && (mask_b == nullptr || mask_b[key]);
        }
      }
      const float* st = sm + (t * slices + r) % NS * L::kStage;
      f32_dot<NC, kSliceCols>(s, st, st + L::kStrA, L::kLdS, ty, tx);              // S = Q K^T
      f32_dot<NC, kSliceCols>(dp, st + L::kOwnB, st + L::kStrB, L::kLdS, ty, tx);  // dP = dO V^T
      if (r == slices - 1) {
        f32_ds_tile(ds_t, L::kLdT, s, dp, live, lse_r, delta_r, kept, ty, tx, scale);
      }
    } else {
      f32_accumulate<kWideCols>(acc, ds_t, kc_s, min(STR, n_kv - k0), ty, tx);  // dQ += dS K
    }
  }
  f32_store<kWideCols>(acc, dq + bh * n_q * d, d, col0, d, q0, n_q, ty, tx);
}

// grid (key tiles of OWN keys x chunks of 256 columns, heads, batch); the
// operands as flash_bwd_dkv_f32's at head dim d
__global__ void __launch_bounds__(F32Wide::kThreads, 1)
    flash_bwd_dkv_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const uint8_t* __restrict__ mask,
                           const float* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ delta, float* __restrict__ dk,
                           float* __restrict__ dv, int heads, int n_q, int n_kv, int d,
                           float scale) {
  using L = F32Wide;
  constexpr int OWN = L::OWN, STR = L::STR, NC = L::kNc, NS = L::kStagesDkv;
  extern __shared__ float4 smem_f32[];
  float* sm = reinterpret_cast<float*>(smem_f32);
  float* qc_s = sm + NS * L::kStage;
  float* doc_s = qc_s + L::kChunk;
  float* p_t = doc_s + L::kChunk;
  float* ds_t = p_t + L::kTile;

  const int ty = f32_ty(), tx = f32_tx();
  const int n_chunks = (d + kWideCols - 1) / kWideCols;
  const int chunk = blockIdx.x % n_chunks;
  const int k0 = blockIdx.x / n_chunks * OWN;
  const int col0 = chunk * kWideCols;
  const int batch = blockIdx.z;
  const size_t bh = (size_t)batch * heads + blockIdx.y;
  const float* q_bh = q + bh * n_q * d;
  const float* do_bh = dout + bh * n_q * d;
  const float* k_bh = k + bh * n_kv * d;
  const float* v_bh = v + bh * n_kv * d;
  const float* lse_bh = lse + bh * n_q;
  const float* delta_bh = delta + bh * n_q;
  const float inv_kv = 1.0f / (float)n_kv;
  const int slices = d / kSliceCols;
  const int per_tile = slices + 1;
  const int items = (n_q + STR - 1) / STR * per_tile;

  // item i: of query tile i / per_tile, slice i % per_tile or, last, Q's
  // and dO's chunks; one item in flight while one computes
  auto fetch = [&](int i) {
    if (i < items) {
      const int t = i / per_tile, r = i % per_tile;
      if (r < slices) {
        f32_wide_slices(sm + (t * slices + r) % NS * L::kStage, k_bh, v_bh, n_kv, k0, q_bh,
                        do_bh, n_q, t * STR, d, r);
      } else {
        cp_async_window<STR, kWideCols, L::kThreads>(qc_s, q_bh, n_q, d, t * STR, col0);
        cp_async_window<STR, kWideCols, L::kThreads>(doc_s, do_bh, n_q, d, t * STR, col0);
      }
    }
    cp_async_commit();
  };

  bool real[4], kept[4];  // the thread's owned keys
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    real[i] = key < n_kv;
    kept[i] = real[i] && (mask == nullptr || mask[(size_t)batch * n_kv + key]);
  }
  F32Acc<kWideCols> dk_acc, dv_acc;
  f32_zero<kWideCols>(dk_acc);
  f32_zero<kWideCols>(dv_acc);
  float st_[4][NC], dpt[4][NC], lse_c[NC], delta_c[NC];
  bool valid[NC];

  fetch(0);
  for (int i = 0; i < items; ++i) {
    cp_async_wait<0>();  // item i has landed
    __syncthreads();     // for every thread, and every thread is done with item i - 1
    fetch(i + 1);
    const int t = i / per_tile, r = i % per_tile;
    const int q0 = t * STR;
    if (r < slices) {
      if (r == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < NC; ++c) st_[j][c] = dpt[j][c] = 0.0f;
        }
        // the tile's query rows' lse and delta, read long before their use
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int row = q0 + tx + 16 * c;
          valid[c] = row < n_q;
          lse_c[c] = valid[c] ? lse_bh[row] : 0.0f;
          delta_c[c] = valid[c] ? delta_bh[row] : 0.0f;
        }
      }
      const float* st = sm + (t * slices + r) % NS * L::kStage;
      f32_dot<NC, kSliceCols>(st_, st, st + L::kStrA, L::kLdS, ty, tx);              // S^T = K Q^T
      f32_dot<NC, kSliceCols>(dpt, st + L::kOwnB, st + L::kStrB, L::kLdS, ty, tx);  // dP^T = V dO^T
      if (r == slices - 1) {
        f32_pt_tile(p_t, ds_t, L::kLdT, st_, dpt, valid, lse_c, delta_c, real, kept, ty, tx,
                    inv_kv, scale);
      }
    } else {
      const int rows = min(STR, n_q - q0);
      f32_accumulate<kWideCols>(dv_acc, p_t, doc_s, rows, ty, tx);  // dV += P^T dO
      f32_accumulate<kWideCols>(dk_acc, ds_t, qc_s, rows, ty, tx);  // dK += dS^T Q
    }
  }
  f32_store<kWideCols>(dk_acc, dk + bh * n_kv * d, d, col0, d, k0, n_kv, ty, tx);
  f32_store<kWideCols>(dv_acc, dv + bh * n_kv * d, d, col0, d, k0, n_kv, ty, tx);
}

// ------------------------------------------------------------ bf16: layout

constexpr int kRows = 64;    // rows of every tile, owned or streamed
constexpr int kStages = 2;   // ring depth

// consumer warpgroups of K3: one up to head dim 128; two at 256, where dK
// and dV (64 x 256 fp32 each) would take 256 registers a thread of one. K2
// has one at every head dim. With one consumer warpgroup the loads come from
// one producer warp; with two, from a whole producer warpgroup (one warp of
// it works), whose registers pay for the consumers' 240 (setmaxnreg): ptxas
// gives a block of wgmma warpgroups 65536 / (threads rounded up to 128)
// registers a thread, which at 288 threads is 168 and spills.
template <int D>
struct K3Shape {
  static constexpr int kWarpgroups = D == 256 ? 2 : 1;
  static constexpr int kThreads = 128 * kWarpgroups + (kWarpgroups == 2 ? 128 : 32);
};
constexpr int kThreadsDq = 128 + 32;
// named barriers of K3's hand-off of P between its two warpgroups (0 is
// __syncthreads()'s)
constexpr int kBarPFull = 1;
constexpr int kBarPEmpty = 2;

// Shared memory in bytes, at a 1024-byte aligned base. Each 64-row operand
// tile is stored as D / 64 column chunks of (64 x 64) bf16, 128 bytes a row,
// in TMA's 128-byte swizzle: the two owned tiles (K2: Q, dO; K3: K, V), then
// kStages stages, each a streamed pair (K2: K, V; K3: Q, dO) and, in K3, the
// pair's 64 lse and 64 delta values.
template <int D>
struct Bf16Smem {
  static constexpr int kChunks = D / kSwizzleCols;
  static constexpr int kChunk = kRows * 128;
  static constexpr int kTile = kChunks * kChunk;
  static constexpr int kRowState = 1024;  // lse, delta: 2 x 64 floats, padded
  static constexpr int kStage = 2 * kTile + kRowState;
  static constexpr int kRing = 2 * kTile;  // after the owned pair
  static constexpr int kBytes = kRing + kStages * kStage;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
  // K3 with two warpgroups: after the ring, one tile of P in fp32 (64 x 64,
  // element e of thread t at e * 128 + t), from the dV warpgroup to the dK
  // warpgroup: 211 KB in all at d = 256
  static constexpr int kPx = kBytes;
  static constexpr int kAllocDkv =
      kBytes + (K3Shape<D>::kWarpgroups == 2 ? 64 * 64 * 4 : 0) + 1024;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// 64 x 64 scores: acc = A (the 64 owned rows, K-major) times B^T (a
// streamed 64-row tile, K-major), over D in steps of 16
template <int D>
__device__ __forceinline__ void scores(float (&acc)[32], uint32_t a_base, uint32_t b_base) {
  using L = Bf16Smem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 32 bytes along a 128-byte row
    wgmma_ss_n64(acc, sw128_desc(a_base + (kk / 4) * L::kChunk + off, 16, 1024),
                 sw128_desc(b_base + (kk / 4) * L::kChunk + off, 16, 1024), kk > 0);
  }
}

// acc (64 x D) += A (64 x 64, bf16 registers) times a streamed 64-row tile
// read MN-major, in steps of 16 of its rows
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                           uint32_t b_base) {
  using L = Bf16Smem<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<D>(acc, a[kk], sw128_desc(b_base + kk * 16 * 128, L::kChunk, 1024));
  }
}

// a 64 x 64 fp32 accumulator as four bf16 A operands of 16 columns each: the
// accumulator layout is the A-register layout
__device__ __forceinline__ void repack(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
  }
}

// rows r and r + 8 of the warpgroup's 64 x D accumulator (this thread's part)
// into out (n_rows rows of ld elements) at columns col0 ... as bf16 pairs;
// rows past n_rows and columns past n_cols are not stored
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], bf16* __restrict__ out,
                                           int ld, int col0, int n_cols, int r, int quad,
                                           int n_rows) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (r + 8 * j >= n_rows) continue;
    bf16* dst = out + (size_t)(r + 8 * j) * ld + col0 + 2 * quad;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      if (col0 + 8 * i >= n_cols) break;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2 * j], acc[4 * i + 2 * j + 1]);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p of one element from its unscaled logit s, with scale_l2 = scale log2(e)
// and lse_l2 = lse log2(e) (-inf on a fully-masked row: the fill overflows,
// but no such row reaches the exp). keep: a real, unmasked key of a valid
// row that has one; uniform: a real key of a fully-masked row
__device__ __forceinline__ float prob(float s, float scale_l2, float lse_l2, bool keep,
                                      bool uniform, float inv_kv) {
  return keep ? ex2(fmaf(s, scale_l2, -lse_l2)) : (uniform ? inv_kv : 0.0f);
}

// K2: dS = P (dP - delta) scale in place of dP, on kept keys (k0 ...) of
// live rows, 0 elsewhere; sc holds S, this thread's rows r and r + 8 in
// wgmma's accumulator layout (element [4 i + 2 j + c]: row j, key 8 i + 2
// quad + c)
__device__ __forceinline__ void ds_rows(const float (&sc)[32], float (&dp)[32], int k0, int n_kv,
                                        const uint8_t* mask_b, int quad, const bool (&live)[2],
                                        const float (&lse_r)[2], const float (&delta_r)[2],
                                        float scale_l2, float scale) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = k0 + 8 * i + 2 * quad + c;
      const bool kept = key < n_kv && (mask_b == nullptr || mask_b[key]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * i + 2 * j + c;
        const bool keep = kept && live[j];
        const float p = prob(sc[e], scale_l2, lse_r[j], keep, false, 0.0f);
        dp[e] = keep ? p * (dp[e] - delta_r[j]) * scale : 0.0f;
      }
    }
  }
}

// K3's two warpgroups: P^T in place of S^T (warpgroup 0), then dS^T = P^T
// (dP^T - delta) scale in place of dP^T from warpgroup 0's P^T in p_x
// (warpgroup 1). Rows are this thread's keys r and r + 8 (real, kept);
// column 8 i + 2 quad + c is query row row0 + that, its lse (times log2 e)
// and delta in lse_s and delta_s: p = exp(s scale - lse) on kept keys of
// rows that have one, 1 / kv on every real key of a fully-masked row, 0
// elsewhere; ds 0 but on kept keys of rows that have one
__device__ __forceinline__ void pt_cols(float (&sc)[32], const float* lse_s, int row0, int n_q,
                                        int quad, const bool (&kept)[2], const bool (&real)[2],
                                        float scale_l2, float inv_kv) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * i + 2 * quad;
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float l = c ? l2.y : l2.x;
      const bool valid = row0 + col + c < n_q;
      const bool empty = l < kEmptyRowLse;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * i + 2 * j + c;
        const bool keep = valid && !empty && kept[j];
        sc[e] = prob(sc[e], scale_l2, l, keep, valid && empty && real[j], inv_kv);
      }
    }
  }
}
__device__ __forceinline__ void dst_cols(float (&sc)[32], const float* p_x, const float* lse_s,
                                         const float* delta_s, int row0, int n_q, int quad,
                                         int tid, const bool (&kept)[2], float scale) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * i + 2 * quad;
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
    const float2 d2 = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float l = c ? l2.y : l2.x;
      const float dl = c ? d2.y : d2.x;
      const bool valid = row0 + col + c < n_q;
      const bool empty = l < kEmptyRowLse;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * i + 2 * j + c;
        const bool keep = valid && !empty && kept[j];
        sc[e] = keep ? p_x[e * 128 + tid] * (sc[e] - dl) * scale : 0.0f;
      }
    }
  }
}

// ------------------------------------------------------------- bf16: K2

// grid: (query tiles of 64 rows, heads, batch). Warpgroup 0 consumes; warp 4
// issues the loads. q, dout, dq (b, h, n_q, D) and k, v (b, h, n_kv, D)
// through 3-D tensor maps (D, rows, b h); mask (b, n_kv) bytes or null; lse,
// delta (b, h, n_q) fp32. Two blocks share an SM up to d = 128 (at most 204
// registers a thread); at d = 256 the block takes 195 KB of shared memory and
// dQ alone 128 registers a thread, and one block takes the SM.
template <int D>
__global__ void __launch_bounds__(kThreadsDq, D == 256 ? 1 : 2)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq, int heads,
                      int n_q, int n_kv, float scale) {
  using L = Bf16Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ __align__(8) uint64_t own_bar;
  uint8_t* smem = align1024(smem_raw);

  const int batch = blockIdx.z;
  const int bh = batch * heads + blockIdx.y;
  const int n_tiles = (n_kv + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 128);
    }
    mbar_init(&own_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: Q and dO once, then K and V tiles through the ring
    if (threadIdx.x == 128) {
      mbar_expect_tx(&own_bar, 2 * L::kTile);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c) {
        const int row0 = blockIdx.x * kRows;
        tma_load_3d(smem + c * L::kChunk, &tm_q, &own_bar, c * kSwizzleCols, row0, bh);
        tma_load_3d(smem + L::kTile + c * L::kChunk, &tm_do, &own_bar, c * kSwizzleCols,
                    row0, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        uint8_t* stage = smem + L::kRing + s * L::kStage;
        mbar_wait(&empty_bar[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full_bar[s], 2 * L::kTile);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_3d(stage + c * L::kChunk, &tm_k, &full_bar[s], c * kSwizzleCols,
                      t * kRows, bh);
          tma_load_3d(stage + L::kTile + c * L::kChunk, &tm_v, &full_bar[s],
                      c * kSwizzleCols, t * kRows, bh);
        }
      }
    }
  } else {
    // consumer warpgroup: 64 query rows. In wgmma's accumulator layout this
    // thread owns rows r and r + 8 and, in each 8-column block i, columns
    // 8 i + 2 (lane % 4) + {0, 1}: element [4 i + 2 j + c].
    const int lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const int r = blockIdx.x * kRows + (threadIdx.x / 32) * 16 + lane / 4;
    uint32_t q_base = smem_u32(smem);
    uint32_t do_base = smem_u32(smem + L::kTile);
    const float scale_l2 = scale * kLog2e;
    const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)batch * n_kv;

    // this thread's two rows: lse log2(e), delta; rows past n and
    // fully-masked rows (uniform p, ds = 0) take no part in dQ
    float lse_r[2], delta_r[2];
    bool live[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = r + 8 * j;
      const bool valid = row < n_q;
      lse_r[j] = valid ? lse[(size_t)bh * n_q + row] * kLog2e : 0.0f;
      delta_r[j] = valid ? delta[(size_t)bh * n_q + row] : 0.0f;
      live[j] = valid && !(lse_r[j] < kEmptyRowLse);
    }

    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.0f;

    mbar_wait(&own_bar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      // the owned tiles' descriptors are made anew in each tile, not held
      // in registers across the loop
      asm volatile("" : "+r"(q_base), "+r"(do_base));
      mbar_wait(&full_bar[s], (t / kStages) & 1);
      const uint32_t k_base = smem_u32(smem + L::kRing + s * L::kStage);
      const uint32_t v_base = k_base + L::kTile;

      float sc[32], dp[32];
      wgmma_fence();
      scores<D>(sc, q_base, k_base);   // S = Q K^T
      scores<D>(dp, do_base, v_base);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // dS = P (dP - delta) scale on kept keys of live rows, 0 elsewhere
      ds_rows(sc, dp, t * kRows, n_kv, mask_b, quad, live, lse_r, delta_r, scale_l2, scale);
      uint32_t ds_a[4][4];
      repack(dp, ds_a);

      wgmma_fence();
      accumulate<D>(dq_acc, ds_a, k_base);  // dQ += dS K, K read MN-major
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq_acc);
      mbar_arrive(&empty_bar[s]);  // this thread's reads of the stage are done
    }
    store_rows<D>(dq_acc, dq + (size_t)bh * n_q * D, D, 0, D, r, quad, n_q);
  }
}

// ------------------------------------------------------------- bf16: K3

// grid: (key tiles of 64 keys, heads, batch); the same operands, dk and dv
// (b, h, n_kv, D). Two blocks share an SM at d = 64; at d = 128 dK and dV
// alone take 128 registers a thread, and one block takes the SM. At d = 256
// they would take 256, more than a thread can have, so two consumer
// warpgroups split the work by gradient: warpgroup 0 computes S^T = K Q^T,
// P^T from it and dV += P^T dO; warpgroup 1 computes dP^T = V dO^T, takes
// P^T in fp32 from warpgroup 0 through shared memory (one 16 KB tile, two
// named barriers), forms dS^T and accumulates dK += dS^T Q. Each holds one
// 64 x 256 accumulator (128 registers) and runs two of the four products of
// a tile, nothing is computed twice, and P reaches dS in the fp32 it has
// with one warpgroup, so the sums are those of d <= 128.
template <int D>
__global__ void __launch_bounds__(K3Shape<D>::kThreads, D == 64 ? 2 : 1)
    flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int heads, int n_q, int n_kv, float scale) {
  using L = Bf16Smem<D>;
  constexpr int NWG = K3Shape<D>::kWarpgroups;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ __align__(8) uint64_t own_bar;
  uint8_t* smem = align1024(smem_raw);

  const int batch = blockIdx.z;
  const int bh = batch * heads + blockIdx.y;
  const int n_tiles = (n_q + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA's expect_tx and one arrival from each producer lane after
      // its lse and delta stores
      mbar_init(&full_bar[s], 1 + 32);
      mbar_init(&empty_bar[s], NWG * 128);
    }
    mbar_init(&own_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {
    // producer warp: K and V once, then Q and dO tiles and their rows'
    // lse and delta through the ring
    if constexpr (NWG == 2) setmaxnreg_dec<24>();
    const int lane = threadIdx.x - NWG * 128;
    if (lane >= 32) return;  // the rest of a producer warpgroup
    if (lane == 0) {
      mbar_expect_tx(&own_bar, 2 * L::kTile);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c) {
        const int row0 = blockIdx.x * kRows;
        tma_load_3d(smem + c * L::kChunk, &tm_k, &own_bar, c * kSwizzleCols, row0, bh);
        tma_load_3d(smem + L::kTile + c * L::kChunk, &tm_v, &own_bar, c * kSwizzleCols,
                    row0, bh);
      }
    }
    const float* lse_bh = lse + (size_t)bh * n_q;
    const float* delta_bh = delta + (size_t)bh * n_q;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      uint8_t* stage = smem + L::kRing + s * L::kStage;
      float* lse_s = reinterpret_cast<float*>(stage + 2 * L::kTile);
      mbar_wait(&empty_bar[s], ((t / kStages) & 1) ^ 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * lane + e;
        const int row = t * kRows + i;
        const bool valid = row < n_q;
        lse_s[i] = valid ? lse_bh[row] * kLog2e : 0.0f;
        lse_s[kRows + i] = valid ? delta_bh[row] : 0.0f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full_bar[s], 2 * L::kTile);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_3d(stage + c * L::kChunk, &tm_q, &full_bar[s], c * kSwizzleCols,
                      t * kRows, bh);
          tma_load_3d(stage + L::kTile + c * L::kChunk, &tm_do, &full_bar[s],
                      c * kSwizzleCols, t * kRows, bh);
        }
      }
      mbar_arrive(&full_bar[s]);  // releases this lane's stores
    }
  } else {
    // consumer warpgroup wg: 64 keys, rows r and r + 8 of the accumulators
    // (keys); the columns are query rows
    if constexpr (NWG == 2) setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int quad = lane % 4;
    const int r = blockIdx.x * kRows + (tid / 32) * 16 + lane / 4;
    uint32_t k_base = smem_u32(smem);
    uint32_t v_base = smem_u32(smem + L::kTile);
    const float scale_l2 = scale * kLog2e;
    const float inv_kv = 1.0f / (float)n_kv;
    float* p_x = reinterpret_cast<float*>(smem + L::kPx);  // two warpgroups: P^T, fp32

    bool real[2], kept[2];  // this thread's two keys
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = r + 8 * j;
      real[j] = key < n_kv;
      kept[j] = real[j] && (mask == nullptr || mask[(size_t)batch * n_kv + key]);
    }

    // one warpgroup: dK and dV; two: warpgroup 0 dV, warpgroup 1 dK, each
    // in acc
    float acc[D / 2], dk_acc[NWG == 1 ? D / 2 : 1];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    if constexpr (NWG == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] = 0.0f;
    }

    mbar_wait(&own_bar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      asm volatile("" : "+r"(k_base), "+r"(v_base));  // as in K2
      mbar_wait(&full_bar[s], (t / kStages) & 1);
      const uint8_t* stage = smem + L::kRing + s * L::kStage;
      const uint32_t q_base = smem_u32(stage);
      const uint32_t do_base = q_base + L::kTile;
      const float* lse_s = reinterpret_cast<const float*>(stage + 2 * L::kTile);
      const float* delta_s = lse_s + kRows;
      const int row0 = t * kRows;

      if constexpr (NWG == 1) {
        float st[32], dpt[32];
        wgmma_fence();
        scores<D>(st, k_base, q_base);    // S^T = K Q^T
        scores<D>(dpt, v_base, do_base);  // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        fence_regs(dpt);

        // P^T and dS^T; column 8 i + 2 quad + c is query row row0 + that, its
        // lse (times log2(e), from the producer) and delta in the stage
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 8 * i + 2 * quad;
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
          const float2 d2 = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float l = c ? l2.y : l2.x;
            const float dl = c ? d2.y : d2.x;
            const bool valid = row0 + col + c < n_q;
            const bool empty = l < kEmptyRowLse;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int e = 4 * i + 2 * j + c;
              const bool keep = valid && !empty && kept[j];
              const float p = prob(st[e], scale_l2, l, keep, valid && empty && real[j], inv_kv);
              dpt[e] = keep ? p * (dpt[e] - dl) * scale : 0.0f;
              st[e] = p;
            }
          }
        }
        uint32_t p_a[4][4], ds_a[4][4];
        repack(st, p_a);
        repack(dpt, ds_a);

        wgmma_fence();
        accumulate<D>(acc, p_a, do_base);     // dV += P^T dO, dO read MN-major
        accumulate<D>(dk_acc, ds_a, q_base);  // dK += dS^T Q, Q read MN-major
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(dk_acc);
      } else {
        // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T
        float sc[32];
        wgmma_fence();
        if (wg == 0) {
          scores<D>(sc, k_base, q_base);
        } else {
          scores<D>(sc, v_base, do_base);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        if (wg == 0) {
          // P^T as with one warpgroup, handed to warpgroup 1 in fp32 once it
          // has read the last tile's
          pt_cols(sc, lse_s, row0, n_q, quad, kept, real, scale_l2, inv_kv);
          if (t > 0) named_bar_sync(kBarPEmpty, 256);
#pragma unroll
          for (int e = 0; e < 32; ++e) p_x[e * 128 + tid] = sc[e];
          named_bar_arrive(kBarPFull, 256);
        } else {
          // dS^T = P^T (dP^T - delta) scale on kept keys of rows that have
          // one, 0 elsewhere, from warpgroup 0's P^T
          named_bar_sync(kBarPFull, 256);
          dst_cols(sc, p_x, lse_s, delta_s, row0, n_q, quad, tid, kept, scale);
          if (t + 1 < n_tiles) named_bar_arrive(kBarPEmpty, 256);
        }
        uint32_t a[4][4];
        repack(sc, a);
        wgmma_fence();
        // warpgroup 0: dV += P^T dO; warpgroup 1: dK += dS^T Q (MN-major)
        accumulate<D>(acc, a, wg == 0 ? do_base : q_base);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      mbar_arrive(&empty_bar[s]);  // this thread's reads of the stage are done
    }
    if constexpr (NWG == 1) {
      store_rows<D>(dk_acc, dk + (size_t)bh * n_kv * D, D, 0, D, r, quad, n_kv);
      store_rows<D>(acc, dv + (size_t)bh * n_kv * D, D, 0, D, r, quad, n_kv);
    } else {
      store_rows<D>(acc, (wg == 0 ? dv : dk) + (size_t)bh * n_kv * D, D, 0, D, r, quad,
                    n_kv);
    }
  }
}

// --------------------------------------------- bf16: head dims past 256

// Past 256 columns one gradient takes 256 registers a thread (64 x 512
// fp32) and the owned tiles alone 128 KB of shared memory, so neither is
// held whole. A block owns a 256-column chunk of its 64 rows' gradients
// (the chunk index in the grid): K2 one dQ chunk in its warpgroup, K3 a
// chunk of dK and one of dV in two warpgroups, as at d = 256 (P handed from
// the dV warpgroup to the dK warpgroup in fp32 through shared memory). The
// scores S and dP are sums over the whole d: all four operands (K2: Q, dO
// of its rows, K, V of the streamed tile; K3: K, V of its keys, Q, dO of the
// tile) stream in 64-column slices, one swizzled column chunk each, through
// a ring of stages (4 in K2, 2 in K3), so shared memory does not grow with
// d. The gradient's product then takes the chunk's columns of the streamed
// operand (K2: K; K3: dO and Q), a 64 x 256 tile through 2 stages of its
// own, loaded ahead of the slices. Every chunk's block computes the same
// scores; each owns its columns, so there are no atomics and the sums'
// order is fixed. K2 holds dQ (128 registers), S and dP (32 each) in one
// warpgroup as at d = 256; K3's two consumer warpgroups each hold one
// gradient and one score tile, beside a producer warpgroup that gives its
// registers away. The last chunk may be narrower than 256 (d is a multiple
// of 64): its missing columns are not loaded and not stored.
struct WideSmem {
  static constexpr int kSlice = kRows * 128;  // 64 rows x 64 bf16: 8 KB
  static constexpr int kStage = 4 * kSlice;   // four operands' slices
  static constexpr int kChunkTile = kWideCols / kSwizzleCols * kSlice;  // 64 x 256: 32 KB
  // K2: 4 stages of (Q, dO, K, V) slices, then 2 tiles of K's chunk
  static constexpr int kRingDq = 4;
  static constexpr int kChunksDq = kRingDq * kStage;
  static constexpr int kAllocDq = kChunksDq + 2 * kChunkTile + 1024;  // 193 KB
  // K3: 2 stages of (K, V, Q, dO) slices, then 2 stages of Q's and dO's
  // chunks with the tile's 64 lse and 64 delta values, then P in fp32
  static constexpr int kRingDkv = 2;
  static constexpr int kChunkStage = 2 * kChunkTile + 1024;
  static constexpr int kChunksDkv = kRingDkv * kStage;
  static constexpr int kPx = kChunksDkv + 2 * kChunkStage;
  static constexpr int kAllocDkv = kPx + 64 * 64 * 4 + 1024;  // 211 KB
};

// acc (64 x 64) += A (64 rows of one 64-column slice, K-major) times B^T
// (64 rows of a slice, K-major) over the slice's columns in steps of 16;
// `first` overwrites acc
__device__ __forceinline__ void scores_slice(float (&acc)[32], uint32_t a_base, uint32_t b_base,
                                             bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_ss_n64(acc, sw128_desc(a_base + kk * 32, 16, 1024),
                 sw128_desc(b_base + kk * 32, 16, 1024), !first || kk > 0);
  }
}

// grid: (query tiles of 64 rows x chunks of 256 columns, heads, batch).
// Warpgroup 0 consumes; warp 4 loads. The operands as
// flash_bwd_dq_bf16's at head dim d, the maps' boxes 64 columns x 64 rows.
__global__ void __launch_bounds__(kThreadsDq, 1)
    flash_bwd_dq_bf16_wide(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                           const float* __restrict__ delta, bf16* __restrict__ dq, int heads,
                           int n_q, int n_kv, int d, float scale) {
  using L = WideSmem;
  constexpr int kRing = L::kRingDq;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kRing];
  __shared__ __align__(8) uint64_t empty_bar[kRing];
  __shared__ __align__(8) uint64_t c_full[2];
  __shared__ __align__(8) uint64_t c_empty[2];
  uint8_t* smem = align1024(smem_raw);

  const int n_chunks = (d + kWideCols - 1) / kWideCols;
  const int chunk = blockIdx.x % n_chunks;
  const int q_tile = blockIdx.x / n_chunks;
  const int col0 = chunk * kWideCols;
  const int slices = d / kSwizzleCols;
  const int chunk_slices = min(kWideCols / kSwizzleCols, slices - col0 / kSwizzleCols);
  const int batch = blockIdx.z;
  const int bh = batch * heads + blockIdx.y;
  const int n_tiles = (n_kv + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 128);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&c_full[s], 1);
      mbar_init(&c_empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: per key tile, K's chunk, then the tile's (Q, dO, K, V)
    // slices in order through the ring
    if (threadIdx.x == 128) {
      int it = 0;  // slices requested
      for (int t = 0; t < n_tiles; ++t) {
        const int cb = t & 1;
        mbar_wait(&c_empty[cb], ((t >> 1) & 1) ^ 1);
        mbar_expect_tx(&c_full[cb], chunk_slices * L::kSlice);
        for (int c = 0; c < chunk_slices; ++c) {
          tma_load_3d(smem + L::kChunksDq + cb * L::kChunkTile + c * L::kSlice, &tm_k,
                      &c_full[cb], col0 + c * kSwizzleCols, t * kRows, bh);
        }
        for (int s = 0; s < slices; ++s, ++it) {
          const int st = it % kRing;
          uint8_t* stage = smem + st * L::kStage;
          mbar_wait(&empty_bar[st], ((it / kRing) & 1) ^ 1);
          mbar_expect_tx(&full_bar[st], L::kStage);
          tma_load_3d(stage, &tm_q, &full_bar[st], s * kSwizzleCols, q_tile * kRows, bh);
          tma_load_3d(stage + L::kSlice, &tm_do, &full_bar[st], s * kSwizzleCols,
                      q_tile * kRows, bh);
          tma_load_3d(stage + 2 * L::kSlice, &tm_k, &full_bar[st], s * kSwizzleCols, t * kRows,
                      bh);
          tma_load_3d(stage + 3 * L::kSlice, &tm_v, &full_bar[st], s * kSwizzleCols, t * kRows,
                      bh);
        }
      }
    }
  } else {
    // consumer warpgroup: 64 query rows, accumulator layout as flash_bwd_dq_bf16's
    const int lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const int r = q_tile * kRows + (threadIdx.x / 32) * 16 + lane / 4;
    const float scale_l2 = scale * kLog2e;
    const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)batch * n_kv;

    float lse_r[2], delta_r[2];
    bool live[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = r + 8 * j;
      const bool valid = row < n_q;
      lse_r[j] = valid ? lse[(size_t)bh * n_q + row] * kLog2e : 0.0f;
      delta_r[j] = valid ? delta[(size_t)bh * n_q + row] : 0.0f;
      live[j] = valid && !(lse_r[j] < kEmptyRowLse);
    }

    float dq_acc[kWideCols / 2];
#pragma unroll
    for (int i = 0; i < kWideCols / 2; ++i) dq_acc[i] = 0.0f;

    int it = 0;  // slices consumed
    for (int t = 0; t < n_tiles; ++t) {
      // S = Q K^T and dP = dO V^T over d, slice after slice; a stage is
      // released once the products that read it have retired, one behind
      float sc[32], dp[32];
      int prev = 0;
      for (int s = 0; s < slices; ++s, ++it) {
        const int st = it % kRing;
        mbar_wait(&full_bar[st], (it / kRing) & 1);
        const uint32_t base = smem_u32(smem + st * L::kStage);
        wgmma_fence();
        scores_slice(sc, base, base + 2 * L::kSlice, s == 0);
        scores_slice(dp, base + L::kSlice, base + 3 * L::kSlice, s == 0);
        wgmma_commit();
        if (s > 0) {
          wgmma_wait<1>();
          mbar_arrive(&empty_bar[prev]);
        }
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      mbar_arrive(&empty_bar[prev]);

      // dS = P (dP - delta) scale on kept keys of live rows, 0 elsewhere
      ds_rows(sc, dp, t * kRows, n_kv, mask_b, quad, live, lse_r, delta_r, scale_l2, scale);
      uint32_t ds_a[4][4];
      repack(dp, ds_a);

      const int cb = t & 1;
      mbar_wait(&c_full[cb], (t >> 1) & 1);
      wgmma_fence();
      accumulate<kWideCols>(dq_acc, ds_a,  // dQ += dS K over the chunk, K read MN-major
                            smem_u32(smem + L::kChunksDq + cb * L::kChunkTile));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq_acc);
      mbar_arrive(&c_empty[cb]);
    }
    store_rows<kWideCols>(dq_acc, dq + (size_t)bh * n_q * d, d, col0, d, r, quad, n_q);
  }
}

// grid: (key tiles of 64 keys x chunks of 256 columns, heads, batch);
// warpgroup 0 computes S^T = K Q^T, P^T and dV += P^T dO, warpgroup 1 dP^T
// = V dO^T, dS^T from warpgroup 0's P^T and dK += dS^T Q, as
// flash_bwd_dkv_bf16 at d = 256; warpgroup 2 is the producer (one warp of
// it works). The operands as flash_bwd_dkv_bf16's at head dim d.
__global__ void __launch_bounds__(3 * 128, 1)
    flash_bwd_dkv_bf16_wide(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                            const float* __restrict__ delta, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, int heads, int n_q, int n_kv, int d,
                            float scale) {
  using L = WideSmem;
  constexpr int kRing = L::kRingDkv;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kRing];
  __shared__ __align__(8) uint64_t empty_bar[kRing];
  __shared__ __align__(8) uint64_t c_full[2];
  __shared__ __align__(8) uint64_t c_empty[2];
  uint8_t* smem = align1024(smem_raw);

  const int n_chunks = (d + kWideCols - 1) / kWideCols;
  const int chunk = blockIdx.x % n_chunks;
  const int k_tile = blockIdx.x / n_chunks;
  const int col0 = chunk * kWideCols;
  const int slices = d / kSwizzleCols;
  const int chunk_slices = min(kWideCols / kSwizzleCols, slices - col0 / kSwizzleCols);
  const int batch = blockIdx.z;
  const int bh = batch * heads + blockIdx.y;
  const int n_tiles = (n_q + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 256);
    }
    for (int s = 0; s < 2; ++s) {
      // the TMA's expect_tx and one arrival from each producer lane after
      // its lse and delta stores
      mbar_init(&c_full[s], 1 + 32);
      mbar_init(&c_empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warp: per query tile, the chunks of Q and dO and the tile's
    // lse and delta, then the (K, V, Q, dO) slices in order through the ring
    setmaxnreg_dec<24>();
    const int lane = threadIdx.x - 256;
    if (lane >= 32) return;  // the rest of the producer warpgroup
    const float* lse_bh = lse + (size_t)bh * n_q;
    const float* delta_bh = delta + (size_t)bh * n_q;
    int it = 0;  // slices requested (lane 0)
    for (int t = 0; t < n_tiles; ++t) {
      const int cb = t & 1;
      uint8_t* cstage = smem + L::kChunksDkv + cb * L::kChunkStage;
      float* lse_s = reinterpret_cast<float*>(cstage + 2 * L::kChunkTile);
      mbar_wait(&c_empty[cb], ((t >> 1) & 1) ^ 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * lane + e;
        const int row = t * kRows + i;
        const bool valid = row < n_q;
        lse_s[i] = valid ? lse_bh[row] * kLog2e : 0.0f;
        lse_s[kRows + i] = valid ? delta_bh[row] : 0.0f;
      }
      if (lane == 0) {
        mbar_expect_tx(&c_full[cb], 2 * chunk_slices * L::kSlice);
        for (int c = 0; c < chunk_slices; ++c) {
          tma_load_3d(cstage + c * L::kSlice, &tm_q, &c_full[cb], col0 + c * kSwizzleCols,
                      t * kRows, bh);
          tma_load_3d(cstage + L::kChunkTile + c * L::kSlice, &tm_do, &c_full[cb],
                      col0 + c * kSwizzleCols, t * kRows, bh);
        }
      }
      mbar_arrive(&c_full[cb]);  // releases this lane's stores
      if (lane == 0) {
        for (int s = 0; s < slices; ++s, ++it) {
          const int st = it % kRing;
          uint8_t* stage = smem + st * L::kStage;
          mbar_wait(&empty_bar[st], ((it / kRing) & 1) ^ 1);
          mbar_expect_tx(&full_bar[st], L::kStage);
          tma_load_3d(stage, &tm_k, &full_bar[st], s * kSwizzleCols, k_tile * kRows, bh);
          tma_load_3d(stage + L::kSlice, &tm_v, &full_bar[st], s * kSwizzleCols,
                      k_tile * kRows, bh);
          tma_load_3d(stage + 2 * L::kSlice, &tm_q, &full_bar[st], s * kSwizzleCols, t * kRows,
                      bh);
          tma_load_3d(stage + 3 * L::kSlice, &tm_do, &full_bar[st], s * kSwizzleCols,
                      t * kRows, bh);
        }
      }
    }
  } else {
    // consumer warpgroup wg: 64 keys, rows r and r + 8 of the accumulators
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int quad = lane % 4;
    const int r = k_tile * kRows + (tid / 32) * 16 + lane / 4;
    const float scale_l2 = scale * kLog2e;
    const float inv_kv = 1.0f / (float)n_kv;
    float* p_x = reinterpret_cast<float*>(smem + L::kPx);

    bool real[2], kept[2];  // this thread's two keys
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = r + 8 * j;
      real[j] = key < n_kv;
      kept[j] = real[j] && (mask == nullptr || mask[(size_t)batch * n_kv + key]);
    }

    float acc[kWideCols / 2];  // warpgroup 0: dV; warpgroup 1: dK
#pragma unroll
    for (int i = 0; i < kWideCols / 2; ++i) acc[i] = 0.0f;

    int it = 0;  // slices consumed
    for (int t = 0; t < n_tiles; ++t) {
      // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T, over d
      float sc[32];
      int prev = 0;
      for (int s = 0; s < slices; ++s, ++it) {
        const int st = it % kRing;
        mbar_wait(&full_bar[st], (it / kRing) & 1);
        const uint32_t base = smem_u32(smem + st * L::kStage) + wg * L::kSlice;
        wgmma_fence();
        scores_slice(sc, base, base + 2 * L::kSlice, s == 0);
        wgmma_commit();
        if (s > 0) {
          wgmma_wait<1>();
          mbar_arrive(&empty_bar[prev]);
        }
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(&empty_bar[prev]);

      const int cb = t & 1;
      const uint8_t* cstage = smem + L::kChunksDkv + cb * L::kChunkStage;
      const float* lse_s = reinterpret_cast<const float*>(cstage + 2 * L::kChunkTile);
      const float* delta_s = lse_s + kRows;
      const int row0 = t * kRows;
      mbar_wait(&c_full[cb], (t >> 1) & 1);
      if (wg == 0) {
        // P^T, handed to warpgroup 1 in fp32 once it has read the last tile's
        pt_cols(sc, lse_s, row0, n_q, quad, kept, real, scale_l2, inv_kv);
        if (t > 0) named_bar_sync(kBarPEmpty, 256);
#pragma unroll
        for (int e = 0; e < 32; ++e) p_x[e * 128 + tid] = sc[e];
        named_bar_arrive(kBarPFull, 256);
      } else {
        // dS^T = P^T (dP^T - delta) scale on kept keys of rows that have
        // one, 0 elsewhere
        named_bar_sync(kBarPFull, 256);
        dst_cols(sc, p_x, lse_s, delta_s, row0, n_q, quad, tid, kept, scale);
        if (t + 1 < n_tiles) named_bar_arrive(kBarPEmpty, 256);
      }
      uint32_t a[4][4];
      repack(sc, a);
      wgmma_fence();
      // warpgroup 0: dV += P^T dO; warpgroup 1: dK += dS^T Q, over the
      // chunk (MN-major)
      accumulate<kWideCols>(acc, a, smem_u32(cstage + (wg == 0 ? L::kChunkTile : 0)));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(&c_empty[cb]);
    }
    store_rows<kWideCols>(acc, (wg == 0 ? dv : dk) + (size_t)bh * n_kv * d, d, col0, d, r, quad,
                          n_kv);
  }
}

// ------------------------------------------------------------------- host

struct Args {
  const void *q, *k, *v, *mask, *dout, *lse, *delta;
  int batch, heads, n_q, n_kv;
  float scale;
  cudaStream_t stream;
};

// the four maps of a bf16 launch, each in boxes of 64 rows
cudaError_t encode_maps(const Args& a, int D, CUtensorMap (&m)[4]) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const int bh = a.batch * a.heads;
  const bool ok = encode_bf16_3d(fn, &m[0], a.q, D, a.n_q, bh, kRows) &&
                  encode_bf16_3d(fn, &m[1], a.k, D, a.n_kv, bh, kRows) &&
                  encode_bf16_3d(fn, &m[2], a.v, D, a.n_kv, bh, kRows) &&
                  encode_bf16_3d(fn, &m[3], a.dout, D, a.n_q, bh, kRows);
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_dq_bf16(const Args& a, void* dq) {
  using L = Bf16Smem<D>;
  CUtensorMap m[4];
  cudaError_t err = encode_maps(a, D, m);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_bf16<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_q + kRows - 1) / kRows, a.heads, a.batch);
  kernel<<<grid, kThreadsDq, L::kAlloc, a.stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const uint8_t*>(a.mask),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(dq), a.heads, a.n_q, a.n_kv, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(const Args& a, void* dk, void* dv) {
  using L = Bf16Smem<D>;
  CUtensorMap m[4];
  cudaError_t err = encode_maps(a, D, m);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_bf16<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kAllocDkv);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_kv + kRows - 1) / kRows, a.heads, a.batch);
  kernel<<<grid, K3Shape<D>::kThreads, L::kAllocDkv, a.stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const uint8_t*>(a.mask),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.heads, a.n_q, a.n_kv, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const Args& a, void* dq) {
  using L = F32Tile<D>;
  auto kernel = flash_bwd_dq_f32<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytesDq);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_q + L::OWN - 1) / L::OWN, a.heads, a.batch);
  kernel<<<grid, L::kThreads, L::kBytesDq, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const uint8_t*>(a.mask),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<float*>(dq), a.heads, a.n_q, a.n_kv,
      a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const Args& a, void* dk, void* dv) {
  using L = F32Tile<D>;
  auto kernel = flash_bwd_dkv_f32<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytesDkv);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_kv + L::OWN - 1) / L::OWN, a.heads, a.batch);
  kernel<<<grid, L::kThreads, L::kBytesDkv, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const uint8_t*>(a.mask),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<float*>(dk), static_cast<float*>(dv),
      a.heads, a.n_q, a.n_kv, a.scale);
  return cudaGetLastError();
}

// head dims past 256 (a multiple of 64): the chunked kernels
cudaError_t launch_dq_wide(const Args& a, int d, int dtype, void* dq) {
  const int n_chunks = (d + kWideCols - 1) / kWideCols;
  if (dtype == 1) {
    CUtensorMap m[4];
    cudaError_t err = encode_maps(a, d, m);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dq_bf16_wide,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, WideSmem::kAllocDq);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.n_q + kRows - 1) / kRows * n_chunks, a.heads, a.batch);
    flash_bwd_dq_bf16_wide<<<grid, kThreadsDq, WideSmem::kAllocDq, a.stream>>>(
        m[0], m[1], m[2], m[3], static_cast<const uint8_t*>(a.mask),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(dq), a.heads, a.n_q, a.n_kv, d, a.scale);
    return cudaGetLastError();
  }
  if (dtype == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_f32_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, F32Wide::kBytesDq);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.n_q + F32Wide::OWN - 1) / F32Wide::OWN * n_chunks, a.heads, a.batch);
    flash_bwd_dq_f32_wide<<<grid, F32Wide::kThreads, F32Wide::kBytesDq, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const uint8_t*>(a.mask),
        static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<float*>(dq), a.heads, a.n_q, a.n_kv, d,
        a.scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_dkv_wide(const Args& a, int d, int dtype, void* dk, void* dv) {
  const int n_chunks = (d + kWideCols - 1) / kWideCols;
  if (dtype == 1) {
    CUtensorMap m[4];
    cudaError_t err = encode_maps(a, d, m);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_wide,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, WideSmem::kAllocDkv);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.n_kv + kRows - 1) / kRows * n_chunks, a.heads, a.batch);
    flash_bwd_dkv_bf16_wide<<<grid, 3 * 128, WideSmem::kAllocDkv, a.stream>>>(
        m[0], m[1], m[2], m[3], static_cast<const uint8_t*>(a.mask),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.heads, a.n_q, a.n_kv, d, a.scale);
    return cudaGetLastError();
  }
  if (dtype == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_f32_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
        F32Wide::kBytesDkv);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.n_kv + F32Wide::OWN - 1) / F32Wide::OWN * n_chunks, a.heads, a.batch);
    flash_bwd_dkv_f32_wide<<<grid, F32Wide::kThreads, F32Wide::kBytesDkv, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const uint8_t*>(a.mask),
        static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<float*>(dk), static_cast<float*>(dv),
        a.heads, a.n_q, a.n_kv, d, a.scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16;
// head_dim 64, 128 or 256 in either, 16 or 32 in float32, or any multiple of
// 64 past 256 in either (the chunked kernels). Each returns 0 or the
// cudaError_t of the launch.
extern "C" int vb_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* mask, const void* dout, const void* lse,
                                         const void* delta, void* dq, int batch, int heads,
                                         int n_q, int n_kv, int head_dim, int dtype,
                                         float scale, void* stream) {
  const Args a{q, k, v, mask, dout, lse, delta, batch, heads, n_q, n_kv, scale,
               static_cast<cudaStream_t>(stream)};
  if (head_dim == 64 && dtype == 1) return launch_dq_bf16<64>(a, dq);
  if (head_dim == 128 && dtype == 1) return launch_dq_bf16<128>(a, dq);
  if (head_dim == 256 && dtype == 1) return launch_dq_bf16<256>(a, dq);
  if (head_dim == 256 && dtype == 0) return launch_dq_f32<256>(a, dq);
  if (head_dim == 64 && dtype == 0) return launch_dq_f32<64>(a, dq);
  if (head_dim == 128 && dtype == 0) return launch_dq_f32<128>(a, dq);
  if (head_dim == 32 && dtype == 0) return launch_dq_f32<32>(a, dq);
  if (head_dim == 16 && dtype == 0) return launch_dq_f32<16>(a, dq);
  if (head_dim > 256 && head_dim % kSwizzleCols == 0) {
    return launch_dq_wide(a, head_dim, dtype, dq);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int vb_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                          const void* mask, const void* dout, const void* lse,
                                          const void* delta, void* dk, void* dv, int batch,
                                          int heads, int n_q, int n_kv, int head_dim,
                                          int dtype, float scale, void* stream) {
  const Args a{q, k, v, mask, dout, lse, delta, batch, heads, n_q, n_kv, scale,
               static_cast<cudaStream_t>(stream)};
  if (head_dim == 64 && dtype == 1) return launch_dkv_bf16<64>(a, dk, dv);
  if (head_dim == 128 && dtype == 1) return launch_dkv_bf16<128>(a, dk, dv);
  if (head_dim == 256 && dtype == 1) return launch_dkv_bf16<256>(a, dk, dv);
  if (head_dim == 256 && dtype == 0) return launch_dkv_f32<256>(a, dk, dv);
  if (head_dim == 64 && dtype == 0) return launch_dkv_f32<64>(a, dk, dv);
  if (head_dim == 128 && dtype == 0) return launch_dkv_f32<128>(a, dk, dv);
  if (head_dim == 32 && dtype == 0) return launch_dkv_f32<32>(a, dk, dv);
  if (head_dim == 16 && dtype == 0) return launch_dkv_f32<16>(a, dk, dv);
  if (head_dim > 256 && head_dim % kSwizzleCols == 0) {
    return launch_dkv_wide(a, head_dim, dtype, dk, dv);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
