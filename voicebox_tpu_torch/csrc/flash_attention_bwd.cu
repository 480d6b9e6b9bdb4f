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
// fp32 keeps the scalar code of the first port (exact to fp32 rounding, for
// the card-vs-CPU checks): 64-row tiles of 4 warps, scalar FMAs, the
// gradients accumulated straight into their fp32 outputs, which each block
// owns. Both launch on the caller's stream and allocate nothing; the host
// encodes the four tensor maps of a bf16 launch on each call.

#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kMaskFill = -0.7f * 3.402823466e38f;
constexpr float kEmptyRowLse = 0.5f * kMaskFill;  // below: every key was masked
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ fp32: kernels

constexpr int kF32Warps = 4;
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kRowsPerWarp = 16;
constexpr int kF32BlockM = kF32Warps * kRowsPerWarp;  // rows a block owns
constexpr int kF32BlockN = 64;                         // rows of each streamed tile

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// Shared-memory layout, in bytes. Row pitches are padded by 4 floats. A and
// B are the block's own tiles (K2: Q, dO; K3: K, V), C and D the streamed
// ones (K2: K, V; K3: Q, dO). S and dP (kF32BlockM x kF32BlockN); P and dS
// overwrite them (each element is read and rewritten by the one thread that
// owns it). Row state: per streamed row (K2: keys, K3: query rows) a flag,
// and in K3 the query rows' lse and delta.
template <int D>
struct F32Layout {
  static constexpr int kLdIn = D + 4;
  static constexpr int kLdS = kF32BlockN + 4;
  static constexpr int kTile = align128(kF32BlockM * kLdIn * 4);
  static constexpr int kA = 0;
  static constexpr int kB = kA + kTile;
  static constexpr int kC = kB + kTile;
  static constexpr int kD = kC + kTile;
  static constexpr int kS = kD + kTile;  // S, then P
  static constexpr int kDP = kS + align128(kF32BlockM * kLdS * 4);  // dP, then dS
  static constexpr int kFlag = kDP + align128(kF32BlockM * kLdS * 4);
  static constexpr int kOwnFlag = kFlag + align128(kF32BlockN * 4);
  static constexpr int kLse = kOwnFlag + align128(kF32BlockM * 4);
  static constexpr int kDelta = kLse + align128(kF32BlockN * 4);
  static constexpr int kBytes = kDelta + align128(kF32BlockN * 4);
};

// rows [row0, row0 + ROWS) of a (n_rows, D) matrix into a padded tile; rows
// past n_rows are zero so that p = 0 never meets a stale value
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0,
                                          int n_rows) {
  constexpr int kChunks = D / 4;
  constexpr int kLd = F32Layout<D>::kLdIn;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kF32Threads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

// c (16 x kF32BlockN) = a (16 rows) . b (kF32BlockN rows)^T over D
template <int D>
__device__ __forceinline__ void gemm_abt(const float* a, const float* b, float* c, int lane) {
  using L = F32Layout<D>;
  for (int i = lane; i < kRowsPerWarp * kF32BlockN; i += 32) {
    const int r = i / kF32BlockN;
    const int col = i % kF32BlockN;
    const float* ar = a + r * L::kLdIn;
    const float* br = b + col * L::kLdIn;
    float acc = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) acc = fmaf(ar[d], br[d], acc);
    c[r * L::kLdS + col] = acc;
  }
}

// out rows [row0, row0 + 16) of an (n_rows, D) fp32 matrix += p . b.
// Lane i always owns the same elements, so the read-modify-write needs no
// synchronisation.
template <int D>
__device__ __forceinline__ void gemm_ab_acc_out(const float* p, const float* b,
                                                float* __restrict__ out, int row0,
                                                int n_rows, int lane) {
  using L = F32Layout<D>;
  for (int i = lane; i < kRowsPerWarp * D; i += 32) {
    const int r = i / D;
    const int c = i % D;
    if (row0 + r >= n_rows) continue;
    const float* pr = p + r * L::kLdS;
    float acc = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < kF32BlockN; ++kk) acc = fmaf(pr[kk], b[kk * L::kLdIn + c], acc);
    out[(size_t)(row0 + r) * D + c] += acc;
  }
}

// zero rows [row0, row0 + 16) of an (n_rows, D) fp32 output
template <int D>
__device__ __forceinline__ void zero_rows(float* __restrict__ out, int row0, int n_rows,
                                          int lane) {
  for (int i = lane; i < kRowsPerWarp * D; i += 32) {
    const int r = i / D;
    if (row0 + r < n_rows) out[(size_t)(row0 + r) * D + i % D] = 0.0f;
  }
}

// flag of a key: 1 keep, 0 masked, -1 past the end
__device__ __forceinline__ int key_flag(const uint8_t* __restrict__ mask, int batch, int key,
                                        int n_kv) {
  if (key >= n_kv) return -1;
  return (mask == nullptr || mask[(size_t)batch * n_kv + key]) ? 1 : 0;
}

// flag of a query row from its lse: 1 normal, 0 every key masked, -1 past the end
__device__ __forceinline__ int row_flag(float lse, bool valid) {
  return !valid ? -1 : (lse < kEmptyRowLse ? 0 : 1);
}

// p and ds of one (query row, key) pair from the fp32 logit s (unscaled) and dp
__device__ __forceinline__ void p_ds(float s, float dp, int row, int key, float lse,
                                     float delta, float scale, float inv_kv, float& p,
                                     float& ds) {
  p = 0.0f;
  ds = 0.0f;
  if (row < 0 || key < 0) return;  // past the ragged edge
  if (row == 0) {                  // every key masked: uniform, cut off from q and k
    p = inv_kv;
    return;
  }
  if (key == 0) return;  // a masked key: a select, never exp(.) * 0
  p = expf(s * scale - lse);
  ds = p * (dp - delta) * scale;
}

// K2, fp32: grid (query tiles, heads, batch). q, dout, dq (b, h, n_q, D); k, v
// (b, h, n_kv, D); mask (b, n_kv) bytes or null; lse, delta (b, h, n_q) fp32.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const uint8_t* __restrict__ mask,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq, int heads,
                     int n_q, int n_kv, float scale) {
  using L = F32Layout<D>;
  extern __shared__ __align__(128) unsigned char smem_f32[];
  float* q_s = reinterpret_cast<float*>(smem_f32 + L::kA);
  float* do_s = reinterpret_cast<float*>(smem_f32 + L::kB);
  float* k_s = reinterpret_cast<float*>(smem_f32 + L::kC);
  float* v_s = reinterpret_cast<float*>(smem_f32 + L::kD);
  float* s_s = reinterpret_cast<float*>(smem_f32 + L::kS);
  float* dp_s = reinterpret_cast<float*>(smem_f32 + L::kDP);
  float* ds_s = dp_s;
  int* key_s = reinterpret_cast<int*>(smem_f32 + L::kFlag);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kF32BlockM;
  const int batch = blockIdx.z;
  const size_t bh = (size_t)batch * heads + blockIdx.y;
  const float* k_bh = k + bh * n_kv * D;
  const float* v_bh = v + bh * n_kv * D;
  float* dq_bh = dq + bh * n_q * D;
  const int wrow0 = q0 + warp * kRowsPerWarp;  // the warp's first query row
  const float inv_kv = 1.0f / (float)n_kv;

  load_tile<D, kF32BlockM>(q_s, q + bh * n_q * D, q0, n_q);
  load_tile<D, kF32BlockM>(do_s, dout + bh * n_q * D, q0, n_q);

  // lanes 2r and 2r+1 own query row r of the warp's 16, each over half the keys
  const int row = warp * kRowsPerWarp + lane / 2;
  const int half = lane % 2;
  const bool valid = q0 + row < n_q;
  const float lse_r = valid ? lse[bh * n_q + q0 + row] : 0.0f;
  const float delta_r = valid ? delta[bh * n_q + q0 + row] : 0.0f;
  const int rflag = row_flag(lse_r, valid);

  zero_rows<D>(dq_bh, wrow0, n_q, lane);

  for (int k0 = 0; k0 < n_kv; k0 += kF32BlockN) {
    __syncthreads();  // the previous tile's K, V and flags are consumed
    load_tile<D, kF32BlockN>(k_s, k_bh, k0, n_kv);
    load_tile<D, kF32BlockN>(v_s, v_bh, k0, n_kv);
    if (threadIdx.x < kF32BlockN) {
      key_s[threadIdx.x] = key_flag(mask, batch, k0 + threadIdx.x, n_kv);
    }
    __syncthreads();

    const int wr = warp * kRowsPerWarp;
    gemm_abt<D>(q_s + wr * L::kLdIn, k_s, s_s + wr * L::kLdS, lane);
    gemm_abt<D>(do_s + wr * L::kLdIn, v_s, dp_s + wr * L::kLdS, lane);
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kF32BlockN / 2; ++j) {
      const int c = half * (kF32BlockN / 2) + j;
      float p, ds;
      p_ds(s_s[row * L::kLdS + c], dp_s[row * L::kLdS + c], rflag, key_s[c], lse_r, delta_r,
           scale, inv_kv, p, ds);
      ds_s[row * L::kLdS + c] = ds;
    }
    __syncwarp();

    gemm_ab_acc_out<D>(ds_s + wr * L::kLdS, k_s, dq_bh, wrow0, n_q, lane);
  }
}

// K3, fp32: grid (key tiles, heads, batch); same operands, dk and dv (b, h, n_kv, D).
template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const uint8_t* __restrict__ mask,
                      const float* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int heads, int n_q, int n_kv, float scale) {
  using L = F32Layout<D>;
  extern __shared__ __align__(128) unsigned char smem_f32[];
  float* k_s = reinterpret_cast<float*>(smem_f32 + L::kA);
  float* v_s = reinterpret_cast<float*>(smem_f32 + L::kB);
  float* q_s = reinterpret_cast<float*>(smem_f32 + L::kC);
  float* do_s = reinterpret_cast<float*>(smem_f32 + L::kD);
  float* s_s = reinterpret_cast<float*>(smem_f32 + L::kS);
  float* dp_s = reinterpret_cast<float*>(smem_f32 + L::kDP);
  float* p_s = s_s;
  float* ds_s = dp_s;
  int* row_s = reinterpret_cast<int*>(smem_f32 + L::kFlag);
  int* own_key_s = reinterpret_cast<int*>(smem_f32 + L::kOwnFlag);
  float* lse_s = reinterpret_cast<float*>(smem_f32 + L::kLse);
  float* delta_s = reinterpret_cast<float*>(smem_f32 + L::kDelta);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kF32BlockM;
  const int batch = blockIdx.z;
  const size_t bh = (size_t)batch * heads + blockIdx.y;
  const float* q_bh = q + bh * n_q * D;
  const float* do_bh = dout + bh * n_q * D;
  float* dk_bh = dk + bh * n_kv * D;
  float* dv_bh = dv + bh * n_kv * D;
  const int wkey0 = k0 + warp * kRowsPerWarp;  // the warp's first key
  const float inv_kv = 1.0f / (float)n_kv;

  load_tile<D, kF32BlockM>(k_s, k + bh * n_kv * D, k0, n_kv);
  load_tile<D, kF32BlockM>(v_s, v + bh * n_kv * D, k0, n_kv);
  if (threadIdx.x < kF32BlockM) {
    own_key_s[threadIdx.x] = key_flag(mask, batch, k0 + threadIdx.x, n_kv);
  }
  zero_rows<D>(dk_bh, wkey0, n_kv, lane);
  zero_rows<D>(dv_bh, wkey0, n_kv, lane);
  __syncthreads();

  // lanes 2r and 2r+1 own key r of the warp's 16, each over half the query rows
  const int key = warp * kRowsPerWarp + lane / 2;
  const int half = lane % 2;
  const int kflag = own_key_s[key];

  for (int q0 = 0; q0 < n_q; q0 += kF32BlockN) {
    __syncthreads();  // the previous tile's Q, dO and row state are consumed
    load_tile<D, kF32BlockN>(q_s, q_bh, q0, n_q);
    load_tile<D, kF32BlockN>(do_s, do_bh, q0, n_q);
    if (threadIdx.x < kF32BlockN) {
      const int r = q0 + threadIdx.x;
      const bool valid = r < n_q;
      const float l = valid ? lse[bh * n_q + r] : 0.0f;
      lse_s[threadIdx.x] = l;
      delta_s[threadIdx.x] = valid ? delta[bh * n_q + r] : 0.0f;
      row_s[threadIdx.x] = row_flag(l, valid);
    }
    __syncthreads();

    const int wk = warp * kRowsPerWarp;
    gemm_abt<D>(k_s + wk * L::kLdIn, q_s, s_s + wk * L::kLdS, lane);   // S^T
    gemm_abt<D>(v_s + wk * L::kLdIn, do_s, dp_s + wk * L::kLdS, lane); // dP^T
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kF32BlockN / 2; ++j) {
      const int c = half * (kF32BlockN / 2) + j;
      float p, ds;
      p_ds(s_s[key * L::kLdS + c], dp_s[key * L::kLdS + c], row_s[c], kflag, lse_s[c],
           delta_s[c], scale, inv_kv, p, ds);
      p_s[key * L::kLdS + c] = p;
      ds_s[key * L::kLdS + c] = ds;
    }
    __syncwarp();

    gemm_ab_acc_out<D>(p_s + wk * L::kLdS, do_s, dv_bh, wkey0, n_kv, lane);
    gemm_ab_acc_out<D>(ds_s + wk * L::kLdS, q_s, dk_bh, wkey0, n_kv, lane);
  }
}

// ------------------------------------------------------------ bf16: layout

constexpr int kRows = 64;    // rows of every tile, owned or streamed
constexpr int kStages = 2;   // ring depth
constexpr int kThreads = 128 + 32;  // one consumer warpgroup, then the producer warp

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
// into out (n_rows, D) as bf16 pairs; rows past n_rows are not stored
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], bf16* __restrict__ out,
                                           int r, int quad, int n_rows) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (r + 8 * j >= n_rows) continue;
    bf16* dst = out + (size_t)(r + 8 * j) * D + 2 * quad;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
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

// ------------------------------------------------------------- bf16: K2

// grid: (query tiles of 64 rows, heads, batch). Warpgroup 0 consumes; warp 4
// issues the loads. q, dout, dq (b, h, n_q, D) and k, v (b, h, n_kv, D)
// through 3-D tensor maps (D, rows, b h); mask (b, n_kv) bytes or null; lse,
// delta (b, h, n_q) fp32. Two blocks share an SM (at most 204 registers a
// thread).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
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
      const int k0 = t * kRows;
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
      uint32_t ds_a[4][4];
      repack(dp, ds_a);

      wgmma_fence();
      accumulate<D>(dq_acc, ds_a, k_base);  // dQ += dS K, K read MN-major
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq_acc);
      mbar_arrive(&empty_bar[s]);  // this thread's reads of the stage are done
    }
    store_rows<D>(dq_acc, dq + (size_t)bh * n_q * D, r, quad, n_q);
  }
}

// ------------------------------------------------------------- bf16: K3

// grid: (key tiles of 64 keys, heads, batch); the same operands, dk and dv
// (b, h, n_kv, D). Two blocks share an SM at d = 64; at d = 128 dK and dV
// alone take 128 registers a thread, and one block takes the SM.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int heads, int n_q, int n_kv, float scale) {
  using L = Bf16Smem<D>;
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
      mbar_init(&empty_bar[s], 128);
    }
    mbar_init(&own_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warp: K and V once, then Q and dO tiles and their rows'
    // lse and delta through the ring
    const int lane = threadIdx.x - 128;
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
    // consumer warpgroup: 64 keys, rows r and r + 8 of the accumulators
    // (keys); the columns are query rows
    const int lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const int r = blockIdx.x * kRows + (threadIdx.x / 32) * 16 + lane / 4;
    uint32_t k_base = smem_u32(smem);
    uint32_t v_base = smem_u32(smem + L::kTile);
    const float scale_l2 = scale * kLog2e;
    const float inv_kv = 1.0f / (float)n_kv;

    bool real[2], kept[2];  // this thread's two keys
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = r + 8 * j;
      real[j] = key < n_kv;
      kept[j] = real[j] && (mask == nullptr || mask[(size_t)batch * n_kv + key]);
    }

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

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
      const int row0 = t * kRows;
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
      accumulate<D>(dv_acc, p_a, do_base);  // dV += P^T dO, dO read MN-major
      accumulate<D>(dk_acc, ds_a, q_base);  // dK += dS^T Q, Q read MN-major
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(&empty_bar[s]);  // this thread's reads of the stage are done
    }
    store_rows<D>(dk_acc, dk + (size_t)bh * n_kv * D, r, quad, n_kv);
    store_rows<D>(dv_acc, dv + (size_t)bh * n_kv * D, r, quad, n_kv);
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
template <int D>
cudaError_t encode_maps(const Args& a, CUtensorMap (&m)[4]) {
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
  cudaError_t err = encode_maps<D>(a, m);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_bf16<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_q + kRows - 1) / kRows, a.heads, a.batch);
  kernel<<<grid, kThreads, L::kAlloc, a.stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const uint8_t*>(a.mask),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(dq), a.heads, a.n_q, a.n_kv, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(const Args& a, void* dk, void* dv) {
  using L = Bf16Smem<D>;
  CUtensorMap m[4];
  cudaError_t err = encode_maps<D>(a, m);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_bf16<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_kv + kRows - 1) / kRows, a.heads, a.batch);
  kernel<<<grid, kThreads, L::kAlloc, a.stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const uint8_t*>(a.mask),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.heads, a.n_q, a.n_kv, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const Args& a, void* dq) {
  using L = F32Layout<D>;
  auto kernel = flash_bwd_dq_f32<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_q + kF32BlockM - 1) / kF32BlockM, a.heads, a.batch);
  kernel<<<grid, kF32Threads, L::kBytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const uint8_t*>(a.mask),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<float*>(dq), a.heads, a.n_q, a.n_kv,
      a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const Args& a, void* dk, void* dv) {
  using L = F32Layout<D>;
  auto kernel = flash_bwd_dkv_f32<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_kv + kF32BlockM - 1) / kF32BlockM, a.heads, a.batch);
  kernel<<<grid, kF32Threads, L::kBytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const uint8_t*>(a.mask),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<float*>(dk), static_cast<float*>(dv),
      a.heads, a.n_q, a.n_kv, a.scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Each returns 0 or the cudaError_t of the launch.
extern "C" int vb_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* mask, const void* dout, const void* lse,
                                         const void* delta, void* dq, int batch, int heads,
                                         int n_q, int n_kv, int head_dim, int dtype,
                                         float scale, void* stream) {
  const Args a{q, k, v, mask, dout, lse, delta, batch, heads, n_q, n_kv, scale,
               static_cast<cudaStream_t>(stream)};
  if (head_dim == 64 && dtype == 1) return launch_dq_bf16<64>(a, dq);
  if (head_dim == 128 && dtype == 1) return launch_dq_bf16<128>(a, dq);
  if (head_dim == 64 && dtype == 0) return launch_dq_f32<64>(a, dq);
  if (head_dim == 128 && dtype == 0) return launch_dq_f32<128>(a, dq);
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
  if (head_dim == 64 && dtype == 0) return launch_dkv_f32<64>(a, dk, dv);
  if (head_dim == 128 && dtype == 0) return launch_dkv_f32<128>(a, dk, dv);
  return static_cast<int>(cudaErrorInvalidValue);
}
