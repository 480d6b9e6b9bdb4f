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
// ~38 MB: both far above the card's bf16 ridge (~295 FLOP per byte), so on
// paper bound by the tensor cores (~15 and ~20 us at 989 TFLOP/s). This
// first version is bound by latency instead: WMMA 16x16x16 (not wgmma), the
// scores make a round trip through shared memory for the elementwise pass,
// and the tile loads are not overlapped with the math.
//
// What the design does about it, and what it keeps simple:
//  * K2 is one block per (batch, head, 64-row query tile) and loops over
//    64-key K/V tiles; K3 is one block per (batch, head, 64-key tile) and
//    loops over 64-row Q/dO tiles. Each block owns its output rows: no
//    atomics, deterministic sums. At the training shape each launches
//    12 x 4 x 8 = 384 blocks of 4 warps (16 rows each) over 132 SMs;
//  * there is no running max to rescale, so in bf16 the dQ, dK and dV
//    accumulators stay in WMMA fragments (fp32) across the whole loop and
//    leave through shared memory once, at the end;
//  * fp32 inputs use scalar FMAs (exact to fp32 rounding, for the card-vs-CPU
//    checks) and accumulate straight into their fp32 outputs, which each
//    block owns: no fragment or staging buffer;
//  * shared memory holds the block's own two tiles, the two streamed tiles,
//    the fp32 S and dP tiles and the P and dS tiles in the input dtype
//    (aliased onto S and dP in fp32): 124 KB in bf16 and 171 KB in fp32 at
//    d = 128, so the launch raises the dynamic shared-memory limit first and
//    returns its error code;
//  * it launches on the caller's stream and allocates nothing.
// wgmma, TMA, a pipelined tile ring and fusing K2 into K3 with atomic dQ are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;
constexpr int kBlockM = kWarps * kRowsPerWarp;  // rows a block owns
constexpr int kBlockN = 64;                      // rows of each streamed tile
constexpr float kMaskFill = -0.7f * 3.402823466e38f;
constexpr float kEmptyRowLse = 0.5f * kMaskFill;  // below: every key was masked

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Shared-memory layout, in bytes. Row pitches are padded by 8 bf16 (16 B) or
// 4 floats, which keeps WMMA's 32-byte alignment and 16-byte vector stores.
// A and B are the block's own tiles (K2: Q, dO; K3: K, V), C and D the
// streamed ones (K2: K, V; K3: Q, dO). S and dP are fp32 (kBlockM x kBlockN);
// P and dS hold the same tiles in the input dtype, on top of S and dP in fp32
// (each element is read and rewritten by the one thread that owns it).
// Row state: per streamed row (K2: keys, K3: query rows) a flag, and in K3
// the query rows' lse and delta.
template <typename T, int D>
struct Layout {
  static constexpr bool kAlias = sizeof(T) == 4;
  static constexpr int kPad = sizeof(T) == 2 ? 8 : 4;
  static constexpr int kLdIn = D + kPad;
  static constexpr int kLdS = kBlockN + 4;
  static constexpr int kLdP = kBlockN + kPad;  // == kLdS in fp32
  static constexpr int kLdStage = D + 4;       // fp32 accumulators on the way out
  static constexpr int kTile = align128(kBlockM * kLdIn * (int)sizeof(T));
  static constexpr int kA = 0;
  static constexpr int kB = kA + kTile;
  static constexpr int kC = kB + kTile;
  static constexpr int kD = kC + kTile;
  static constexpr int kS = kD + kTile;
  static constexpr int kDP = kS + align128(kBlockM * kLdS * 4);
  static constexpr int kFp32End = kDP + align128(kBlockM * kLdS * 4);
  static constexpr int kP = kAlias ? kS : kFp32End;
  static constexpr int kDS = kAlias ? kDP : kP + align128(kBlockM * kLdP * (int)sizeof(T));
  static constexpr int kFlag = kAlias ? kFp32End : kDS + align128(kBlockM * kLdP * (int)sizeof(T));
  static constexpr int kOwnFlag = kFlag + align128(kBlockN * 4);
  static constexpr int kLse = kOwnFlag + align128(kBlockM * 4);
  static constexpr int kDelta = kLse + align128(kBlockN * 4);
  static constexpr int kBytes = kDelta + align128(kBlockN * 4);
  // bf16 accumulators leave through the tile regions: one staged matrix
  // fits over A and B, two over A..D
  static_assert(kAlias || kBlockM * kLdStage * 4 <= kC, "staging exceeds A and B");
  static_assert(kAlias || 2 * kBlockM * kLdStage * 4 <= kS, "staging exceeds A..D");
  static_assert(kLdP == kLdS || !kAlias, "fp32 P and dS must alias S and dP");
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// rows [row0, row0 + ROWS) of a (n_rows, D) matrix into a padded tile; rows
// past n_rows are zero so that p = 0 never meets a stale value
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int row0,
                                          int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  constexpr int kLd = Layout<T, D>::kLdIn;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

// c (16 x kBlockN, fp32) = a (16 rows) . b (kBlockN rows)^T over D
template <int D>
__device__ __forceinline__ void gemm_abt(const bf16* a, const bf16* b, float* c, int lane) {
  using L = Layout<bf16, D>;
  for (int j = 0; j < kBlockN / 16; ++j) {
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, L::kLdIn);
      wmma::load_matrix_sync(fb, b + j * 16 * L::kLdIn + kk * 16, L::kLdIn);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + j * 16, acc, L::kLdS, wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void gemm_abt(const float* a, const float* b, float* c, int lane) {
  using L = Layout<float, D>;
  for (int i = lane; i < kRowsPerWarp * kBlockN; i += 32) {
    const int r = i / kBlockN;
    const int col = i % kBlockN;
    const float* ar = a + r * L::kLdIn;
    const float* br = b + col * L::kLdIn;
    float acc = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) acc = fmaf(ar[d], br[d], acc);
    c[r * L::kLdS + col] = acc;
  }
}

// acc (16 x D, fragments) += p (16 x kBlockN) . b (kBlockN x D)
template <int D>
__device__ __forceinline__ void gemm_ab_acc(const bf16* p, const bf16* b, Acc (&acc)[D / 16]) {
  using L = Layout<bf16, D>;
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, p + kk * 16, L::kLdP);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * L::kLdIn + j * 16, L::kLdIn);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// fp32: out rows [row0, row0 + 16) of an (n_rows, D) fp32 matrix += p . b.
// Lane i always owns the same elements, so the read-modify-write needs no
// synchronisation.
template <int D>
__device__ __forceinline__ void gemm_ab_acc_out(const float* p, const float* b,
                                                float* __restrict__ out, int row0,
                                                int n_rows, int lane) {
  using L = Layout<float, D>;
  for (int i = lane; i < kRowsPerWarp * D; i += 32) {
    const int r = i / D;
    const int c = i % D;
    if (row0 + r >= n_rows) continue;
    const float* pr = p + r * L::kLdP;
    float acc = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < kBlockN; ++kk) acc = fmaf(pr[kk], b[kk * L::kLdIn + c], acc);
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

// the warp's 16 rows of fragments -> rows [row0, row0 + 16) of out (n_rows, D),
// through an fp32 staging tile in shared memory
template <int D>
__device__ __forceinline__ void store_acc(Acc (&acc)[D / 16], float* stage, bf16* out,
                                          int row0, int n_rows, int lane) {
  using L = Layout<bf16, D>;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(stage + j * 16, acc[j], L::kLdStage, wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < kRowsPerWarp * D; i += 32) {
    const int r = i / D;
    const int c = i % D;
    if (row0 + r < n_rows) store(out + (size_t)(row0 + r) * D + c, stage[r * L::kLdStage + c]);
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

// K2: grid (query tiles, heads, batch). q, dout, dq (b, h, n_q, D); k, v
// (b, h, n_kv, D); mask (b, n_kv) bytes or null; lse, delta (b, h, n_q) fp32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ mask,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq, int heads,
                        int n_q, int n_kv, float scale) {
  using L = Layout<T, D>;
  constexpr bool kF32 = L::kAlias;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::kA);
  T* do_s = reinterpret_cast<T*>(smem + L::kB);
  T* k_s = reinterpret_cast<T*>(smem + L::kC);
  T* v_s = reinterpret_cast<T*>(smem + L::kD);
  float* s_s = reinterpret_cast<float*>(smem + L::kS);
  float* dp_s = reinterpret_cast<float*>(smem + L::kDP);
  T* ds_s = reinterpret_cast<T*>(smem + L::kDS);
  int* key_s = reinterpret_cast<int*>(smem + L::kFlag);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBlockM;
  const int batch = blockIdx.z;
  const size_t bh = (size_t)batch * heads + blockIdx.y;
  const T* k_bh = k + bh * n_kv * D;
  const T* v_bh = v + bh * n_kv * D;
  T* dq_bh = dq + bh * n_q * D;
  const int wrow0 = q0 + warp * kRowsPerWarp;  // the warp's first query row
  const float inv_kv = 1.0f / (float)n_kv;

  load_tile<T, D, kBlockM>(q_s, q + bh * n_q * D, q0, n_q);
  load_tile<T, D, kBlockM>(do_s, dout + bh * n_q * D, q0, n_q);

  // lanes 2r and 2r+1 own query row r of the warp's 16, each over half the keys
  const int row = warp * kRowsPerWarp + lane / 2;
  const int half = lane % 2;
  const bool valid = q0 + row < n_q;
  const float lse_r = valid ? lse[bh * n_q + q0 + row] : 0.0f;
  const float delta_r = valid ? delta[bh * n_q + q0 + row] : 0.0f;
  const int rflag = row_flag(lse_r, valid);

  Acc acc[D / 16];
  if constexpr (kF32) {
    zero_rows<D>(reinterpret_cast<float*>(dq_bh), wrow0, n_q, lane);
  } else {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  }

  for (int k0 = 0; k0 < n_kv; k0 += kBlockN) {
    __syncthreads();  // the previous tile's K, V and flags are consumed
    load_tile<T, D, kBlockN>(k_s, k_bh, k0, n_kv);
    load_tile<T, D, kBlockN>(v_s, v_bh, k0, n_kv);
    if (threadIdx.x < kBlockN) key_s[threadIdx.x] = key_flag(mask, batch, k0 + threadIdx.x, n_kv);
    __syncthreads();

    const int wr = warp * kRowsPerWarp;
    gemm_abt<D>(q_s + wr * L::kLdIn, k_s, s_s + wr * L::kLdS, lane);
    gemm_abt<D>(do_s + wr * L::kLdIn, v_s, dp_s + wr * L::kLdS, lane);
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kBlockN / 2; ++j) {
      const int c = half * (kBlockN / 2) + j;
      float p, ds;
      p_ds(s_s[row * L::kLdS + c], dp_s[row * L::kLdS + c], rflag, key_s[c], lse_r, delta_r,
           scale, inv_kv, p, ds);
      store(ds_s + row * L::kLdP + c, ds);
    }
    __syncwarp();

    if constexpr (kF32) {
      gemm_ab_acc_out<D>(reinterpret_cast<const float*>(ds_s) + wr * L::kLdP,
                         reinterpret_cast<const float*>(k_s),
                         reinterpret_cast<float*>(dq_bh), wrow0, n_q, lane);
    } else {
      gemm_ab_acc<D>(ds_s + wr * L::kLdP, k_s, acc);
    }
  }

  if constexpr (!kF32) {
    __syncthreads();  // every warp is done with Q and dO: stage over them
    float* stage = reinterpret_cast<float*>(smem + L::kA) + warp * kRowsPerWarp * L::kLdStage;
    store_acc<D>(acc, stage, dq_bh, wrow0, n_q, lane);
  }
}

// K3: grid (key tiles, heads, batch); same operands, dk and dv (b, h, n_kv, D).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const uint8_t* __restrict__ mask,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int heads, int n_q, int n_kv, float scale) {
  using L = Layout<T, D>;
  constexpr bool kF32 = L::kAlias;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem + L::kA);
  T* v_s = reinterpret_cast<T*>(smem + L::kB);
  T* q_s = reinterpret_cast<T*>(smem + L::kC);
  T* do_s = reinterpret_cast<T*>(smem + L::kD);
  float* s_s = reinterpret_cast<float*>(smem + L::kS);
  float* dp_s = reinterpret_cast<float*>(smem + L::kDP);
  T* p_s = reinterpret_cast<T*>(smem + L::kP);
  T* ds_s = reinterpret_cast<T*>(smem + L::kDS);
  int* row_s = reinterpret_cast<int*>(smem + L::kFlag);
  int* own_key_s = reinterpret_cast<int*>(smem + L::kOwnFlag);
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  float* delta_s = reinterpret_cast<float*>(smem + L::kDelta);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kBlockM;
  const int batch = blockIdx.z;
  const size_t bh = (size_t)batch * heads + blockIdx.y;
  const T* q_bh = q + bh * n_q * D;
  const T* do_bh = dout + bh * n_q * D;
  T* dk_bh = dk + bh * n_kv * D;
  T* dv_bh = dv + bh * n_kv * D;
  const int wkey0 = k0 + warp * kRowsPerWarp;  // the warp's first key
  const float inv_kv = 1.0f / (float)n_kv;

  load_tile<T, D, kBlockM>(k_s, k + bh * n_kv * D, k0, n_kv);
  load_tile<T, D, kBlockM>(v_s, v + bh * n_kv * D, k0, n_kv);
  if (threadIdx.x < kBlockM) own_key_s[threadIdx.x] = key_flag(mask, batch, k0 + threadIdx.x, n_kv);

  Acc acc_dk[D / 16], acc_dv[D / 16];
  if constexpr (kF32) {
    zero_rows<D>(reinterpret_cast<float*>(dk_bh), wkey0, n_kv, lane);
    zero_rows<D>(reinterpret_cast<float*>(dv_bh), wkey0, n_kv, lane);
  } else {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fill_fragment(acc_dk[j], 0.0f);
      wmma::fill_fragment(acc_dv[j], 0.0f);
    }
  }
  __syncthreads();

  // lanes 2r and 2r+1 own key r of the warp's 16, each over half the query rows
  const int key = warp * kRowsPerWarp + lane / 2;
  const int half = lane % 2;
  const int kflag = own_key_s[key];

  for (int q0 = 0; q0 < n_q; q0 += kBlockN) {
    __syncthreads();  // the previous tile's Q, dO and row state are consumed
    load_tile<T, D, kBlockN>(q_s, q_bh, q0, n_q);
    load_tile<T, D, kBlockN>(do_s, do_bh, q0, n_q);
    if (threadIdx.x < kBlockN) {
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
    for (int j = 0; j < kBlockN / 2; ++j) {
      const int c = half * (kBlockN / 2) + j;
      float p, ds;
      p_ds(s_s[key * L::kLdS + c], dp_s[key * L::kLdS + c], row_s[c], kflag, lse_s[c],
           delta_s[c], scale, inv_kv, p, ds);
      store(p_s + key * L::kLdP + c, p);
      store(ds_s + key * L::kLdP + c, ds);
    }
    __syncwarp();

    if constexpr (kF32) {
      gemm_ab_acc_out<D>(reinterpret_cast<const float*>(p_s) + wk * L::kLdP,
                         reinterpret_cast<const float*>(do_s),
                         reinterpret_cast<float*>(dv_bh), wkey0, n_kv, lane);
      gemm_ab_acc_out<D>(reinterpret_cast<const float*>(ds_s) + wk * L::kLdP,
                         reinterpret_cast<const float*>(q_s),
                         reinterpret_cast<float*>(dk_bh), wkey0, n_kv, lane);
    } else {
      gemm_ab_acc<D>(p_s + wk * L::kLdP, do_s, acc_dv);
      gemm_ab_acc<D>(ds_s + wk * L::kLdP, q_s, acc_dk);
    }
  }

  if constexpr (!kF32) {
    __syncthreads();  // every warp is done with the tiles: stage over them
    float* stage = reinterpret_cast<float*>(smem + L::kA);
    float* stage_dk = stage + warp * kRowsPerWarp * L::kLdStage;
    float* stage_dv = stage + (kBlockM + warp * kRowsPerWarp) * L::kLdStage;
    store_acc<D>(acc_dk, stage_dk, dk_bh, wkey0, n_kv, lane);
    store_acc<D>(acc_dv, stage_dv, dv_bh, wkey0, n_kv, lane);
  }
}

struct Args {
  const void *q, *k, *v, *mask, *dout, *lse, *delta;
  int batch, heads, n_q, n_kv;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  using L = Layout<T, D>;
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_q + kBlockM - 1) / kBlockM, a.heads, a.batch);
  kernel<<<grid, kThreads, L::kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dq), a.heads, a.n_q, a.n_kv, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  using L = Layout<T, D>;
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_kv + kBlockM - 1) / kBlockM, a.heads, a.batch);
  kernel<<<grid, kThreads, L::kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dk), static_cast<T*>(dv), a.heads, a.n_q, a.n_kv, a.scale);
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
  if (head_dim == 64 && dtype == 1) return launch_dq<bf16, 64>(a, dq);
  if (head_dim == 128 && dtype == 1) return launch_dq<bf16, 128>(a, dq);
  if (head_dim == 64 && dtype == 0) return launch_dq<float, 64>(a, dq);
  if (head_dim == 128 && dtype == 0) return launch_dq<float, 128>(a, dq);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int vb_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                          const void* mask, const void* dout, const void* lse,
                                          const void* delta, void* dk, void* dv, int batch,
                                          int heads, int n_q, int n_kv, int head_dim,
                                          int dtype, float scale, void* stream) {
  const Args a{q, k, v, mask, dout, lse, delta, batch, heads, n_q, n_kv, scale,
               static_cast<cudaStream_t>(stream)};
  if (head_dim == 64 && dtype == 1) return launch_dkv<bf16, 64>(a, dk, dv);
  if (head_dim == 128 && dtype == 1) return launch_dkv<bf16, 128>(a, dk, dv);
  if (head_dim == 64 && dtype == 0) return launch_dkv<float, 64>(a, dk, dv);
  if (head_dim == 128 && dtype == 0) return launch_dkv<float, 128>(a, dk, dv);
  return static_cast<int>(cudaErrorInvalidValue);
}
