// K1: attention forward with an online softmax, for Hopper (sm_90a).
//
// Replaces voicebox_tpu/ops/flash_attention.py::_flash_kernel, the Pallas TPU
// kernel driven by _flash_forward. It computes the same function, not the
// same blocks: fp32 logits times `scale`, masked keys filled with
// -0.7 * FLT_MAX, a running max and sum per query row, out = acc / l in the
// input dtype, and lse = m + log(l) in fp32 per row.
//
// What bounds it on the H100. At the serving shape (CFG batch 2, 4 heads,
// 766 rows, head dim 128, bf16) one call does 2.4 GFLOP over 6.3 MB of q, k,
// v and out: about 380 FLOP per byte, above the card's bf16 ridge (~295), so
// on paper it is bound by the tensor cores. This first version is bound by
// latency instead: the logits and the output accumulator make a round trip
// through shared memory on every K/V tile (WMMA fragments are opaque, so the
// per-row rescale happens there), the tile loads are not overlapped with
// the math, and the grid of 12 x 4 x 2 = 96 blocks leaves 36 of 132 SMs idle.
//
// What the design does about it, and what it keeps simple:
//  * one block = one (batch, head, 64-row query tile), 4 warps of 16 rows;
//    a loop inside the block streams 64-key K/V tiles through shared memory
//    (the TPU's sequential grid axis becomes this loop);
//  * bf16: both products on the tensor cores (WMMA 16x16x16, fp32 sums);
//    fp32: scalar FMAs, so an fp32 call stays exact to fp32 rounding;
//  * ragged n and kv are masked here: rows past n are not stored, keys past
//    kv get p = 0 (and zeros in shared memory), so no operand is padded;
//  * the mask fill stays fp32. A row whose keys are all masked gets the same
//    logit on every real key, so it comes out as mean(V) over the real
//    keys, as the plain softmax gives;
//  * it launches on the caller's stream and allocates nothing.
// wgmma, TMA and a pipelined K/V ring are later work.

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
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 64;                      // keys per K/V tile
constexpr float kMaskFill = -0.7f * 3.402823466e38f;

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

// Shared-memory layout, in bytes. Row pitches are padded: by 8 bf16 (16 B)
// or 4 floats, which keeps WMMA's 32-byte alignment and 16-byte vector stores.
template <typename T, int D>
struct Layout {
  static constexpr int kPad = sizeof(T) == 2 ? 8 : 4;
  static constexpr int kLdIn = D + kPad;       // q, k, v tiles (input dtype)
  static constexpr int kLdS = kBlockK + 4;     // logits (fp32)
  static constexpr int kLdP = kBlockK + kPad;  // probabilities (input dtype)
  static constexpr int kLdO = D + 4;           // output accumulator (fp32)
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + align128(kBlockQ * kLdIn * (int)sizeof(T));
  static constexpr int kV = kK + align128(kBlockK * kLdIn * (int)sizeof(T));
  static constexpr int kS = kV + align128(kBlockK * kLdIn * (int)sizeof(T));
  static constexpr int kP = kS + align128(kBlockQ * kLdS * 4);
  static constexpr int kO = kP + align128(kBlockQ * kLdP * (int)sizeof(T));
  static constexpr int kAlpha = kO + align128(kBlockQ * kLdO * 4);
  static constexpr int kL = kAlpha + align128(kBlockQ * 4);
  static constexpr int kKeep = kL + align128(kBlockQ * 4);
  static constexpr int kBytes = kKeep + align128(kBlockK * 4);
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// rows [row0, row0 + ROWS) of a (n_rows, D) matrix into a padded tile;
// rows past n_rows are zero so that p = 0 never meets a stale value
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

// S = Q K^T for this warp's 16 rows and the tile's 64 keys, unscaled fp32
template <int D>
__device__ __forceinline__ void scores(const bf16* q_s, const bf16* k_s, float* s_s,
                                       int warp, int lane) {
  using L = Layout<bf16, D>;
  for (int c = 0; c < kBlockK / 16; ++c) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, q_s + warp * 16 * L::kLdIn + kk * 16, L::kLdIn);
      wmma::load_matrix_sync(b, k_s + c * 16 * L::kLdIn + kk * 16, L::kLdIn);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(s_s + warp * 16 * L::kLdS + c * 16, acc, L::kLdS,
                            wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void scores(const float* q_s, const float* k_s, float* s_s,
                                       int warp, int lane) {
  using L = Layout<float, D>;
  for (int i = lane; i < kRowsPerWarp * kBlockK; i += 32) {
    const int r = warp * kRowsPerWarp + i / kBlockK;
    const int c = i % kBlockK;
    const float* qr = q_s + r * L::kLdIn;
    const float* kr = k_s + c * L::kLdIn;
    float acc = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
    s_s[r * L::kLdS + c] = acc;
  }
}

// O = O * alpha + P V for this warp's 16 rows
template <int D>
__device__ __forceinline__ void accumulate_pv(const bf16* p_s, const bf16* v_s, float* o_s,
                                              const float* alpha_s, int warp, int lane) {
  using L = Layout<bf16, D>;
  for (int i = lane; i < kRowsPerWarp * D; i += 32) {
    const int r = warp * kRowsPerWarp + i / D;
    o_s[r * L::kLdO + i % D] *= alpha_s[r];
  }
  __syncwarp();
  for (int j = 0; j < D / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* o_tile = o_s + warp * 16 * L::kLdO + j * 16;
    wmma::load_matrix_sync(acc, o_tile, L::kLdO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, p_s + warp * 16 * L::kLdP + kk * 16, L::kLdP);
      wmma::load_matrix_sync(b, v_s + kk * 16 * L::kLdIn + j * 16, L::kLdIn);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o_tile, acc, L::kLdO, wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void accumulate_pv(const float* p_s, const float* v_s, float* o_s,
                                              const float* alpha_s, int warp, int lane) {
  using L = Layout<float, D>;
  for (int i = lane; i < kRowsPerWarp * D; i += 32) {
    const int r = warp * kRowsPerWarp + i / D;
    const int c = i % D;
    const float* pr = p_s + r * L::kLdP;
    float acc = o_s[r * L::kLdO + c] * alpha_s[r];
#pragma unroll 8
    for (int kk = 0; kk < kBlockK; ++kk) acc = fmaf(pr[kk], v_s[kk * L::kLdIn + c], acc);
    o_s[r * L::kLdO + c] = acc;
  }
}

// grid: (query tiles, heads, batch); q/out (b, h, n_q, D), k/v (b, h, n_kv, D),
// mask (b, n_kv) bytes or null, lse (b, h, n_q) fp32; all contiguous
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const uint8_t* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse, int heads, int n_q,
                     int n_kv, float scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::kQ);
  T* k_s = reinterpret_cast<T*>(smem + L::kK);
  T* v_s = reinterpret_cast<T*>(smem + L::kV);
  float* s_s = reinterpret_cast<float*>(smem + L::kS);
  T* p_s = reinterpret_cast<T*>(smem + L::kP);
  float* o_s = reinterpret_cast<float*>(smem + L::kO);
  float* alpha_s = reinterpret_cast<float*>(smem + L::kAlpha);
  float* l_s = reinterpret_cast<float*>(smem + L::kL);
  int* keep_s = reinterpret_cast<int*>(smem + L::kKeep);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const int batch = blockIdx.z;
  const size_t bh = (size_t)batch * heads + blockIdx.y;
  const T* k_bh = k + bh * n_kv * D;
  const T* v_bh = v + bh * n_kv * D;

  load_tile<T, D, kBlockQ>(q_s, q + bh * n_q * D, q0, n_q);
  for (int i = threadIdx.x; i < kBlockQ * L::kLdO; i += kThreads) o_s[i] = 0.0f;

  // lanes 2r and 2r+1 own row r of the warp's 16, each over half the keys
  const int row = warp * kRowsPerWarp + lane / 2;
  const int half = lane % 2;
  float m_run = -INFINITY;
  float l_run = 0.0f;

  for (int k0 = 0; k0 < n_kv; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K, V and keep flags are consumed
    load_tile<T, D, kBlockK>(k_s, k_bh, k0, n_kv);
    load_tile<T, D, kBlockK>(v_s, v_bh, k0, n_kv);
    if (threadIdx.x < kBlockK) {
      const int key = k0 + threadIdx.x;
      // 1 keep, 0 masked (fill), -1 past the end (p = 0)
      keep_s[threadIdx.x] =
          key >= n_kv ? -1 : (mask == nullptr || mask[(size_t)batch * n_kv + key]) ? 1 : 0;
    }
    __syncthreads();

    scores<D>(q_s, k_s, s_s, warp, lane);
    __syncwarp();

    float s[kBlockK / 2];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK / 2; ++j) {
      const int c = half * (kBlockK / 2) + j;
      const int keep = keep_s[c];
      float x = s_s[row * L::kLdS + c] * scale;
      if (keep == 0) x = kMaskFill;
      if (keep < 0) x = -INFINITY;
      s[j] = x;
      m_tile = fmaxf(m_tile, x);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    // every tile holds at least one key before n_kv, so m_new is finite
    const float m_new = fmaxf(m_run, m_tile);
    const float alpha = expf(m_run - m_new);
    float p_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kBlockK / 2; ++j) {
      const float p = expf(s[j] - m_new);
      store(p_s + row * L::kLdP + half * (kBlockK / 2) + j, p);
      p_sum += p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    l_run = l_run * alpha + p_sum;
    m_run = m_new;
    if (half == 0) alpha_s[row] = alpha;
    __syncwarp();

    accumulate_pv<D>(p_s, v_s, o_s, alpha_s, warp, lane);
    __syncwarp();
  }

  if (half == 0) {
    l_s[row] = l_run;
    if (q0 + row < n_q) lse[bh * n_q + q0 + row] = m_run + logf(l_run);
  }
  __syncwarp();

  T* out_bh = out + bh * n_q * D;
  for (int i = lane; i < kRowsPerWarp * D; i += 32) {
    const int r = warp * kRowsPerWarp + i / D;
    const int c = i % D;
    if (q0 + r < n_q) store(out_bh + (size_t)(q0 + r) * D + c, o_s[r * L::kLdO + c] / l_s[r]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   void* lse, int batch, int heads, int n_q, int n_kv, float scale,
                   cudaStream_t stream) {
  using L = Layout<T, D>;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + kBlockQ - 1) / kBlockQ, heads, batch);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), static_cast<float*>(lse),
      heads, n_q, n_kv, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns 0 or the cudaError_t of the launch.
extern "C" int vb_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* mask, void* out, void* lse, int batch,
                                      int heads, int n_q, int n_kv, int head_dim, int dtype,
                                      float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (head_dim == 64 && dtype == 1) {
    err = launch<bf16, 64>(q, k, v, mask, out, lse, batch, heads, n_q, n_kv, scale, s);
  } else if (head_dim == 128 && dtype == 1) {
    err = launch<bf16, 128>(q, k, v, mask, out, lse, batch, heads, n_q, n_kv, scale, s);
  } else if (head_dim == 64 && dtype == 0) {
    err = launch<float, 64>(q, k, v, mask, out, lse, batch, heads, n_q, n_kv, scale, s);
  } else if (head_dim == 128 && dtype == 0) {
    err = launch<float, 128>(q, k, v, mask, out, lse, batch, heads, n_q, n_kv, scale, s);
  }
  return static_cast<int>(err);
}
