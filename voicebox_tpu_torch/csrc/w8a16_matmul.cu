// K4: weight-only int8 matrix product (w8a16) for Hopper (sm_90a).
//
// Replaces voicebox_tpu/ops/quant.py::_w8a16_kernel, the Pallas TPU kernel
// driven by w8a16_matmul. It computes the same function:
//   y[m, n] = cast_to_x_dtype( (sum_k x[m, k] * float(w_q[n, k])) * scale[n] )
// with the sum in fp32 and the per-output-channel scale applied after the
// sum. The int8 weight is stored as a torch Linear keeps it, (n, k_pad) row
// major, its rows padded with zeros to k_pad, a multiple of 16, once, at
// quantization; x is (m, k) row major and is never padded or copied.
//
// What bounds it on the H100. At the flagship's serving shape (m = 1532
// rows: batch 1, CFG x 2, 750 frames + 16 registers) the four products of a
// block, (k, n) = (512, 1536), (512, 512), (512, 2730) and (1365, 512), do
// 2 m n k = 0.8-4.3 GFLOP over 2.6-10.5 MB of x, int8 w, scale and y: about
// 300-400 operations per byte, at or above the card's bf16 ridge (~295), so
// on paper they are bound by the tensor cores (2.4 us for the first at
// 989 TFLOP/s). This first version is bound by latency instead: the x and w
// tiles are staged through shared memory with no overlap of loads and
// math, and the int8 -> bf16 conversion runs on the CUDA cores in the load.
//
// What the design does, and what it keeps simple:
//  * one block = one 64 x 64 tile of y, 4 warps; a loop inside the block
//    walks k in steps of 32 (the TPU's whole-k block becomes this loop);
//  * bf16 x: the int8 tile is converted to bf16 on its way into shared
//    memory (exact: |q| <= 127), then WMMA 16x16x16 bf16 with fp32 sums,
//    each warp a 32 x 32 quarter of the tile; the sums make one trip
//    through shared memory so that the scale and the cast happen in a
//    coalesced store;
//  * fp32 x: scalar FMAs over the same tiles, 32 outputs per thread, so an
//    fp32 call stays exact to fp32 rounding;
//  * ragged m, n and k are masked here: x's rows past m and columns past k
//    and w's rows past n load as zeros, and stores past m or n are skipped.
//    x takes 16-byte loads when its rows allow them (k a multiple of 8 bf16
//    or 4 floats, 16-byte aligned), else element loads (k = 1365);
//  * it launches on the caller's stream and allocates nothing.
// wgmma, TMA, a pipelined k ring and int8 kept in shared memory (half the
// bytes of a bf16 tile) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kThreads = 128;
constexpr int kBM = 64;  // rows of y per block
constexpr int kBN = 64;  // columns of y per block
constexpr int kBK = 32;  // k per step

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }
template <typename T>
__device__ __forceinline__ T from_int8(int8_t q);
template <>
__device__ __forceinline__ float from_int8<float>(int8_t q) { return static_cast<float>(q); }
template <>
__device__ __forceinline__ bf16 from_int8<bf16>(int8_t q) {
  return __float2bfloat16_rn(static_cast<float>(q));
}

// rows [m0, m0 + kBM) and columns [k0, k0 + kBK) of x (m, k) into x_s (row
// pitch LD), zero outside (m, k)
template <typename T, int LD>
__device__ __forceinline__ void load_x_tile(T* x_s, const T* __restrict__ x, int m0, int k0,
                                            int m, int k, bool vec) {
  if (vec) {  // k is a multiple of kVec: a chunk lies wholly inside k or outside it
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kChunks = kBK / kVec;
    for (int i = threadIdx.x; i < kBM * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * kVec;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m && k0 + c < k) {
        raw = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * k + k0 + c);
      }
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) x_s[r * LD + c + j] = vals[j];
    }
  } else {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i % kBK;
      T v = from_int8<T>(0);
      if (m0 + r < m && k0 + c < k) v = x[(size_t)(m0 + r) * k + k0 + c];
      x_s[r * LD + c] = v;
    }
  }
}

// rows [n0, n0 + kBN) and columns [k0, k0 + kBK) of w_q (n, k_pad) into w_s
// (row pitch LD) converted to T, zero outside (n, k_pad); k_pad is a multiple
// of 16 and the rows are 16-byte aligned, so each 16-byte chunk is whole
template <typename T, int LD>
__device__ __forceinline__ void load_w_tile(T* w_s, const int8_t* __restrict__ w_q, int n0,
                                            int k0, int n, int k_pad) {
  constexpr int kChunks = kBK / 16;
  for (int i = threadIdx.x; i < kBN * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 16;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < n && k0 + c < k_pad) {
      raw = *reinterpret_cast<const uint4*>(w_q + (size_t)(n0 + r) * k_pad + k0 + c);
    }
    const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 16; ++j) w_s[r * LD + c + j] = from_int8<T>(q[j]);
  }
}

// bf16: WMMA over the tile, each warp a 32 x 32 quarter as 2 x 2 fragments
__global__ void __launch_bounds__(kThreads)
    w8a16_bf16_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w_q,
                      const float* __restrict__ scale, bf16* __restrict__ y, int m, int n,
                      int k, int k_pad, bool vec) {
  constexpr int kLd = kBK + 8;   // 80-byte rows: 16-byte stores, 32-byte fragment rows
  constexpr int kLdC = kBN + 4;  // fp32 staging of the sums
  __shared__ __align__(128) bf16 x_s[kBM * kLd];
  __shared__ __align__(128) bf16 w_s[kBN * kLd];
  __shared__ __align__(128) float c_s[kBM * kLdC];

  const int warp = threadIdx.x / 32;
  const int warp_m = warp / 2;
  const int warp_n = warp % 2;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();  // the previous step's tiles are consumed
    load_x_tile<bf16, kLd>(x_s, x, m0, k0, m, k, vec);
    load_w_tile<bf16, kLd>(w_s, w_q, n0, k0, n, k_pad);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(a[i], x_s + (warp_m * 32 + i * 16) * kLd + kk * 16, kLd);
        // w_s holds w as [n][k]: the (k, n) operand in column-major order
        wmma::load_matrix_sync(b[i], w_s + (warp_n * 32 + i * 16) * kLd + kk * 16, kLd);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c_s + (warp_m * 32 + i * 16) * kLdC + warp_n * 32 + j * 16,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN;
    const int c = i % kBN;
    if (m0 + r < m && n0 + c < n) {
      store(y + (size_t)(m0 + r) * n + n0 + c, c_s[r * kLdC + c] * scale[n0 + c]);
    }
  }
}

// fp32: scalar FMAs; thread (tx, ty) owns rows ty + 8 i (i < 8) and columns
// tx + 16 j (j < 4) of the tile. An odd row pitch keeps the 16 distinct w
// rows a warp reads on 16 distinct banks.
__global__ void __launch_bounds__(kThreads)
    w8a16_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w_q,
                     const float* __restrict__ scale, float* __restrict__ y, int m, int n,
                     int k, int k_pad, bool vec) {
  constexpr int kLd = kBK + 1;
  __shared__ float x_s[kBM * kLd];
  __shared__ float w_s[kBN * kLd];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();
    load_x_tile<float, kLd>(x_s, x, m0, k0, m, k, vec);
    load_w_tile<float, kLd>(w_s, w_q, n0, k0, n, k_pad);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = x_s[(ty + 8 * i) * kLd + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = w_s[(tx + 16 * j) * kLd + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty + 8 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (row < m && col < n) y[(size_t)row * n + col] = acc[i][j] * scale[col];
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// x (m, k), w_q (n, k_pad) int8 with k_pad a multiple of 16 and k <= k_pad,
// scale (n,) fp32, y (m, n) in x's dtype; all contiguous, x, w_q 16-byte
// aligned. Returns 0 or the cudaError_t of the launch.
extern "C" int vb_w8a16_matmul(const void* x, const void* w_q, const void* scale, void* y,
                               int m, int n, int k, int k_pad, int dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k > k_pad || k_pad % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w_q) % 16 != 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  const int elems_per_16_bytes = dtype == 1 ? 8 : 4;
  const bool vec = k % elems_per_16_bytes == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (dtype == 1) {
    w8a16_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const int8_t*>(w_q),
        static_cast<const float*>(scale), static_cast<bf16*>(y), m, n, k, k_pad, vec);
  } else {
    w8a16_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w_q),
        static_cast<const float*>(scale), static_cast<float*>(y), m, n, k, k_pad, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
