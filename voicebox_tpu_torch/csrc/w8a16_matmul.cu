// K4: weight-only int8 matrix product (w8a16) for Hopper (sm_90a).
//
// Replaces voicebox_tpu/ops/quant.py::_w8a16_kernel, the Pallas TPU kernel
// driven by w8a16_matmul. It computes the same function:
//   y[m, n] = cast_to_x_dtype( (sum_k x[m, k] * float(w_q[n, k])) * scale[n] )
// with the sum in fp32 and the per-output-channel scale applied after the
// sum. The int8 weight is stored as a torch Linear keeps it, (n, k_pad) row
// major, its rows padded with zeros to k_pad, a multiple of 16, once, at
// quantization. x is (m, k) with its rows `ldx` elements apart and is never
// padded or copied here; y is (m, n) row major.
//
// What bounds it on the H100. The quantized engine's products, (k, n) =
// (512, 1536), (512, 512), (512, 2730) and (1365, 512) at m = 544, 2112 and
// 8320 rows, do 2 m n k = 0.3-23 GFLOP over 0.8-24 MB: at m = 8320 about
// 700-1000 operations per byte, above the card's bf16 ridge (~295), so the
// tensor cores bound them (4.4-23.5 us at 989 TFLOP/s); at m = 544 the
// bounds are 1.6 us or less and a launch is bound by its latency.
//
// The bf16 design: wgmma with the operands swapped. wgmma takes only A from
// registers, so the weight is A and each consumer warpgroup computes a
// 64-channel x BN-row tile of y^T = W_q x^T:
//  * a producer warp keeps a 4-stage ring of TMA loads in flight, guarded
//    by full/empty mbarriers: per stage the int8 weight tile (BM channels x
//    64 k-bytes, 64-byte swizzle) and the bf16 x tile (BN rows x 64 k,
//    128-byte swizzle), both from 2-D tensor maps that zero-fill past k, n
//    and m; the weight stays int8 in shared memory (half a bf16 tile);
//  * each consumer thread reads its A fragment's int8 bytes with 4-byte
//    loads (the 64-byte swizzle puts the 8 rows a warp reads on distinct
//    banks), picks its byte pairs with one byte permute and converts them in
//    registers: the byte ^ 0x80 in the mantissa of 2^23, minus 2^23 + 128,
//    is q exactly, and its upper 16 bits are bf16 q exactly (|q| <= 127);
//  * x is wgmma's B, read from shared memory K-major (x's row-major layout
//    is K-major for this product); m64nBNk16, 4 a stage, with fp32 sums in
//    registers; the next stage's weight converts while they run;
//  * epilogue: the scale is per channel, a row of the accumulator, so one
//    multiply a value; the bf16 tile is transposed through shared memory
//    (padded rows, no bank conflicts) and stored as coalesced rows of y,
//    16 bytes a store where n allows it (n = 2730 gives 4-byte stores);
//    rows past m and channels past n are not stored;
//  * three tiles of y (rows x channels): 256 x 128 (two consumer
//    warpgroups, 1 block an SM), 128 x 64 and 64 x 64 (one), chosen per
//    shape by the host (`k4_tile` in ops/quant.py) so that the small
//    engine shapes still cover the SMs; the larger tile converts each weight
//    byte once per 256 rows of x instead of 64.
// x's rows must be 16-byte aligned for TMA (ldx a multiple of 8): the
// port's GEGLU writes the feed-forward's 1365-wide activation at a row pitch
// of 1376 for it. The last k-stage reads x past k as zeros, never the
// memory there (a pitched row's tail, or another row).
//
// fp32 x runs every decoder matmul and the vocabulary head of the
// TextToSemantic decode under generate(quantize="w8a16"): m = 1 (a plain
// step), 4 (a draft step) and 24 (a verify chunk) rows at (k, n) = (512,
// 502-2730) and (1365, 512). Hopper has no exact fp32 tensor-core mode
// (TF32 keeps ~3 digits), so the sums are FMAs on the CUDA cores. At these
// shapes the bound is the int8 weight's bytes (0.08-0.42 us at m = 1) or,
// at m = 24, the FMAs (~0.5 us), both far below a launch's latency: what
// counts is covering the SMs, keeping the weight's bytes in flight and
// doing no work for rows that do not exist. Two routes, picked per shape
// by the host (`k4_tile` in ops/quant.py):
//  * GEMV (m <= 128): a block owns 4, 8 or 16 output channels and every
//    row of x. A warp owns 4 channels, one 512-wide slab of k and one group
//    of 8 rows: each lane holds 16 int8 weight bytes of each channel in
//    registers (one 16-byte load, neighbouring lanes on neighbouring
//    addresses, issued before x is staged), converts each value once for
//    the group's rows and uses each x value it reads from shared memory for
//    the 4 channels. x (up to 32 rows) is staged once by cp.async as fp32:
//    16-byte copies where its row pitch and base allow, zero-filled past k
//    by the copy's source size, so no pitch column is ever read. The
//    lanes' 32 sums meet in a transposing butterfly of 31 shuffles and,
//    where k needs several slabs, the warps' in shared memory in slab
//    order: no atomics, the same bits on every launch. The scale multiplies
//    after the sum; channels past n and rows past m are not written. The
//    host takes the widest block that keeps at most 4 warps on a row group
//    and 12 in all: on the H100 that beat blocks narrow enough to cover
//    every SM at every decode shape (32 blocks at n = 512 included), as
//    each block stages all of x.
//  * tiled (m > 128): scalar FMAs over 64 x 64 tiles of y staged through
//    shared memory, 16-byte x loads wherever the row pitch allows.
// Both dtypes launch on the caller's stream and allocate nothing.

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ bf16: layout

constexpr int kBK = 64;     // k per stage: 64 weight bytes, 128 x bytes a row
constexpr int kStages = 4;  // ring depth

template <int NWG, int BN>
struct K4Smem {
  static constexpr int kBM = NWG * 64;      // channels per block
  static constexpr int kWTile = kBM * kBK;  // int8
  static constexpr int kXTile = BN * kBK * 2;
  static constexpr int kW = 0;
  static constexpr int kX = kStages * kWTile;  // a multiple of 1024
  static constexpr int kRing = kX + kStages * kXTile;
  // the epilogue's bf16 y tile, BN rows x kBM channels, padded by 16 bytes
  // a row, in the ring once every stage is consumed
  static constexpr int kLdY = kBM + 8;
  static constexpr int kBytes = kRing > BN * kLdY * 2 ? kRing : BN * kLdY * 2;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
  // as in K1: two consumers take a producer warpgroup (setmaxnreg), one a warp
  static constexpr int kProducerThreads = NWG == 2 ? 128 : 32;
  static constexpr int kThreads = NWG * 128 + kProducerThreads;
};

// four int8 codes -> four floats, exact: the byte ^ 0x80 (q + 128) in the
// mantissa of 2^23, minus 2^23 + 128
__device__ __forceinline__ void int8x4_to_f32(uint32_t v, float (&f)[4]) {
  const uint32_t u = v ^ 0x80808080u;
  constexpr uint32_t kMagic = 0x4B000000u;  // 2^23
  constexpr float kBias = 8388736.0f;       // 2^23 + 128
  f[0] = __uint_as_float(__byte_perm(u, kMagic, 0x7650)) - kBias;
  f[1] = __uint_as_float(__byte_perm(u, kMagic, 0x7651)) - kBias;
  f[2] = __uint_as_float(__byte_perm(u, kMagic, 0x7652)) - kBias;
  f[3] = __uint_as_float(__byte_perm(u, kMagic, 0x7653)) - kBias;
}

// four int8 codes -> two bf16x2 registers (bytes 0, 1 and bytes 2, 3), exact
// (|q| <= 127: the upper 16 bits of the float are bf16 q)
__device__ __forceinline__ void int8x4_to_bf16(uint32_t v, uint32_t& lo, uint32_t& hi) {
  float f[4];
  int8x4_to_f32(v, f);
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// The A fragments of one stage (4 steps of k16) for this thread: in wgmma's
// layout, rows `row` and `row` + 8 of the warpgroup's 64 and, in each k16
// step, k = 2q, 2q + 1 (registers 0, 1) and 2q + 8, 2q + 9 (2, 3). The
// weight tile has 64-byte rows under TMA's 64-byte swizzle: the 16-byte
// chunk c of row r sits at chunk c ^ ((r >> 1) & 3).
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const uint8_t* w_tile, int row,
                                       int q) {
  const uint32_t sel = (q & 1) ? 0x7632u : 0x5410u;
  const int word = 4 * (q >> 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    const uint8_t* base = w_tile + r * kBK + word;
    const int sw = (r >> 1) & 3;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const uint8_t* chunk = base + ((ks ^ sw) << 4);
      const uint32_t lo = *reinterpret_cast<const uint32_t*>(chunk);
      const uint32_t hi = *reinterpret_cast<const uint32_t*>(chunk + 8);
      int8x4_to_bf16(__byte_perm(lo, hi, sel), a[ks][h], a[ks][2 + h]);
    }
  }
}

// ------------------------------------------------------------ bf16: kernel

// grid: (row tiles of BN, channel tiles of NWG x 64). Warpgroups 0..NWG-1
// consume; warp 4 NWG issues the loads. w through a 2-D map (k, n) of
// k_pad-byte rows, x through a 2-D map (k, m) of ldx-element rows.
template <int NWG, int BN>
__global__ void __launch_bounds__(K4Smem<NWG, BN>::kThreads, 1)
    w8a16_bf16(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
               const float* __restrict__ scale, bf16* __restrict__ y, int m, int n, int k,
               int y_vec) {
  using L = K4Smem<NWG, BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x * BN;
  const int n0 = blockIdx.y * L::kBM;
  const int n_kb = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // producer: the weight and x tiles of each k-stage through the ring
    if constexpr (NWG == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == NWG * 128) {
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % kStages;
        mbar_wait(&empty_bar[s], ((kb / kStages) & 1) ^ 1);
        mbar_expect_tx(&full_bar[s], L::kWTile + L::kXTile);
        tma_load_2d(smem + L::kW + s * L::kWTile, &tm_w, &full_bar[s], kb * kBK, n0);
        tma_load_2d(smem + L::kX + s * L::kXTile, &tm_x, &full_bar[s], kb * kBK, m0);
      }
    }
    return;
  }

  // consumer warpgroup wg: channels [64 wg, 64 wg + 64) of the block. In
  // the accumulator's layout this thread owns channels row and row + 8 and,
  // in each 8-row block i of x, rows 8 i + 2 q + {0, 1}: element [4 i + 2 j + c].
  if constexpr (NWG == 2) setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int q = lane % 4;
  const int row = wg * 64 + (tid / 32) * 16 + lane / 4;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  uint32_t a_cur[4][4], a_nxt[4][4];

  mbar_wait(&full_bar[0], 0);
  load_a(a_cur, smem + L::kW, row, q);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int s = kb % kStages;
    const uint32_t x_base = smem_u32(smem + L::kX + s * L::kXTile);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      wgmma_rs_k<BN>(acc, a_cur[ks], sw128_desc(x_base + ks * 32, 16, 1024));
    }
    wgmma_commit();
    if (kb + 1 < n_kb) {  // the next stage's weight converts while the products run
      const int s1 = (kb + 1) % kStages;
      mbar_wait(&full_bar[s1], ((kb + 1) / kStages) & 1);
      load_a(a_nxt, smem + L::kW + s1 * L::kWTile, row, q);
    }
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) fence_regs(a_cur[ks]);
    mbar_arrive(&empty_bar[s]);  // this thread's reads of the stage are done
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) a_cur[ks][r] = a_nxt[ks][r];
    }
  }

  // epilogue: scale, bf16, the tile transposed through shared memory once
  // every consumer is done with the ring
  float sc[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int ch = n0 + row + 8 * j;
    sc[j] = ch < n ? scale[ch] : 0.0f;
  }
  named_bar_sync(1, NWG * 128);
  bf16* tile = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        tile[(8 * i + 2 * q + c) * L::kLdY + row + 8 * j] =
            __float2bfloat16_rn(acc[4 * i + 2 * j + c] * sc[j]);
      }
    }
  }
  named_bar_sync(1, NWG * 128);

  const int t = threadIdx.x;
  constexpr int kT = NWG * 128;
  if (y_vec == 8) {
    constexpr int kChunks = L::kBM / 8;
    for (int idx = t; idx < BN * kChunks; idx += kT) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 8;
      if (m0 + r < m && n0 + c < n) {
        *reinterpret_cast<uint4*>(y + (size_t)(m0 + r) * n + n0 + c) =
            *reinterpret_cast<const uint4*>(tile + r * L::kLdY + c);
      }
    }
  } else if (y_vec == 2) {
    constexpr int kPairs = L::kBM / 2;
    for (int idx = t; idx < BN * kPairs; idx += kT) {
      const int r = idx / kPairs;
      const int c = (idx % kPairs) * 2;
      if (m0 + r < m && n0 + c < n) {
        *reinterpret_cast<uint32_t*>(y + (size_t)(m0 + r) * n + n0 + c) =
            *reinterpret_cast<const uint32_t*>(tile + r * L::kLdY + c);
      }
    }
  } else {
    for (int idx = t; idx < BN * L::kBM; idx += kT) {
      const int r = idx / L::kBM;
      const int c = idx % L::kBM;
      if (m0 + r < m && n0 + c < n) y[(size_t)(m0 + r) * n + n0 + c] = tile[r * L::kLdY + c];
    }
  }
}

// ------------------------------------------------------ fp32: GEMV route

constexpr int kGemvRows = 8;   // rows of x a warp sums together (a row group)
constexpr int kGemvCh = 4;     // output channels a warp
constexpr int kSlab = 512;     // k of a warp's slab: 32 lanes x 16 weight bytes
constexpr int kMaxKWarps = 3;  // slabs a panel: k_pad <= 1536 (both decode k) in one panel
constexpr int kMaxRWarps = 4;  // row groups staged at once: m <= 32 rows in one stage
constexpr int kGemvMaxWarps = 12;  // ~140 registers a thread: 12 warps fit an SM's registers
// x's stage: up to 32 rows x 1536 fp32
constexpr int kGemvMaxSmem = kGemvRows * kMaxRWarps * kSlab * kMaxKWarps * 4;

// `bytes` (0-16) of global memory into 16 shared bytes, the rest zeros
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
// one float, or a zero where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// The 16-byte chunk c of a staged x row is stored at chunk c ^ ((c >> 3) &
// 3). Lane l reads chunks 4 l + q (q < 4) of its slab; the 8 lanes of a
// quarter-warp then hit 8 distinct 16-byte bank groups.
__device__ __forceinline__ int x_chunk(int c) { return c ^ ((c >> 3) & 3); }

// One step of the lanes' butterfly over 32 sums a lane: at lane offset H a
// lane keeps the half of its first 2 H sums picked by bit H of its lane
// index and adds its partner's copy of that half; after the step at offset
// 1, lane l holds the whole sum of index l (31 shuffles, not 32 x 5)
template <int H>
__device__ __forceinline__ void transpose_reduce(float (&v)[32], int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
  if constexpr (H > 1) transpose_reduce<H / 2>(v, lane);
}

// grid: ceil(n / (4 c_warps)) blocks of c_warps x k_warps x r_warps warps;
// warp (rw, cw, kw) owns channels ch0 + [0, 4), the slab kw of each panel
// of 512 k_warps columns and the row group rw of each stage of 8 r_warps
// rows. Dynamic shared memory: a stage's rows x the panel, fp32.
__global__ void __launch_bounds__(32 * kGemvMaxWarps)
    w8a16_f32_gemv(const float* __restrict__ x, const int8_t* __restrict__ w_q,
                   const float* __restrict__ scale, float* __restrict__ y, int m, int n, int k,
                   int k_pad, int ldx, int vec, int k_warps, int c_warps) {
  constexpr int kV = kGemvRows * kGemvCh;  // sums a lane holds, one per lane after the butterfly
  static_assert(kV == 32, "the butterfly leaves one sum a lane");
  extern __shared__ float4 xs[];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int kw = warp % k_warps;
  const int cw = warp / k_warps % c_warps;
  const int rw = warp / (k_warps * c_warps);
  const int r_warps = blockDim.x / 32 / (k_warps * c_warps);
  const int ch0 = (blockIdx.x * c_warps + cw) * kGemvCh;
  const int panel = kSlab * k_warps;
  const int panel4 = panel / 4;  // 16-byte chunks of a staged row
  const int stage = kGemvRows * r_warps;

  for (int s0 = 0; s0 < m; s0 += stage) {
    const int staged = min(stage, m - s0);
    const int g0 = kGemvRows * rw;                          // this warp's rows in the stage
    const int rows = max(0, min(kGemvRows, staged - g0));  // uniform over the warp
    float acc[kGemvRows][kGemvCh];
#pragma unroll
    for (int r = 0; r < kGemvRows; ++r)
#pragma unroll
      for (int c = 0; c < kGemvCh; ++c) acc[r][c] = 0.0f;

    for (int p0 = 0; p0 < k_pad; p0 += panel) {
      // this lane's 16 weight bytes of each channel, in flight while x stages
      const int kc = p0 + kSlab * kw + 16 * lane;
      uint4 wq[kGemvCh];
#pragma unroll
      for (int c = 0; c < kGemvCh; ++c) {
        wq[c] = make_uint4(0u, 0u, 0u, 0u);
        if (ch0 + c < n && kc < k_pad) {
          wq[c] = __ldg(reinterpret_cast<const uint4*>(w_q + (size_t)(ch0 + c) * k_pad + kc));
        }
      }
      __syncthreads();  // every read of the previous stage or panel is done
      for (int i = threadIdx.x; i < staged * panel4; i += blockDim.x) {
        const int r = i / panel4;
        const int c4 = i % panel4;
        const int col = p0 + 4 * c4;
        const int left = k - col;  // x's columns from col on; none past k is read
        const float* src = x + (size_t)(s0 + r) * ldx + col;
        float* dst = reinterpret_cast<float*>(xs + r * panel4 + x_chunk(c4));
        if (vec) {
          cp_async16_n(dst, left > 0 ? src : x, 4 * max(0, min(left, 4)));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) cp_async4(dst + e, left > e ? src + e : x, left > e);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float wf[kGemvCh][4];
#pragma unroll
        for (int c = 0; c < kGemvCh; ++c) {
          const uint32_t word = q == 0 ? wq[c].x : q == 1 ? wq[c].y : q == 2 ? wq[c].z : wq[c].w;
          int8x4_to_f32(word, wf[c]);
        }
        const float4* xq = xs + g0 * panel4 + x_chunk(128 * kw + 4 * lane + q);
#pragma unroll
        for (int r = 0; r < kGemvRows; ++r) {
          if (r < rows) {
            const float4 xv = xq[r * panel4];
#pragma unroll
            for (int c = 0; c < kGemvCh; ++c) {
              acc[r][c] = fmaf(xv.x, wf[c][0], acc[r][c]);
              acc[r][c] = fmaf(xv.y, wf[c][1], acc[r][c]);
              acc[r][c] = fmaf(xv.z, wf[c][2], acc[r][c]);
              acc[r][c] = fmaf(xv.w, wf[c][3], acc[r][c]);
            }
          }
        }
      }
    }

    // the 32 lanes' sums: lane l ends with the sum of row l / 4, channel l % 4
    float v[kV];
#pragma unroll
    for (int r = 0; r < kGemvRows; ++r)
#pragma unroll
      for (int c = 0; c < kGemvCh; ++c) v[r * kGemvCh + c] = acc[r][c];
    transpose_reduce<kV / 2>(v, lane);
    float sum = v[0];
    if (k_warps > 1) {  // the slabs' sums, added in slab order
      __syncthreads();  // every warp is done with xs
      float* red = reinterpret_cast<float*>(xs);
      const int owner = rw * c_warps + cw;  // the warps that share these sums
      const int owners = r_warps * c_warps;
      if (kw > 0) red[((kw - 1) * owners + owner) * 32 + lane] = sum;
      __syncthreads();
      if (kw == 0) {
        for (int j = 1; j < k_warps; ++j) sum += red[((j - 1) * owners + owner) * 32 + lane];
      }
    }
    const int ch = ch0 + lane % kGemvCh;
    if (kw == 0 && lane / kGemvCh < rows && ch < n) {
      y[(size_t)(s0 + g0 + lane / kGemvCh) * n + ch] = sum * scale[ch];
    }
  }
}

// ------------------------------------------------------ fp32: tiled route

constexpr int kF32Threads = 128;
constexpr int kF32BM = 64;  // rows of y per block
constexpr int kF32BN = 64;  // columns of y per block
constexpr int kF32BK = 32;  // k per step

// rows [m0, m0 + 64) and columns [k0, k0 + 32) of x (rows ldx apart) into
// x_s (row pitch LD), zero outside (m, k)
template <int LD>
__device__ __forceinline__ void load_x_tile(float* x_s, const float* __restrict__ x, int m0,
                                            int k0, int m, int k, int ldx, bool vec) {
  if (vec) {  // 16-byte loads inside k; the chunk that holds k's end loads its valid floats alone
    constexpr int kChunks = kF32BK / 4;
    for (int i = threadIdx.x; i < kF32BM * kChunks; i += kF32Threads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (m0 + r < m && k0 + c < k) {
        const float* src = x + (size_t)(m0 + r) * ldx + k0 + c;
        if (k0 + c + 4 <= k) {
          v = *reinterpret_cast<const float4*>(src);
        } else {
          v.x = src[0];
          if (k0 + c + 1 < k) v.y = src[1];
          if (k0 + c + 2 < k) v.z = src[2];
        }
      }
      x_s[r * LD + c] = v.x;
      x_s[r * LD + c + 1] = v.y;
      x_s[r * LD + c + 2] = v.z;
      x_s[r * LD + c + 3] = v.w;
    }
  } else {
    for (int i = threadIdx.x; i < kF32BM * kF32BK; i += kF32Threads) {
      const int r = i / kF32BK;
      const int c = i % kF32BK;
      float v = 0.0f;
      if (m0 + r < m && k0 + c < k) v = x[(size_t)(m0 + r) * ldx + k0 + c];
      x_s[r * LD + c] = v;
    }
  }
}

// rows [n0, n0 + 64) and columns [k0, k0 + 32) of w_q (n, k_pad) into w_s
// (row pitch LD) as floats, zero outside (n, k_pad); k_pad is a multiple of
// 16 and the rows are 16-byte aligned, so each 16-byte chunk is whole
template <int LD>
__device__ __forceinline__ void load_w_tile(float* w_s, const int8_t* __restrict__ w_q, int n0,
                                            int k0, int n, int k_pad) {
  constexpr int kChunks = kF32BK / 16;
  for (int i = threadIdx.x; i < kF32BN * kChunks; i += kF32Threads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 16;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < n && k0 + c < k_pad) {
      raw = *reinterpret_cast<const uint4*>(w_q + (size_t)(n0 + r) * k_pad + k0 + c);
    }
    const int8_t* qv = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 16; ++j) w_s[r * LD + c + j] = static_cast<float>(qv[j]);
  }
}

// fp32: scalar FMAs; thread (tx, ty) owns rows ty + 8 i (i < 8) and columns
// tx + 16 j (j < 4) of the tile. An odd row pitch keeps the 16 distinct w
// rows a warp reads on 16 distinct banks.
__global__ void __launch_bounds__(kF32Threads)
    w8a16_f32(const float* __restrict__ x, const int8_t* __restrict__ w_q,
              const float* __restrict__ scale, float* __restrict__ y, int m, int n, int k,
              int k_pad, int ldx, bool vec) {
  constexpr int kLd = kF32BK + 1;
  __shared__ float x_s[kF32BM * kLd];
  __shared__ float w_s[kF32BN * kLd];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * kF32BM;
  const int n0 = blockIdx.y * kF32BN;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kF32BK) {
    __syncthreads();
    load_x_tile<kLd>(x_s, x, m0, k0, m, k, ldx, vec);
    load_w_tile<kLd>(w_s, w_q, n0, k0, n, k_pad);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kF32BK; ++kk) {
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

// ------------------------------------------------------------------- host

template <int NWG, int BN>
cudaError_t launch_bf16(const void* x, const void* w_q, const void* scale, void* y, int m,
                        int n, int k, int k_pad, int ldx, cudaStream_t stream) {
  using L = K4Smem<NWG, BN>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tm_w, tm_x;
  if (!encode_2d(fn, &tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w_q, k, n, k_pad, kBK, L::kBM,
                 CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode_2d(fn, &tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, k, m, 2ll * ldx, kBK, BN,
                 CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = w8a16_bf16<NWG, BN>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  const uintptr_t y_addr = reinterpret_cast<uintptr_t>(y);
  const int y_vec = n % 8 == 0 && y_addr % 16 == 0 ? 8 : n % 2 == 0 && y_addr % 4 == 0 ? 2 : 1;
  const dim3 grid((m + BN - 1) / BN, (n + L::kBM - 1) / L::kBM);
  kernel<<<grid, L::kThreads, L::kAlloc, stream>>>(tm_w, tm_x, static_cast<const float*>(scale),
                                                   static_cast<bf16*>(y), m, n, k, y_vec);
  return cudaGetLastError();
}

// the GEMV route: 4 channels a warp, c_warps warps of channels, one warp
// per 512-wide slab of k (up to kMaxKWarps; k past that loops in panels)
// and one per group of 8 rows (up to kMaxRWarps and kGemvMaxWarps in all;
// more rows loop in stages)
cudaError_t launch_gemv(const float* x, const int8_t* w_q, const float* scale, float* y, int m,
                        int n, int k, int k_pad, int ldx, bool vec, int c_warps,
                        cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      w8a16_f32_gemv, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemvMaxSmem);
  if (attr != cudaSuccess) return attr;
  const int slabs = (k_pad + kSlab - 1) / kSlab;
  const int k_warps = slabs < kMaxKWarps ? slabs : kMaxKWarps;
  int r_warps = (m + kGemvRows - 1) / kGemvRows;
  if (r_warps > kMaxRWarps) r_warps = kMaxRWarps;
  while (r_warps > 1 && c_warps * k_warps * r_warps > kGemvMaxWarps) --r_warps;
  const int staged = m < kGemvRows * r_warps ? m : kGemvRows * r_warps;
  const size_t smem = sizeof(float) * staged * kSlab * k_warps;
  const int channels = kGemvCh * c_warps;
  w8a16_f32_gemv<<<(n + channels - 1) / channels, 32 * c_warps * k_warps * r_warps, smem,
                   stream>>>(x, w_q, scale, y, m, n, k, k_pad, ldx, vec, k_warps, c_warps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// x (m, k) with rows ldx >= k elements apart, w_q (n, k_pad) int8 with k_pad
// a multiple of 16 and k <= k_pad, scale (n,) fp32, y (m, n) contiguous in
// x's dtype; w_q 16-byte aligned. The tile of y a block computes is block_m
// rows x block_n columns: bfloat16 takes 64 x 64, 128 x 64 (one consumer
// warpgroup) or 256 x 128 (two), and x 16-byte aligned with ldx a multiple
// of 8 (TMA's 16-byte row stride). float32 takes 64 x 64 (the tiled route)
// or block_m = 8 with block_n = 4, 8 or 16 (the GEMV route: every row of
// x, 8 at a time, and block_n channels a block); its x may lie at any
// pitch and alignment (16-byte copies where ldx % 4 == 0 and x is 16-byte
// aligned, 4-byte ones otherwise).
// Returns 0 or the cudaError_t of the launch.
extern "C" int vb_w8a16_matmul(const void* x, const void* w_q, const void* scale, void* y,
                               int m, int n, int k, int k_pad, int ldx, int dtype, int block_m,
                               int block_n, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k > k_pad || k_pad % 16 != 0 || ldx < k ||
      reinterpret_cast<uintptr_t>(w_q) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1) {
    if (ldx % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (block_m == 64 && block_n == 64) {
      err = launch_bf16<1, 64>(x, w_q, scale, y, m, n, k, k_pad, ldx, s);
    } else if (block_m == 128 && block_n == 64) {
      err = launch_bf16<1, 128>(x, w_q, scale, y, m, n, k, k_pad, ldx, s);
    } else if (block_m == 256 && block_n == 128) {
      err = launch_bf16<2, 256>(x, w_q, scale, y, m, n, k, k_pad, ldx, s);
    }
  } else if (dtype == 0) {
    const bool vec = ldx % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const float* xf = static_cast<const float*>(x);
    const int8_t* wq = static_cast<const int8_t*>(w_q);
    const float* sc = static_cast<const float*>(scale);
    float* yf = static_cast<float*>(y);
    if (block_m == kF32BM && block_n == kF32BN) {
      const dim3 grid((m + kF32BM - 1) / kF32BM, (n + kF32BN - 1) / kF32BN);
      w8a16_f32<<<grid, kF32Threads, 0, s>>>(xf, wq, sc, yf, m, n, k, k_pad, ldx, vec);
      err = cudaGetLastError();
    } else if (block_m == kGemvRows && (block_n == 4 || block_n == 8 || block_n == 16)) {
      err = launch_gemv(xf, wq, sc, yf, m, n, k, k_pad, ldx, vec, block_n / kGemvCh, s);
    }
  }
  return static_cast<int>(err);
}
