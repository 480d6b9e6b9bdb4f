// K1: attention forward with an online softmax, for Hopper (sm_90a).
//
// Replaces voicebox_tpu/ops/flash_attention.py::_flash_kernel, the Pallas TPU
// kernel driven by _flash_forward. It computes the same function, not the
// same blocks: fp32 logits times `scale`, masked keys filled with
// -0.7 * FLT_MAX, a running max and sum per query row, out = acc / l in the
// input dtype, and lse = m + log(l) in fp32 per row.
//
// What bounds it on the H100, at the shapes the port runs:
//  * bf16, serving and training (b x 4 heads, 766-1040 rows, head dim 128):
//    ~380 operations per byte of q, k, v and out, above the card's bf16
//    ridge (~295), so the tensor cores bound it. The design feeds them:
//    one producer warp keeps TMA loads of 128-key K and V tiles in flight
//    through a 2-stage ring in shared memory (128-byte swizzle, "full" and
//    "empty" mbarriers), and gives its registers to the consumers
//    (setmaxnreg); each consumer warpgroup runs S = Q K^T and O += P V as
//    wgmma with fp32 accumulators in registers, and the online softmax on
//    the accumulator of S in registers (row max and sum across a quad by
//    shuffles, O rescaled in registers, P converted to bf16 in registers as
//    the A operand of the second product). No logit, probability or output
//    tile passes through shared memory.
//  * bf16, the quantized engine's batch-1 shape (2 x 4 heads, 272 rows):
//    latency, with 3 key tiles per block and a grid of a few dozen blocks.
//    The host picks 64 query rows per block (one consumer warpgroup) where
//    128-row blocks would not fill the card's SMs, 128 rows (two consumer
//    warpgroups sharing each K/V tile) where they would.
//  * bf16 at head dim 256 (2 x 256-wide heads): the same design with
//    64-key tiles, since two stages of 128-key K and V tiles (256 KB) pass
//    the 227 KB of shared memory a block can have. O is then 64 x 256 fp32,
//    128 registers a thread, beside S (32) and P (16): within the 240 that
//    setmaxnreg gives two consumer warpgroups, and the 255 of one.
//  * fp32, the duration predictor (1-4 x 8 heads, 32-128 rows, head dim
//    64): latency. wgmma has no fp32 mode and TF32 would break the fp32
//    contract, so both products stay on CUDA-core FMAs, register-tiled: each
//    of 128 threads owns a micro-tile of 2 rows x 2 keys of S and 2 rows x
//    D/16 columns of O and reads 16-byte vectors from shared memory; 16-row
//    query tiles, so that the predictor's batch 1 still runs 16 blocks;
//    32-key tiles, double-buffered with cp.async, and a key loop bounded by
//    the real kv, so kv = 32 computes 32 keys. The same code runs the narrow
//    heads of small models (head dim 16 and 32, fp32 only): a thread's D/16
//    columns of O are then 2 or 1 neighbouring floats (F32Cols), read and
//    written as 8- or 4-byte vectors, so nothing is padded to 64 columns.
//    At head dim 256 the tiles take 152 KB of shared memory and O 32
//    registers a thread.
//  * past head dim 256, either dtype (2 x 512-wide heads): neither Q nor O
//    fits whole (O at 64 x 512 fp32 is 256 registers a thread), so a block
//    owns a 256-column chunk of O, the chunk a grid index, and the logits
//    stream Q and K in 64-column slices: shared memory does not grow with d
//    (flash_fwd_bf16_wide, flash_fwd_f32_wide). Each chunk's block
//    recomputes the logits, so at c chunks the work is (c + 1) / 2 times
//    the minimum; the tensor cores (bf16) or FMAs (fp32) bound it as at 256.
//
// Both paths mask ragged n and kv here, with no padding copies: TMA (bf16)
// and cp.async (fp32) fill rows past n or kv with zeros, keys past kv get
// p = 0 by a select, rows past n are not stored. The mask fill stays fp32:
// a row whose keys are all masked gets the same logit on every real key, so
// it comes out as mean(V) over the real keys and its lse as fill + log(kv),
// as the plain softmax gives. The kernel launches on the caller's stream and
// allocates nothing; the host encodes the three tensor maps on each call.

#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kMaskFill = -0.7f * 3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;

// ----------------------------------------------------------- bf16: layout

constexpr int kStages = 2;    // K/V ring depth

// Shared memory in bytes. Each operand tile is stored as D / 64 column
// chunks of (rows x 64) bf16, 128 bytes a row, as TMA's 128-byte swizzle
// lays them out; every chunk starts on a 1024-byte boundary.
// Keys per K/V tile (kBlockN): 128 up to head dim 128; 64 at 256, where a
// 128-key ring (2 stages x K and V x 64 KB = 256 KB) would not fit the
// 227 KB a block can have, and the 64-key ring takes 128 KB beside the
// 32 KB of Q a warpgroup.
template <int D, int NWG>
struct Bf16Smem {
  static constexpr int kBlockN = D == 256 ? 64 : 128;
  static constexpr int kChunks = D / kSwizzleCols;
  static constexpr int kRowsQ = NWG * 64;
  static constexpr int kQChunk = kRowsQ * 128;
  static constexpr int kKVChunk = kBlockN * 128;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kTile = kChunks * kKVChunk;  // one K or one V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;               // kStages K tiles
  static constexpr int kV = kK + kStages * kTile;  // kStages V tiles
  static constexpr int kBytes = kV + kStages * kTile;
  static constexpr int kAlloc = kBytes + 1024;     // room to align the base
  // consumer warpgroups, then the producer: with two consumers a whole
  // warpgroup, whose registers (setmaxnreg) pay for the consumers' 240;
  // with one, registers are not scarce and a single warp will do
  static constexpr int kProducerThreads = NWG == 2 ? 128 : 32;
  static constexpr int kThreads = NWG * 128 + kProducerThreads;
};

// ----------------------------------------------------- bf16: softmax, epilogue

// One tile's logits in sc (wgmma's accumulator layout: this thread's rows r
// (j = 0) and r + 8 (j = 1) and, in each 8-key block i, keys 8 i + 2 quad +
// {0, 1}: element [4 i + 2 j + c]) of keys k0 ...: scaled, masked keys
// filled, keys past kv -inf (p = 0); the online softmax's running max and
// this thread's part of the row sums; O (D / 2 accumulators) rescaled; P in
// bf16 as the A operand of P V (the accumulator layout of S is the
// A-register layout)
template <int kBlockN, int D>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBlockN / 2], float (&o)[D / 2],
                                             float (&m_run)[2], float (&l_run)[2],
                                             uint32_t (&pa)[kBlockN / 16][4], int k0, int n_kv,
                                             const uint8_t* mask_b, int quad, float scale) {
  // logits: scale; masked keys get the fill, keys past kv -inf (p = 0)
  if (mask_b != nullptr || k0 + kBlockN > n_kv) {
#pragma unroll
    for (int i = 0; i < kBlockN / 8; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * i + 2 * quad + c;
        const bool past = key >= n_kv;
        const bool masked = !past && mask_b != nullptr && !mask_b[key];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = sc[4 * i + 2 * j + c];
          x = past ? -INFINITY : masked ? kMaskFill : x * scale;
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) sc[i] *= scale;
  }

  // online softmax, rows r (j = 0) and r + 8 (j = 1)
  float alpha[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float mx = m_run[j];
#pragma unroll
    for (int i = 0; i < kBlockN / 8; ++i) {
      mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * j], sc[4 * i + 2 * j + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // every tile holds a key before kv, so mx is finite; the first
    // tile's alpha is exp(-inf) = 0
    alpha[j] = exp2f((m_run[j] - mx) * kLog2e);
    m_run[j] = mx;
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kBlockN / 8; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = sc[4 * i + 2 * j + c];
        x = exp2f((x - mx) * kLog2e);  // the fill against a real max: 0
        sum += x;
      }
    }
    l_run[j] = l_run[j] * alpha[j] + sum;
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      o[4 * i + 2 * j] *= alpha[j];
      o[4 * i + 2 * j + 1] *= alpha[j];
    }
  }

  // P in bf16
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// rows r (j = 0) and r + 8 (j = 1) of a warpgroup's 64 x COLS accumulator
// of O, over the row sums, into out_bh (rows of ld elements) at columns
// col0 + 8 i + 2 quad + {0, 1}; columns past n_cols and rows past n_q are
// not stored; lse per row where write_lse
template <int COLS>
__device__ __forceinline__ void store_out(const float (&o)[COLS / 2], const float (&m_run)[2],
                                          const float (&l_run)[2], bf16* __restrict__ out_bh,
                                          float* __restrict__ lse_bh, int row, int n_q, int ld,
                                          int col0, int n_cols, int quad, bool write_lse) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float l = l_run[j];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = row + 8 * j;
    if (r < n_q) {
      const float inv = 1.0f / l;
      bf16* dst = out_bh + (size_t)r * ld + col0 + 2 * quad;
#pragma unroll
      for (int i = 0; i < COLS / 8; ++i) {
        if (col0 + 8 * i >= n_cols) break;
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
            __floats2bfloat162_rn(o[4 * i + 2 * j] * inv, o[4 * i + 2 * j + 1] * inv);
      }
      if (write_lse && quad == 0) lse_bh[r] = m_run[j] + logf(l);
    }
  }
}

// ----------------------------------------------------------- bf16: kernel

// grid: (query tiles of NWG x 64 rows, heads, batch). Warpgroups 0..NWG-1
// consume; warp 4 NWG issues the loads. q/out (b, h, n_q, D), k/v (b, h, n_kv, D)
// through 3-D tensor maps (D, rows, b h); mask (b, n_kv) bytes or null;
// lse (b, h, n_q) fp32.
template <int D, int NWG>
__global__ void __launch_bounds__(Bf16Smem<D, NWG>::kThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const uint8_t* __restrict__ mask,
                   bf16* __restrict__ out, float* __restrict__ lse, int heads, int n_q,
                   int n_kv, float scale) {
  using L = Bf16Smem<D, NWG>;
  constexpr int kBlockN = L::kBlockN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ __align__(8) uint64_t q_bar;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int wg = threadIdx.x / 128;
  const int batch = blockIdx.z;
  const int bh = batch * heads + blockIdx.y;
  const int n_tiles = (n_kv + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], NWG * 128);
    }
    mbar_init(&q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // producer warp: Q once, then K and V tiles through the ring
    if constexpr (NWG == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(&q_bar, L::kQBytes);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c) {
        tma_load_3d(smem + L::kQ + c * L::kQChunk, &tm_q, &q_bar, c * kSwizzleCols,
                    blockIdx.x * L::kRowsQ, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty_bar[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full_bar[s], 2 * L::kTile);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_3d(smem + L::kK + s * L::kTile + c * L::kKVChunk, &tm_k, &full_bar[s],
                      c * kSwizzleCols, t * kBlockN, bh);
          tma_load_3d(smem + L::kV + s * L::kTile + c * L::kKVChunk, &tm_v, &full_bar[s],
                      c * kSwizzleCols, t * kBlockN, bh);
        }
      }
    }
  } else {
    // consumer warpgroup wg: 64 query rows. In wgmma's accumulator layout
    // this thread owns rows r and r + 8 and, in each 8-column block i,
    // columns 8 i + 2 (lane % 4) + {0, 1}: element [4 i + 2 j + c].
    if constexpr (NWG == 2) setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int quad = lane % 4;
    const int row = blockIdx.x * L::kRowsQ + wg * 64 + (tid / 32) * 16 + lane / 4;
    const uint32_t q_base = smem_u32(smem + L::kQ) + wg * 64 * 128;
    const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)batch * n_kv;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.0f, 0.0f};  // this thread's part of the row sums

    mbar_wait(&q_bar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(&full_bar[s], (t / kStages) & 1);
      const uint32_t k_base = smem_u32(smem + L::kK + s * L::kTile);
      const uint32_t v_base = smem_u32(smem + L::kV + s * L::kTile);

      // S = Q K^T over D in steps of 16: 32 bytes along a 128-byte row
      float sc[kBlockN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da = sw128_desc(q_base + (kk / 4) * L::kQChunk + off, 16, 1024);
        const uint64_t db = sw128_desc(k_base + (kk / 4) * L::kKVChunk + off, 16, 1024);
        if constexpr (kBlockN == 128) {
          wgmma_ss_n128(sc, da, db, kk > 0);
        } else {
          wgmma_ss_n64(sc, da, db, kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      uint32_t pa[kBlockN / 16][4];
      softmax_tile<kBlockN, D>(sc, o, m_run, l_run, pa, t * kBlockN, n_kv, mask_b, quad, scale);

      // O += P V over the tile's keys in steps of 16 rows of V
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const uint64_t db = sw128_desc(v_base + kk * 16 * 128, L::kKVChunk, 1024);
        wgmma_rs<D>(o, pa[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(&empty_bar[s]);  // this thread's reads of the stage are done
    }

    store_out<D>(o, m_run, l_run, out + (size_t)bh * n_q * D, lse + (size_t)bh * n_q, row, n_q, D,
                 0, D, quad, true);
  }
}

// --------------------------------------------- bf16: head dims past 256

// Past 256 columns neither budget holds a head whole: O at 64 x 512 fp32
// would take 256 registers a thread, and Q at 64 x 512 bf16 with one
// 64-key K tile of that width already 128 KB of shared memory. So a block
// owns a 256-column chunk of O for its 64 query rows (the chunk index in
// the grid: 128 registers a thread, as at d = 256), and the logits, a sum
// over the whole d, come from Q and K streamed in 64-column slices (one
// swizzled column chunk each) through a ring of 4 stages: shared memory does
// not grow with d. P V then takes the chunk's columns of V only, one 64-key
// x 256-column tile through 2 stages of their own. Every chunk's block
// computes the same logits (the forward's work is (c + 1) / 2 times the
// minimum at c chunks) and the same lse; chunk 0 stores it. d is a multiple
// of 64 (the wrapper pads); the last chunk may be narrower than 256: its
// missing columns are not loaded and not stored, and feed only
// accumulator columns that are never stored.
constexpr int kWideCols = 256;   // output columns a block owns
constexpr int kWideKeys = 64;    // keys per tile
constexpr int kWideRing = 4;     // stages of (Q, K) slices

struct WideSmem {
  static constexpr int kSlice = 64 * 128;                // 64 rows x 64 bf16, swizzled
  static constexpr int kStage = 2 * kSlice;              // a Q slice and a K slice
  static constexpr int kV = kWideRing * kStage;          // after the ring: 2 V tiles
  static constexpr int kVTile = kWideCols / kSwizzleCols * kWideKeys * 128;
  static constexpr int kBytes = kV + 2 * kVTile;         // 128 KB
  static constexpr int kAlloc = kBytes + 1024;           // room to align the base
  static constexpr int kThreads = 128 + 32;              // a consumer warpgroup, a producer warp
};

// grid: (query tiles of 64 rows x chunks of 256 columns, heads, batch).
// Warpgroup 0 consumes; warp 4 loads. q/out (b, h, n_q, d), k/v
// (b, h, n_kv, d) through 3-D tensor maps (d, rows, b h) with boxes of 64
// columns x 64 rows; mask (b, n_kv) bytes or null; lse (b, h, n_q) fp32.
__global__ void __launch_bounds__(WideSmem::kThreads, 1)
    flash_fwd_bf16_wide(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                        float* __restrict__ lse, int heads, int n_q, int n_kv, int d,
                        float scale) {
  using L = WideSmem;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kWideRing];
  __shared__ __align__(8) uint64_t empty_bar[kWideRing];
  __shared__ __align__(8) uint64_t v_full[2];
  __shared__ __align__(8) uint64_t v_empty[2];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int n_chunks = (d + kWideCols - 1) / kWideCols;
  const int chunk = blockIdx.x % n_chunks;
  const int q_tile = blockIdx.x / n_chunks;
  const int col0 = chunk * kWideCols;
  const int slices = d / kSwizzleCols;
  const int chunk_slices = min(kWideCols / kSwizzleCols, slices - col0 / kSwizzleCols);
  const int batch = blockIdx.z;
  const int bh = batch * heads + blockIdx.y;
  const int n_tiles = (n_kv + kWideKeys - 1) / kWideKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideRing; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 128);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warp: per key tile, the chunk's V tile, then the tile's
    // (Q, K) slices in order through the ring
    if (threadIdx.x == 128) {
      int it = 0;  // slices requested
      for (int t = 0; t < n_tiles; ++t) {
        const int vb = t & 1;
        mbar_wait(&v_empty[vb], ((t >> 1) & 1) ^ 1);
        mbar_expect_tx(&v_full[vb], chunk_slices * kWideKeys * 128);
        for (int c = 0; c < chunk_slices; ++c) {
          tma_load_3d(smem + L::kV + vb * L::kVTile + c * kWideKeys * 128, &tm_v, &v_full[vb],
                      col0 + c * kSwizzleCols, t * kWideKeys, bh);
        }
        for (int s = 0; s < slices; ++s, ++it) {
          const int st = it % kWideRing;
          mbar_wait(&empty_bar[st], ((it / kWideRing) & 1) ^ 1);
          mbar_expect_tx(&full_bar[st], L::kStage);
          tma_load_3d(smem + st * L::kStage, &tm_q, &full_bar[st], s * kSwizzleCols,
                      q_tile * 64, bh);
          tma_load_3d(smem + st * L::kStage + L::kSlice, &tm_k, &full_bar[st],
                      s * kSwizzleCols, t * kWideKeys, bh);
        }
      }
    }
  } else {
    // consumer warpgroup: 64 query rows, accumulator layout as above
    const int lane = threadIdx.x % 32;
    const int quad = lane % 4;
    const int row = q_tile * 64 + (threadIdx.x / 32) * 16 + lane / 4;
    const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)batch * n_kv;

    float o[kWideCols / 2];
#pragma unroll
    for (int i = 0; i < kWideCols / 2; ++i) o[i] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.0f, 0.0f};

    int it = 0;  // slices consumed
    for (int t = 0; t < n_tiles; ++t) {
      // S = Q K^T over d, slice after slice; a slice's stage is released
      // once the products that read it have retired, one slice behind
      float sc[kWideKeys / 2];
      int prev = 0;
      for (int s = 0; s < slices; ++s, ++it) {
        const int st = it % kWideRing;
        mbar_wait(&full_bar[st], (it / kWideRing) & 1);
        const uint32_t q_base = smem_u32(smem + st * L::kStage);
        const uint32_t k_base = q_base + L::kSlice;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss_n64(sc, sw128_desc(q_base + kk * 32, 16, 1024),
                       sw128_desc(k_base + kk * 32, 16, 1024), s > 0 || kk > 0);
        }
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

      uint32_t pa[kWideKeys / 16][4];
      softmax_tile<kWideKeys, kWideCols>(sc, o, m_run, l_run, pa, t * kWideKeys, n_kv, mask_b,
                                         quad, scale);

      // O += P V over the chunk's columns
      const int vb = t & 1;
      mbar_wait(&v_full[vb], (t >> 1) & 1);
      const uint32_t v_base = smem_u32(smem + L::kV + vb * L::kVTile);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWideKeys / 16; ++kk) {
        wgmma_rs<kWideCols>(o, pa[kk], sw128_desc(v_base + kk * 16 * 128, kWideKeys * 128, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(&v_empty[vb]);
    }

    store_out<kWideCols>(o, m_run, l_run, out + (size_t)bh * n_q * d, lse + (size_t)bh * n_q,
                         row, n_q, d, col0, d, quad, chunk == 0);
  }
}

// ------------------------------------------------------------ fp32: kernel

constexpr int kF32Threads = 128;  // 8 row groups x 16 column groups
constexpr int kF32BlockQ = 16;    // query rows per block
constexpr int kF32BlockK = 32;    // keys per K/V tile

// Shared memory in floats: rows padded by 4 floats (`cp_async_rows`).
template <int D>
struct F32Smem {
  static constexpr int kLd = D + 4;
  static constexpr int kLdP = kF32BlockK + 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kF32BlockQ * kLd;         // 2 stages
  static constexpr int kV = kK + 2 * kF32BlockK * kLd;     // 2 stages
  static constexpr int kP = kV + 2 * kF32BlockK * kLd;
  static constexpr int kBytes = (kP + kF32BlockQ * kLdP) * 4;
};

// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty RM .. ty RM + RM - 1
// of a 16-row query tile; of S, keys tx and tx + 16 of each 32-key tile; of
// O, the D / 16 columns F32Cols<D> gives it (4 at 64 g + 4 tx at D = 64 and
// above, 2 at 2 tx at D = 32, tx at D = 16).

// s[i][c] += query row ty RM + i of q_s . key row tx + 16 c of k_s over
// `cols` columns (rows ld floats apart), one FMA after another along d, the
// order of the plain version's fp32 product: at logits of ~1e3 another
// order moves them by ulps
template <int RM, int COLS>
__device__ __forceinline__ void f32_logits(float (&s)[RM][2], const float* q_s, const float* k_s,
                                           int ld, int tx, int ty) {
#pragma unroll 4
  for (int d = 0; d < COLS; d += 4) {
    const float4 ka = *reinterpret_cast<const float4*>(k_s + tx * ld + d);
    const float4 kb = *reinterpret_cast<const float4*>(k_s + (tx + 16) * ld + d);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float4 qv = *reinterpret_cast<const float4*>(q_s + (ty * RM + i) * ld + d);
      s[i][0] = fmaf(qv.w, ka.w, fmaf(qv.z, ka.z, fmaf(qv.y, ka.y, fmaf(qv.x, ka.x, s[i][0]))));
      s[i][1] = fmaf(qv.w, kb.w, fmaf(qv.z, kb.z, fmaf(qv.y, kb.y, fmaf(qv.x, kb.x, s[i][1]))));
    }
  }
}

// one tile's logits (keys k0 ...): scaled, masked keys filled, keys past kv
// -inf; the online softmax's running max and sum; O rescaled; the tile's P
// into p_s (kLdP floats a row)
template <int RM, int G, int W>
__device__ __forceinline__ void f32_softmax_tile(float (&s)[RM][2], float (&o)[RM][G][W],
                                                 float (&m_run)[RM], float (&l_run)[RM],
                                                 float* p_s, int k0, int n_kv,
                                                 const uint8_t* mask_b, int tx, int ty,
                                                 float scale) {
  constexpr int kLdP = kF32BlockK + 4;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int key = k0 + tx + 16 * c;
    const bool past = key >= n_kv;
    const bool masked = !past && mask_b != nullptr && !mask_b[key];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      s[i][c] = past ? -INFINITY : masked ? kMaskFill : s[i][c] * scale;
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float mx = fmaxf(s[i][0], s[i][1]);
#pragma unroll
    for (int w = 8; w > 0; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float m_new = fmaxf(m_run[i], mx);
    const float alpha = expf(m_run[i] - m_new);
    const float p0 = expf(s[i][0] - m_new);
    const float p1 = expf(s[i][1] - m_new);
    l_run[i] = l_run[i] * alpha + p0 + p1;
    m_run[i] = m_new;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < W; ++e) o[i][g][e] *= alpha;
    }
    p_s[(ty * RM + i) * kLdP + tx] = p0;
    p_s[(ty * RM + i) * kLdP + tx + 16] = p1;
  }
}

// O += P V over the tile's `keys` real keys, rounded up to 4 (rows of v_s ld
// floats apart; P's rows past them are 0)
template <int RM, int D, int G, int W>
__device__ __forceinline__ void f32_pv(float (&o)[RM][G][W], const float* p_s, const float* v_s,
                                       int ld, int keys, int tx, int ty) {
  using C = F32Cols<D>;
  constexpr int kLdP = kF32BlockK + 4;
  for (int kk = 0; kk < keys; kk += 4) {
    float4 pv[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      pv[i] = *reinterpret_cast<const float4*>(p_s + (ty * RM + i) * kLdP + kk);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float vv[W];
        ld_f32<W>(vv, v_s + (kk + u) * ld + C::col(g, tx));
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int e = 0; e < W; ++e) o[i][g][e] = fmaf(p, vv[e], o[i][g][e]);
        }
      }
    }
  }
}

// the thread's rows of O over the row sums into out_bh (rows of ld floats)
// at columns col0 + F32Cols<D>::col(g, tx); columns past n_cols and rows
// past n_q not stored; lse per row where write_lse
template <int RM, int D, int G, int W>
__device__ __forceinline__ void f32_store_out(const float (&o)[RM][G][W], const float (&m_run)[RM],
                                              const float (&l_run)[RM], float* __restrict__ out_bh,
                                              float* __restrict__ lse_bh, int q0, int n_q, int ld,
                                              int col0, int n_cols, int tx, int ty,
                                              bool write_lse) {
  using C = F32Cols<D>;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int w = 8; w > 0; w /= 2) l += __shfl_xor_sync(0xffffffffu, l, w);
    const int r = q0 + ty * RM + i;
    if (r < n_q) {
      const float inv = 1.0f / l;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (col0 + C::col(g, 0) >= n_cols) break;
        float res[W];
#pragma unroll
        for (int e = 0; e < W; ++e) res[e] = o[i][g][e] * inv;
        st_f32<W>(out_bh + (size_t)r * ld + col0 + C::col(g, tx), res);
      }
      if (write_lse && tx == 0) lse_bh[r] = m_run[i] + logf(l);
    }
  }
}

// grid: (query tiles of 16 rows, heads, batch).
template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const uint8_t* __restrict__ mask,
                  float* __restrict__ out, float* __restrict__ lse, int heads, int n_q, int n_kv,
                  float scale) {
  using L = F32Smem<D>;
  constexpr int BQ = kF32BlockQ;
  constexpr int RM = BQ / 8;
  using C = F32Cols<D>;
  constexpr int G = C::G, W = C::W;
  constexpr int kLd = L::kLd;
  extern __shared__ float4 smem_f32[];
  float* sm = reinterpret_cast<float*>(smem_f32);
  float* q_s = sm + L::kQ;
  float* p_s = sm + L::kP;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ;
  const int batch = blockIdx.z;
  const size_t bh = (size_t)batch * heads + blockIdx.y;
  const float* k_bh = k + bh * n_kv * D;
  const float* v_bh = v + bh * n_kv * D;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)batch * n_kv;
  const int n_tiles = (n_kv + kF32BlockK - 1) / kF32BlockK;

  cp_async_rows<D, BQ, kF32Threads>(q_s, q + bh * n_q * D, q0, n_q);
  cp_async_rows<D, kF32BlockK, kF32Threads>(sm + L::kK, k_bh, 0, n_kv);
  cp_async_rows<D, kF32BlockK, kF32Threads>(sm + L::kV, v_bh, 0, n_kv);
  cp_async_commit();

  float o[RM][G][W];
  float m_run[RM], l_run[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < W; ++e) o[i][g][e] = 0.0f;
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {  // the next tile streams in while this one computes
      cp_async_rows<D, kF32BlockK, kF32Threads>(sm + L::kK + (st ^ 1) * kF32BlockK * kLd,
                                                k_bh, (t + 1) * kF32BlockK, n_kv);
      cp_async_rows<D, kF32BlockK, kF32Threads>(sm + L::kV + (st ^ 1) * kF32BlockK * kLd,
                                                v_bh, (t + 1) * kF32BlockK, n_kv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* k_s = sm + L::kK + st * kF32BlockK * kLd;
    const float* v_s = sm + L::kV + st * kF32BlockK * kLd;
    const int k0 = t * kF32BlockK;

    float s[RM][2];
#pragma unroll
    for (int i = 0; i < RM; ++i) s[i][0] = s[i][1] = 0.0f;
    f32_logits<RM, D>(s, q_s, k_s, kLd, tx, ty);

    f32_softmax_tile<RM>(s, o, m_run, l_run, p_s, k0, n_kv, mask_b, tx, ty, scale);
    __syncwarp();  // a row's probabilities come from the 16 lanes of one half-warp

    f32_pv<RM, D>(o, p_s, v_s, kLd, min(kF32BlockK, n_kv - k0), tx, ty);
    __syncthreads();  // this stage and p_s are consumed before they are refilled
  }

  f32_store_out<RM, D>(o, m_run, l_run, out + bh * n_q * D, lse + bh * n_q, q0, n_q, D, 0, D,
                       tx, ty, true);
}

// ------------------------------------------------ fp32: head dims past 256

// As bf16's chunked kernel: a block owns a 256-column chunk of O (32
// registers a thread, as at d = 256) for its 16 query rows, and the logits
// come from Q and K streamed in 64-column slices. The block's loads are one
// stream of items, for each 32-key tile its d / 64 (Q, K) slices and then
// its V chunk (32 keys x 256 columns), two items in flight by cp.async while
// one computes (three slice buffers, one V buffer): 75 KB of shared memory
// at every d. The logits still sum along d one FMA after another.
constexpr int kF32Slice = 64;  // columns of a (Q, K) slice

struct F32WideSmem {
  static constexpr int kLdS = kF32Slice + 4;
  static constexpr int kLdV = kWideCols + 4;
  static constexpr int kLdP = kF32BlockK + 4;
  static constexpr int kStage = (kF32BlockQ + kF32BlockK) * kLdS;  // a Q slice, a K slice
  static constexpr int kStages = 3;
  static constexpr int kV = kStages * kStage;
  static constexpr int kP = kV + kF32BlockK * kLdV;
  static constexpr int kBytes = (kP + kF32BlockQ * kLdP) * 4;
};

// grid: (query tiles of 16 rows x chunks of 256 columns, heads, batch);
// threads as flash_fwd_f32's; q/out (b, h, n_q, d), k/v (b, h, n_kv, d).
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const uint8_t* __restrict__ mask,
                       float* __restrict__ out, float* __restrict__ lse, int heads, int n_q,
                       int n_kv, int d, float scale) {
  using L = F32WideSmem;
  constexpr int RM = kF32BlockQ / 8;
  using C = F32Cols<kWideCols>;
  constexpr int G = C::G, W = C::W;
  extern __shared__ float4 smem_f32[];
  float* sm = reinterpret_cast<float*>(smem_f32);
  float* p_s = sm + L::kP;
  const float* v_s = sm + L::kV;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n_chunks = (d + kWideCols - 1) / kWideCols;
  const int chunk = blockIdx.x % n_chunks;
  const int q0 = blockIdx.x / n_chunks * kF32BlockQ;
  const int col0 = chunk * kWideCols;
  const int batch = blockIdx.z;
  const size_t bh = (size_t)batch * heads + blockIdx.y;
  const float* q_bh = q + bh * n_q * d;
  const float* k_bh = k + bh * n_kv * d;
  const float* v_bh = v + bh * n_kv * d;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)batch * n_kv;
  const int slices = d / kF32Slice;
  const int per_tile = slices + 1;
  const int items = (n_kv + kF32BlockK - 1) / kF32BlockK * per_tile;

  // item i: of key tile i / per_tile, (Q, K) slice i % per_tile or, last,
  // the V chunk; past the last item an empty group, so that every
  // iteration waits alike
  auto fetch = [&](int i) {
    if (i < items) {
      const int t = i / per_tile, r = i % per_tile;
      if (r < slices) {
        float* st = sm + (t * slices + r) % L::kStages * L::kStage;
        cp_async_window<kF32BlockQ, kF32Slice, kF32Threads>(st, q_bh, n_q, d, q0,
                                                             r * kF32Slice);
        cp_async_window<kF32BlockK, kF32Slice, kF32Threads>(st + kF32BlockQ * L::kLdS, k_bh,
                                                             n_kv, d, t * kF32BlockK,
                                                             r * kF32Slice);
      } else {
        cp_async_window<kF32BlockK, kWideCols, kF32Threads>(sm + L::kV, v_bh, n_kv, d,
                                                             t * kF32BlockK, col0);
      }
    }
    cp_async_commit();
  };

  float o[RM][G][W];
  float m_run[RM], l_run[RM], s[RM][2];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < W; ++e) o[i][g][e] = 0.0f;
    }
  }

  fetch(0);
  fetch(1);
  for (int i = 0; i < items; ++i) {
    cp_async_wait<1>();  // item i has landed
    __syncthreads();     // for every thread, and every thread is done with item i - 1
    fetch(i + 2);        // into buffers no thread reads any more
    const int t = i / per_tile, r = i % per_tile;
    const int k0 = t * kF32BlockK;
    if (r < slices) {
      if (r == 0) {
#pragma unroll
        for (int j = 0; j < RM; ++j) s[j][0] = s[j][1] = 0.0f;
      }
      const float* st = sm + (t * slices + r) % L::kStages * L::kStage;
      f32_logits<RM, kF32Slice>(s, st, st + kF32BlockQ * L::kLdS, L::kLdS, tx, ty);
      if (r == slices - 1) {
        f32_softmax_tile<RM>(s, o, m_run, l_run, p_s, k0, n_kv, mask_b, tx, ty, scale);
      }
    } else {
      f32_pv<RM, kWideCols>(o, p_s, v_s, L::kLdV, min(kF32BlockK, n_kv - k0), tx, ty);
    }
  }

  f32_store_out<RM, kWideCols>(o, m_run, l_run, out + bh * n_q * d, lse + bh * n_q, q0, n_q, d,
                               col0, d, tx, ty, chunk == 0);
}

// ------------------------------------------------------------------- host

template <int D, int NWG>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* mask, void* out,
                        void* lse, int batch, int heads, int n_q, int n_kv, float scale,
                        cudaStream_t stream) {
  using L = Bf16Smem<D, NWG>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v;
  const int bh = batch * heads;
  if (!encode_bf16_3d(fn, &tm_q, q, D, n_q, bh, L::kRowsQ) ||
      !encode_bf16_3d(fn, &tm_k, k, D, n_kv, bh, L::kBlockN) ||
      !encode_bf16_3d(fn, &tm_v, v, D, n_kv, bh, L::kBlockN)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_fwd_bf16<D, NWG>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + L::kRowsQ - 1) / L::kRowsQ, heads, batch);
  kernel<<<grid, L::kThreads, L::kAlloc, stream>>>(
      tm_q, tm_k, tm_v, static_cast<const uint8_t*>(mask), static_cast<bf16*>(out),
      static_cast<float*>(lse), heads, n_q, n_kv, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* mask, void* out,
                       void* lse, int batch, int heads, int n_q, int n_kv, float scale,
                       cudaStream_t stream) {
  using L = F32Smem<D>;
  auto kernel = flash_fwd_f32<D>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + kF32BlockQ - 1) / kF32BlockQ, heads, batch);
  kernel<<<grid, kF32Threads, L::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), static_cast<float*>(lse),
      heads, n_q, n_kv, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   void* lse, int batch, int heads, int n_q, int n_kv, int dtype, int block_q,
                   float scale, cudaStream_t s) {
  if (dtype == 1 && block_q == 64) {
    return launch_bf16<D, 1>(q, k, v, mask, out, lse, batch, heads, n_q, n_kv, scale, s);
  }
  if (dtype == 1 && block_q == 128) {
    return launch_bf16<D, 2>(q, k, v, mask, out, lse, batch, heads, n_q, n_kv, scale, s);
  }
  if (dtype == 0 && block_q == kF32BlockQ) {
    return launch_f32<D>(q, k, v, mask, out, lse, batch, heads, n_q, n_kv, scale, s);
  }
  return cudaErrorInvalidValue;
}

// head dims past 256 (a multiple of 64): the chunked kernels
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* mask, void* out,
                        void* lse, int batch, int heads, int n_q, int n_kv, int d, int dtype,
                        int block_q, float scale, cudaStream_t stream) {
  const int n_chunks = (d + kWideCols - 1) / kWideCols;
  if (dtype == 1 && block_q == 64) {
    using L = WideSmem;
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return cudaErrorSymbolNotFound;
    CUtensorMap tm_q, tm_k, tm_v;
    const int bh = batch * heads;
    if (!encode_bf16_3d(fn, &tm_q, q, d, n_q, bh, 64) ||
        !encode_bf16_3d(fn, &tm_k, k, d, n_kv, bh, kWideKeys) ||
        !encode_bf16_3d(fn, &tm_v, v, d, n_kv, bh, kWideKeys)) {
      return cudaErrorInvalidValue;
    }
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
    if (err != cudaSuccess) return err;
    const dim3 grid((n_q + 63) / 64 * n_chunks, heads, batch);
    flash_fwd_bf16_wide<<<grid, L::kThreads, L::kAlloc, stream>>>(
        tm_q, tm_k, tm_v, static_cast<const uint8_t*>(mask), static_cast<bf16*>(out),
        static_cast<float*>(lse), heads, n_q, n_kv, d, scale);
    return cudaGetLastError();
  }
  if (dtype == 0 && block_q == kF32BlockQ) {
    using L = F32WideSmem;
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((n_q + kF32BlockQ - 1) / kF32BlockQ * n_chunks, heads, batch);
    flash_fwd_f32_wide<<<grid, kF32Threads, L::kBytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const uint8_t*>(mask), static_cast<float*>(out), static_cast<float*>(lse),
        heads, n_q, n_kv, d, scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// head_dim: 64, 128 or 256 in either dtype, 16 or 32 in float32, or any
// multiple of 64 past 256 in either (the chunked kernels). block_q: query
// rows per block, 64 or 128 for bfloat16 (one or two consumer warpgroups;
// 64 past 256), 16 for float32. Returns 0 or the cudaError_t of the launch.
extern "C" int vb_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* mask, void* out, void* lse, int batch,
                                      int heads, int n_q, int n_kv, int head_dim, int dtype,
                                      int block_q, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (head_dim == 64) {
    err = launch<64>(q, k, v, mask, out, lse, batch, heads, n_q, n_kv, dtype, block_q, scale, s);
  } else if (head_dim == 256) {
    err = launch<256>(q, k, v, mask, out, lse, batch, heads, n_q, n_kv, dtype, block_q, scale, s);
  } else if (head_dim == 128) {
    err = launch<128>(q, k, v, mask, out, lse, batch, heads, n_q, n_kv, dtype, block_q, scale, s);
  } else if (head_dim == 32 && dtype == 0 && block_q == kF32BlockQ) {  // fp32 only
    err = launch_f32<32>(q, k, v, mask, out, lse, batch, heads, n_q, n_kv, scale, s);
  } else if (head_dim == 16 && dtype == 0 && block_q == kF32BlockQ) {
    err = launch_f32<16>(q, k, v, mask, out, lse, batch, heads, n_q, n_kv, scale, s);
  } else if (head_dim > 256 && head_dim % kSwizzleCols == 0) {
    err = launch_wide(q, k, v, mask, out, lse, batch, heads, n_q, n_kv, head_dim, dtype, block_q,
                      scale, s);
  }
  return static_cast<int>(err);
}
