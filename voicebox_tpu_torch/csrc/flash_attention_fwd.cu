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
//  * fp32, the duration predictor (1-4 x 8 heads, 32-128 rows, head dim
//    64): latency. wgmma has no fp32 mode and TF32 would break the fp32
//    contract, so both products stay on CUDA-core FMAs, register-tiled: each
//    of 128 threads owns a micro-tile of 2 rows x 2 keys of S and 2 rows x
//    D/16 columns of O and reads 16-byte vectors from shared memory; 16-row
//    query tiles, so that the predictor's batch 1 still runs 16 blocks;
//    32-key tiles, double-buffered with cp.async, and a key loop bounded by
//    the real kv, so kv = 32 computes 32 keys.
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

constexpr int kBlockN = 128;  // keys per K/V tile
constexpr int kStages = 2;    // K/V ring depth

// Shared memory in bytes. Each operand tile is stored as D / 64 column
// chunks of (rows x 64) bf16, 128 bytes a row, as TMA's 128-byte swizzle
// lays them out; every chunk starts on a 1024-byte boundary.
template <int D, int NWG>
struct Bf16Smem {
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
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // logits: scale; masked keys get the fill, keys past kv -inf (p = 0)
      const int k0 = t * kBlockN;
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

      // P in bf16: the accumulator layout of S is the A-register layout
      uint32_t pa[kBlockN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

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

    bf16* out_bh = out + (size_t)bh * n_q * D;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float l = l_run[j];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int r = row + 8 * j;
      if (r < n_q) {
        const float inv = 1.0f / l;
        bf16* dst = out_bh + (size_t)r * D + 2 * quad;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
              __floats2bfloat162_rn(o[4 * i + 2 * j] * inv, o[4 * i + 2 * j + 1] * inv);
        }
        if (quad == 0) lse[(size_t)bh * n_q + r] = m_run[j] + logf(l);
      }
    }
  }
}

// ------------------------------------------------------------ fp32: kernel

constexpr int kF32Threads = 128;  // 8 row groups x 16 column groups
constexpr int kF32BlockQ = 16;    // query rows per block
constexpr int kF32BlockK = 32;    // keys per K/V tile

// Shared memory in floats: rows padded by 4 floats (16 bytes), so that
// 16-byte reads of 8 neighbouring rows fall in distinct banks.
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of a (n_rows, D) matrix into a padded tile;
// rows past n_rows are zero-filled, so p = 0 never meets a stale value
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                                          int n_rows) {
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < ROWS * kVecs; i += kF32Threads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 4;
    const bool valid = row0 + r < n_rows;
    cp_async16(dst + r * (D + 4) + c, valid ? src + (size_t)(row0 + r) * D + c : src, valid);
  }
}

// grid: (query tiles of 16 rows, heads, batch). Thread (ty, tx) = (tid / 16,
// tid % 16) owns rows ty RM .. ty RM + RM - 1 of the tile; of S, keys tx
// and tx + 16 of each K tile; of O, columns 64 g + 4 tx .. + 3 for each
// 64-column group g.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const uint8_t* __restrict__ mask,
                  float* __restrict__ out, float* __restrict__ lse, int heads, int n_q, int n_kv,
                  float scale) {
  using L = F32Smem<D>;
  constexpr int BQ = kF32BlockQ;
  constexpr int RM = BQ / 8;
  constexpr int CG = D / 64;
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

  load_rows<D, BQ>(q_s, q + bh * n_q * D, q0, n_q);
  load_rows<D, kF32BlockK>(sm + L::kK, k_bh, 0, n_kv);
  load_rows<D, kF32BlockK>(sm + L::kV, v_bh, 0, n_kv);
  cp_async_commit();

  float o[RM][CG][4];
  float m_run[RM], l_run[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
#pragma unroll
    for (int g = 0; g < CG; ++g) o[i][g][0] = o[i][g][1] = o[i][g][2] = o[i][g][3] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {  // the next tile streams in while this one computes
      load_rows<D, kF32BlockK>(sm + L::kK + (st ^ 1) * kF32BlockK * kLd, k_bh,
                               (t + 1) * kF32BlockK, n_kv);
      load_rows<D, kF32BlockK>(sm + L::kV + (st ^ 1) * kF32BlockK * kLd, v_bh,
                               (t + 1) * kF32BlockK, n_kv);
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
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(k_s + tx * kLd + d);
      const float4 kb = *reinterpret_cast<const float4*>(k_s + (tx + 16) * kLd + d);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (ty * RM + i) * kLd + d);
        // one FMA after another along d, the order of the plain version's
        // fp32 product: at logits of ~1e3 another order moves them by ulps
        s[i][0] = fmaf(qv.w, ka.w, fmaf(qv.z, ka.z, fmaf(qv.y, ka.y, fmaf(qv.x, ka.x, s[i][0]))));
        s[i][1] = fmaf(qv.w, kb.w, fmaf(qv.z, kb.z, fmaf(qv.y, kb.y, fmaf(qv.x, kb.x, s[i][1]))));
      }
    }

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
      for (int g = 0; g < CG; ++g) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][g][e] *= alpha;
      }
      p_s[(ty * RM + i) * L::kLdP + tx] = p0;
      p_s[(ty * RM + i) * L::kLdP + tx + 16] = p1;
    }
    __syncwarp();  // a row's probabilities come from the 16 lanes of one half-warp

    // O += P V over the tile's real keys, rounded up to 4
    const int kv_tile = min(kF32BlockK, n_kv - k0);
    for (int kk = 0; kk < kv_tile; kk += 4) {
      float4 pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty * RM + i) * L::kLdP + kk);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          const float4 vv =
              *reinterpret_cast<const float4*>(v_s + (kk + u) * kLd + 64 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
            o[i][g][0] = fmaf(p, vv.x, o[i][g][0]);
            o[i][g][1] = fmaf(p, vv.y, o[i][g][1]);
            o[i][g][2] = fmaf(p, vv.z, o[i][g][2]);
            o[i][g][3] = fmaf(p, vv.w, o[i][g][3]);
          }
        }
      }
    }
    __syncthreads();  // this stage and p_s are consumed before they are refilled
  }

  float* out_bh = out + bh * n_q * D;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int w = 8; w > 0; w /= 2) l += __shfl_xor_sync(0xffffffffu, l, w);
    const int r = q0 + ty * RM + i;
    if (r < n_q) {
      const float inv = 1.0f / l;
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        *reinterpret_cast<float4*>(out_bh + (size_t)r * D + 64 * g + 4 * tx) =
            make_float4(o[i][g][0] * inv, o[i][g][1] * inv, o[i][g][2] * inv, o[i][g][3] * inv);
      }
      if (tx == 0) lse[bh * n_q + r] = m_run[i] + logf(l);
    }
  }
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
      !encode_bf16_3d(fn, &tm_k, k, D, n_kv, bh, kBlockN) ||
      !encode_bf16_3d(fn, &tm_v, v, D, n_kv, bh, kBlockN)) {
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

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// block_q: query rows per block, 64 or 128 for bfloat16 (one or two
// consumer warpgroups), 16 for float32. Returns 0 or the cudaError_t of the
// launch.
extern "C" int vb_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* mask, void* out, void* lse, int batch,
                                      int heads, int n_q, int n_kv, int head_dim, int dtype,
                                      int block_q, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (head_dim == 64) {
    err = launch<64>(q, k, v, mask, out, lse, batch, heads, n_q, n_kv, dtype, block_q, scale, s);
  } else if (head_dim == 128) {
    err = launch<128>(q, k, v, mask, out, lse, batch, heads, n_q, n_kv, dtype, block_q, scale, s);
  }
  return static_cast<int>(err);
}
