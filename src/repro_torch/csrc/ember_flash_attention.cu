// Flash (online-softmax) attention on Hopper (sm_90a).
//
// ember_flash_attention replaces the TPU kernel flash_attention /
// _flash_kernel (src/repro/kernels/flash_attention.py).  It computes the
// function of the reference's blockwise_attention
// (src/repro/models/attention.py), which LM.forward runs in every attention
// layer of a prefill:
//
//   o[b, s, h, :] = softmax_t(scale * <q[b, s, h], k[b, t, h / G]>) v[b, t, h / G]
//   (t <= s when causal; s - t < window with a sliding window, the band of
//   the reference's dense_local layers; G = H / Hkv heads share one KV
//   head; scale = Dqk^-1/2)
//
// in the JAX package's layout: q (B, Sq, H, Dqk), k (B, Sk, Hkv, Dqk),
// v (B, Sk, Hkv, Dv) and o (B, Sq, H, Dv), contiguous, f32 or bf16, with
// (Dqk, Dv) one of (64, 64), (80, 80), (128, 128), (192, 128) and
// (256, 256) -- (192, 128) is DeepSeek's MLA prefill (128 no-rotary columns
// and 64 rotary ones for q and k, 128 for v), (256, 256) gemma3-4b's heads.
// The running max m, the
// denominator l and the accumulator are fp32; masked scores are -1e30; the
// probabilities are rounded to the input dtype before the PV product (as
// the reference's p.astype(v.dtype)) while l sums them unrounded; the
// denominator is clamped at 1e-30.
//
// What bounds it: operations.  Causal attention over S tokens does
// S^2 * (Dqk + Dv) multiply-adds per head against S * (2 Dqk + 2 Dv)
// elements moved, far above the card's balance at these lengths.
//
// Two kernels, picked by dtype:
//
// bf16 -- flash_wgmma_kernel, on the tensor cores:
//   * One block of 3 warpgroups per (q tile of kBQ = 128 rows, head, batch).
//     Warpgroup 0 is the producer: it gives up registers (setmaxnreg) and
//     one thread issues TMA loads -- Q once, then K and V tiles of kBK keys
//     (128; 64 at Dqk = 256) into a ring of kStages stages, each with a full
//     barrier for K,
//     one for V and an empty barrier (mbarrier).  Warpgroups 1 and 2 are the
//     consumers, 64 q rows each.
//   * Tensor maps are 4-D over (B, S, heads, D) -- dims (D, heads, S, B),
//     boxes of 64 columns (128 bytes) with the 128-byte swizzle -- so a tile
//     never crosses into the next batch, and TMA's zero fill stands in for
//     masking a ragged last tile on load.  They are encoded per call on the
//     host (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: no
//     -lcuda) and passed as __grid_constant__ parameters.
//   * S = Q K^T is wgmma m64n<kBK>k16 with both operands K-major in shared
//     memory.  O += P V is wgmma with A = P from registers: the fp32 score
//     fragment is rounded to bf16 pairs in place (the reference's
//     p.astype(v.dtype)), which is already the A-fragment layout; B = V is
//     read MN-major through the transpose bit.
//   * The online softmax runs on the accumulator fragment in registers with
//     the reference's own fp32 steps (s * scale, expf), so p is the plain
//     version's to the bit wherever the scores agree; a row's max and sum
//     are reduced over the 4 threads of a quad with shuffles; only tiles
//     that cross the diagonal, the end of the keys or the lower edge of a
//     row's window band are masked.
//   * Epilogue: O / max(l, 1e-30) in bf16 is staged in the consumer's own Q
//     rows (free by then) and written by TMA stores, which leave rows past
//     seq_q unwritten.  Where the caller asks for it (training), each row's
//     log-sum-exp m + log(max(l, 1e-30)) goes to an fp32 (B, H, Sq) array
//     for the backward (ember_flash_backward.cu); serving passes null.
//   * Causal: KV tiles wholly above the diagonal are skipped (the TPU
//     kernel's `needed`), and the q tiles with the most KV tiles are
//     scheduled first (the q tile is the slowest grid dimension).
//   * Window: a block of q rows [q0, q0 + kBQ) starts at the KV tile that
//     holds key q0 - window + 1, so a layer's work is O(S * window), not
//     O(S^2).  Producer and consumers count the visited tiles from 0, so
//     the ring's stages and barrier parities run as without a window.  A
//     high row of the block may see only masked keys in that first tile: it
//     takes p = exp(0) = 1 against m = -1e30, and the first tile with a key
//     in its band wipes that with alpha = exp(-1e30 - m) = 0 -- what the
//     reference's band and the plain version, which visit those tiles too,
//     do, so the bits are the plain version's.
//   * GQA: head h reads KV head h / G directly; no repeated copy of K, V.
//   The plain version matches it tile for tile with chunk = kBK
//   (kernels/flash_attention.py kv_tile, held equal to ember_flash_kv_tile).
//
// f32 -- flash_f32_kernel, scalar fp32 FMAs from shared memory: the only
//   f32 tensor-core route is TF32, which keeps ~3 decimal digits and cannot
//   meet the f32 agreement of 1e-5.  One block of 256 threads per (64-row q
//   tile, head, batch) streams 64-key K/V tiles through shared memory held
//   as fp32, from the first tile of the window band like the bf16 kernel;
//   f32 is not on the main path.
//
// Each kernel is templated on <DQK, DV>: Q and K tiles are DQK / 64 boxes
// wide and Q K^T takes DQK / 16 wgmma k-steps (12 at DQK = 192); V and the O
// accumulator are DV wide, so at (192, 128) a consumer's registers are those
// of (128, 128).  Shared memory at (192, 128), bf16: Q 48 KiB, two stages of
// K 96 KiB and of V 64 KiB, 208 KiB in all plus the barriers and the 1 KiB
// alignment, inside the 227 KiB a block may take; O is staged in the
// consumer's Q rows, which are at least as wide.  The f32 kernel at (192, 128)
// takes 148,480 bytes of shared memory: one block per SM (two at D = 128),
// so it is built for one (F32Smem::kMinBlocks) and keeps its registers.
//
// (256, 256), bf16, would take Q 64 KiB plus two stages of 128-key K and V
// tiles, 128 KiB each: more than a block may have.  So its K/V tile is 64
// keys (FA3's choice at this width): Q 64 KiB, K 2 x 32 KiB, V 2 x 32 KiB,
// 192 KiB in all.  The scores are m64n64k16 over 16 k-steps and PV is
// m64n256k16; the O accumulator is 128 fp32 registers of a consumer
// thread (kConsumerRegs = 232).  The f32 kernel at (256, 256) takes
// 214,016 bytes: one block per SM, like (192, 128).
//
// Head dim 80 runs the (128, 128) instantiation of either kernel, padded: the
// bf16 kernel's tensor maps are 80 columns wide, so TMA fills columns 80-127
// of every Q, K and V box with zeros (Q K^T is exact, O's padded columns come
// out zero) and the O map stores only the 80 real ones; the f32 kernel loads
// columns below d into its padded shared-memory rows and stores only those.
// The cost is 128 / 80 = 1.6x the MMA work of the true width; the scale is
// the caller's (80^-1/2).  Rows of 80 bf16 are 160 bytes, a multiple of 16
// as TMA's strides must be.
//
// A bf16 call launches the wgmma kernel or returns its error: nothing falls
// back to the f32 kernel.
//
// Plain C interface (loaded with ctypes): launches on the stream it is
// given, allocates nothing, returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).

#include <cuda.h>

#include "ember_common.cuh"
#include "ember_hopper.cuh"
#include "ember_wgmma.cuh"

namespace {

using ember::bulk_commit;
using ember::bulk_wait_read;
using ember::encode_bshd;
using ember::encode_tiled;
using ember::fence_regs;
using ember::mbar_arrive;
using ember::mbar_expect_tx;
using ember::mbar_init;
using ember::mbar_init_fence;
using ember::mbar_wait;
using ember::named_barrier;
using ember::pack_bf16;
using ember::set_smem;
using ember::setmaxnreg_dec;
using ember::setmaxnreg_inc;
using ember::smem_u32;
using ember::sw128_desc;
using ember::tma_load_4d;
using ember::tma_store_4d;
using ember::wgmma_commit;
using ember::wgmma_fence;
using ember::wgmma_m64n128_rs;
using ember::wgmma_m64n128_ss;
using ember::wgmma_m64n256_rs;
using ember::wgmma_m64n64_rs;
using ember::wgmma_m64n64_ss;
using ember::wgmma_wait_all;

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: scalar kernel
// ---------------------------------------------------------------------------

constexpr int kF32BQ = 64;
constexpr int kF32BK = 64;
constexpr int kF32Threads = 256;

// Shared-memory layout in floats: Q (kF32BQ, DQK), K (kF32BK, DQK + 4),
// V (kF32BK, DV), P (kF32BQ, kF32BK).  (128, 128) takes 115,712 bytes, so
// two blocks fit one SM; (192, 128) takes 148,480, so one does.
template <int DQK, int DV> struct F32Smem {
  static constexpr int kQStride = DQK;
  static constexpr int kKStride = DQK + 4;
  static constexpr int kVStride = DV;
  static constexpr int kPStride = kF32BK;
  static constexpr int kFloats = kF32BQ * kQStride + kF32BK * kKStride +
                                 kF32BK * kVStride + kF32BQ * kPStride;
  static constexpr int kBytes = kFloats * (int)sizeof(float);
  static_assert(kBytes <= 232448, "f32 flash tiles exceed shared memory");
  // blocks that fit one SM's 228 KiB (1 KiB of it reserved per block): two
  // up to (128, 128), one at (192, 128), which may then take every register
  // a thread can have (two blocks of 256 threads cap it at 128, and
  // (192, 128) would spill there)
  static constexpr int kMinBlocks = 233472 / (kBytes + 1024) >= 2 ? 2 : 1;
};

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ const float4& f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Thread (ty, tx) owns rows ty + 16 i and, of the scores, columns
// tx + 16 j; of the accumulator, columns 64 g + 4 tx + e.  Both products
// read 16-byte vectors from shared memory, padded so the K reads are free
// of bank conflicts; row max and sum are reduced over the 16 threads of a
// row with shuffles.  The tensors' q / k rows are dq <= DQK wide and their
// v / o rows dv <= DV: the columns past them are zero in shared memory and
// never stored.
template <int DQK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(kF32Threads, F32Smem<DQK, DV>::kMinBlocks)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int seq_q, int seq_k, int heads, int kv_heads, int dq,
                 int dv, int window, float scale) {
  using S = F32Smem<DQK, DV>;
  constexpr int kG = DV / 64;           // 64-column groups of the output
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kF32BQ * S::kQStride;
  float* vs = ks + kF32BK * S::kKStride;
  float* ps = vs + kF32BK * S::kVStride;

  const int n_qt = (seq_q + kF32BQ - 1) / kF32BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kF32BQ;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // one token of q, of k, of v and of o
  const long long q_stride = (long long)heads * dq;
  const long long k_stride = (long long)kv_heads * dq;
  const long long v_stride = (long long)kv_heads * dv;
  const long long o_stride = (long long)heads * dv;
  const float* __restrict__ qb = q + ((long long)b * seq_q * heads + h) * dq;
  const float* __restrict__ kb = k + ((long long)b * seq_k * kv_heads + hk) * dq;
  const float* __restrict__ vb = v + ((long long)b * seq_k * kv_heads + hk) * dv;

  for (int e = tid; e < kF32BQ * DQK; e += kF32Threads) {
    const int r = e / DQK;
    const int c = e % DQK;
    const int s = q0 + r;
    qs[r * S::kQStride + c] = s < seq_q && c < dq ? qb[s * q_stride + c] : 0.0f;
  }

  float m[4], l[4], acc[4][4 * kG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kG; ++c) acc[i][c] = 0.0f;
  }

  int n_kt = (seq_k + kF32BK - 1) / kF32BK;
  if (CAUSAL) {   // skip the KV tiles wholly above the diagonal
    const int last_q = min(q0 + kF32BQ, seq_q) - 1;
    n_kt = min(n_kt, last_q / kF32BK + 1);
  }
  // and, with a window, those wholly below the band of the tile's first row
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kF32BK : 0;
  for (int kt = kt_lo; kt < n_kt; ++kt) {
    const int k0 = kt * kF32BK;
    __syncthreads();   // the previous tile's readers are done
    for (int e = tid; e < kF32BK * DQK; e += kF32Threads) {
      const int r = e / DQK;
      const int c = e % DQK;
      const int s = k0 + r;
      ks[r * S::kKStride + c] = s < seq_k && c < dq ? kb[s * k_stride + c] : 0.0f;
    }
    for (int e = tid; e < kF32BK * DV; e += kF32Threads) {
      const int r = e / DV;
      const int c = e % DV;
      const int s = k0 + r;
      vs[r * S::kVStride + c] = s < seq_k && c < dv ? vb[s * v_stride + c] : 0.0f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int col = 0; col < DQK; col += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = f4(qs + (ty + 16 * i) * S::kQStride + col);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = f4(ks + (tx + 16 * j) * S::kKStride + col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = sc[i][j];
          t = fmaf(a[i].x, c[j].x, t);
          t = fmaf(a[i].y, c[j].y, t);
          t = fmaf(a[i].z, c[j].z, t);
          t = fmaf(a[i].w, c[j].w, t);
          sc[i][j] = t;
        }
      }
    }

    // online softmax over this tile (p in fp32: rounding to f32 is exact)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const bool keep = k_pos < seq_k && (!CAUSAL || k_pos <= q_pos) &&
                          (window <= 0 || q_pos - k_pos < window);
        sc[i][j] = keep ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        ps[(ty + 16 * i) * S::kPStride + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kG; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V: rows ty + 16 i, columns 64 g + 4 tx + e
#pragma unroll 2
    for (int kk = 0; kk < kF32BK; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = f4(ps + (ty + 16 * i) * S::kPStride + kk);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float4 w[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          w[t] = f4(vs + (kk + t) * S::kVStride + 64 * g + 4 * tx);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* a = acc[i] + 4 * g;
          const float pv[4] = {pr[i].x, pr[i].y, pr[i].z, pr[i].w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            a[0] = fmaf(pv[t], w[t].x, a[0]);
            a[1] = fmaf(pv[t], w[t].y, a[1]);
            a[2] = fmaf(pv[t], w[t].z, a[2]);
            a[3] = fmaf(pv[t], w[t].w, a[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + ty + 16 * i;
    if (q_pos >= seq_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0) {
      lse[((long long)b * heads + h) * seq_q + q_pos] = m[i] + logf(denom);
    }
    float* __restrict__ orow = o + ((long long)b * seq_q + q_pos) * o_stride +
                               (long long)h * dv;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * g + 4 * tx + e;
        if (col < dv) orow[col] = acc[i][4 * g + e] / denom;
      }
    }
  }
}
// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;              // q rows per block: 64 per consumer
constexpr int kStages = 2;            // K/V ring depth
constexpr int kWgThreads = 384;       // producer + 2 consumer warpgroups
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Keys per K/V tile: 128, or 64 at q/k width 256, where two stages of
// 128-key K and V tiles (256 KiB with Q) would not fit shared memory.
constexpr int wg_kv_tile(int dqk) { return dqk == 256 ? 64 : 128; }

// Shared memory in bytes, from a 1024-byte-aligned base.  Every operand is
// a stack of 64-column blocks, each `rows` x 128 bytes, 128-byte swizzled:
//   Q: [consumer][column block][64 rows]; K, V: [stage][column block][kBK].
// Q and K are DQK / 64 blocks wide, V is DV / 64.
template <int DQK, int DV> struct WgSmem {
  static constexpr int kBK = wg_kv_tile(DQK);  // keys per K/V tile
  static constexpr int kCBQ = DQK / 64;       // 64-column blocks of a q/k row
  static constexpr int kCBV = DV / 64;        // of a v / o row
  static constexpr int kQCB = 64 * 128;       // one block of a consumer's Q
  static constexpr int kQWg = kCBQ * kQCB;    // one consumer's 64 Q rows
  static constexpr int kKVCB = kBK * 128;     // one block of a K or V tile
  static constexpr int kKT = kCBQ * kKVCB;    // one K tile
  static constexpr int kVT = kCBV * kKVCB;    // one V tile
  static constexpr int kK = 2 * kQWg;
  static constexpr int kV = kK + kStages * kKT;
  static constexpr int kBar = kV + kStages * kVT;
  // barriers: Q, then full K, full V and empty for each stage
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
  static_assert(DQK % 64 == 0 && (DV == 64 || DV == 128 || DV == 256),
                "q/k width a multiple of 64, v width 64, 128 or 256");
  // the epilogue stages O (DV wide) in the consumer's own Q rows
  static_assert(DV <= DQK, "O must fit the consumer's Q rows");
  static_assert(kBytes <= 232448, "flash tiles exceed shared memory");
};

template <int DQK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap,
                   float* __restrict__ lse, int seq_q,
                   int seq_k, int heads, int kv_heads, int window,
                   float scale) {
  using L = WgSmem<DQK, DV>;
  constexpr int kBK = L::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle's alignment
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full_k = bar_q + 8;             // + 8 * stage
  const uint32_t bar_full_v = bar_full_k + 8 * kStages;
  const uint32_t bar_empty = bar_full_v + 8 * kStages;

  const int n_qt = (seq_q + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * kBQ;  // longest rows first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (heads / kv_heads);
  int n_kt = (seq_k + kBK - 1) / kBK;
  if (CAUSAL) {   // skip the KV tiles wholly above the diagonal
    n_kt = min(n_kt, (min(q0 + kBQ, seq_q) - 1) / kBK + 1);
  }
  // and, with a window, those wholly below the band of the block's first
  // row; producer and consumers count tiles i = kt - kt_lo from 0, so the
  // ring's stage and parity start where they do without a window
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  const int n_visit = n_kt - kt_lo;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full_k + 8 * s, 1);
      mbar_init(bar_full_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);     // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kBQ * DQK * 2);
      for (int i = 0; i < 2; ++i) {
        for (int cb = 0; cb < L::kCBQ; ++cb) {
          tma_load_4d(base + i * L::kQWg + cb * L::kQCB, &qmap, bar_q,
                      64 * cb, h, q0 + 64 * i, b);
        }
      }
      for (int i = 0; i < n_visit; ++i) {
        const int kt = kt_lo + i;
        const int st = i % kStages;
        if (i >= kStages) {   // the stage's previous tile is released
          mbar_wait(bar_empty + 8 * st, ((i / kStages) & 1) ^ 1);
        }
        const uint32_t k_s = base + L::kK + st * L::kKT;
        const uint32_t v_s = base + L::kV + st * L::kVT;
        // the full box is counted, zero fill past seq_k included
        mbar_expect_tx(bar_full_k + 8 * st, kBK * DQK * 2);
        for (int cb = 0; cb < L::kCBQ; ++cb) {
          tma_load_4d(k_s + cb * L::kKVCB, &kmap, bar_full_k + 8 * st,
                      64 * cb, hk, kt * kBK, b);
        }
        mbar_expect_tx(bar_full_v + 8 * st, kBK * DV * 2);
        for (int cb = 0; cb < L::kCBV; ++cb) {
          tma_load_4d(v_s + cb * L::kKVCB, &vmap, bar_full_v + 8 * st,
                      64 * cb, hk, kt * kBK, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    // accumulator fragment: this thread's rows r0 and r0 + 8 of the 64, and
    // in every 8-column chunk j the columns 8 j + c0 and 8 j + c0 + 1;
    // element 4 j + 2 half + e is (r0 + 8 half, 8 j + c0 + e)
    const int r0 = 16 * (tid / 32) + lane / 4;
    const int c0 = 2 * (lane % 4);
    const int q_lo = q0 + 64 * c;
    const uint32_t q_s = base + c * L::kQWg;

    float o[DV / 2];
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) o[e] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};

    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_visit; ++i) {
      const int st = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int k0 = (kt_lo + i) * kBK;

      // S = Q K^T over DQK / 16 steps of 16 columns (32 bytes)
      float s[kBK / 2];
      mbar_wait(bar_full_k + 8 * st, parity);
      const uint32_t k_s = base + L::kK + st * L::kKT;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // within the 128-byte row
        const uint64_t qd = sw128_desc(q_s + (kk / 4) * L::kQCB + off, 16);
        const uint64_t kd = sw128_desc(k_s + (kk / 4) * L::kKVCB + off, 16);
        if constexpr (kBK == 128) {
          wgmma_m64n128_ss(s, qd, kd, kk > 0);
        } else {
          wgmma_m64n64_ss(s, qd, kd, kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // online softmax: the reference's fp32 arithmetic, step for step
      // (s * scale, expf), so p rounds to bf16 as the plain version's does
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) s[e] *= scale;
      // a tile is masked per element where it crosses the end of the keys,
      // the diagonal, or the lower edge of some row's band (q - k < window)
      const bool edge = k0 + kBK > seq_k || (CAUSAL && k0 + kBK - 1 > q_lo) ||
                        (window > 0 && k0 + window <= q_lo + 63);
      if (edge) {
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) {
          const int k_pos = k0 + 8 * (e / 4) + c0 + (e % 2);
          const int q_pos = q_lo + r0 + 8 * ((e / 2) % 2);
          if (k_pos >= seq_k || (CAUSAL && k_pos > q_pos) ||
              (window > 0 && q_pos - k_pos >= window)) {
            s[e] = kNegInf;
          }
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) {
        mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], s[e]);
      }
      float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
      // p: fp32 into l, rounded to bf16 pairs for PV; pair t of the score
      // fragment is register t of P, and registers 4 kk .. 4 kk + 3 are the
      // A fragment of keys 16 kk .. 16 kk + 15
      uint32_t p[kBK / 4];
#pragma unroll
      for (int t = 0; t < kBK / 4; ++t) {
        const int r = t % 2;
        const float p0 = expf(s[2 * t] - m[r]);
        const float p1 = expf(s[2 * t + 1] - m[r]);
        rs[r] += p0 + p1;
        p[t] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = l[r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int e = 0; e < DV / 2; ++e) o[e] *= alpha[(e / 2) % 2];
      fence_regs(o);   // written before the fence that orders them for wgmma
      fence_regs(p);

      // O += P V over kBK / 16 steps of 16 keys (2048 bytes of V)
      mbar_wait(bar_full_v + 8 * st, parity);
      const uint32_t v_s = base + L::kV + st * L::kVT;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t vd = sw128_desc(v_s + kk * 16 * 128, L::kKVCB);
        if constexpr (DV == 256) {
          wgmma_m64n256_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3], vd);
        } else if constexpr (DV == 128) {
          wgmma_m64n128_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3], vd);
        } else {
          wgmma_m64n64_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                          p[4 * kk + 3], vd);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }

    // epilogue: O / max(l, 1e-30) in bf16 into this consumer's Q rows
    // (swizzled as the O map expects), then TMA stores of whole boxes
    const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
    if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q_pos = q_lo + r0 + 8 * r;
        if (q_pos < seq_q) {
          lse[((long long)b * heads + h) * seq_q + q_pos] = m[r] + logf(den[r]);
        }
      }
    }
    uint8_t* const q_gen = smem + c * L::kQWg;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        const int off = (j / 8) * L::kQCB + row * 128 +
                        (((j % 8) ^ (row % 8)) * 16) + c0 * 2;
        *reinterpret_cast<uint32_t*>(q_gen + off) =
            pack_bf16(o[4 * j + 2 * r] / den[r], o[4 * j + 2 * r + 1] / den[r]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_barrier(1 + c, 128);
    if (tid == 0 && q_lo < seq_q) {
      for (int cb = 0; cb < L::kCBV; ++cb) {
        tma_store_4d(&omap, q_s + cb * L::kQCB, 64 * cb, h, q_lo, b);
      }
      bulk_commit();
      bulk_wait_read<0>();
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int batch;
  int seq_q;
  int seq_k;
  int heads;
  int kv_heads;
  int dq;         // the tensors' q / k width: the instantiation's DQK, or less
  int dv;         // their v / o width: DV, or less
  int window;     // q - k < window, or 0 for none
  float scale;
  float* lse;     // (batch, heads, seq_q) fp32 log-sum-exp, or null
};

template <int DQK, int DV, bool CAUSAL>
int launch_f32(const FlashArgs& a, cudaStream_t s) {
  constexpr int kBytes = F32Smem<DQK, DV>::kBytes;
  auto kernel = flash_f32_kernel<DQK, DV, CAUSAL>;
  const cudaError_t err = set_smem(kernel, kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((a.seq_q + kF32BQ - 1) / kF32BQ),
                  (unsigned int)a.heads, (unsigned int)a.batch);
  kernel<<<grid, kF32Threads, kBytes, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.seq_q,
      a.seq_k, a.heads, a.kv_heads, a.dq, a.dv, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int DQK, int DV, bool CAUSAL>
int launch_bf16(const FlashArgs& a, cudaStream_t s) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  constexpr int kBK = WgSmem<DQK, DV>::kBK;
  CUtensorMap qm, km, vm, om;
  if (!encode_bshd(&qm, a.q, a.batch, a.seq_q, a.heads, a.dq, 64) ||
      !encode_bshd(&km, a.k, a.batch, a.seq_k, a.kv_heads, a.dq, kBK) ||
      !encode_bshd(&vm, a.v, a.batch, a.seq_k, a.kv_heads, a.dv, kBK) ||
      !encode_bshd(&om, a.o, a.batch, a.seq_q, a.heads, a.dv, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int kBytes = WgSmem<DQK, DV>::kBytes;
  auto kernel = flash_wgmma_kernel<DQK, DV, CAUSAL>;
  const cudaError_t err = set_smem(kernel, kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)a.heads, (unsigned int)a.batch,
                  (unsigned int)((a.seq_q + kBQ - 1) / kBQ));
  kernel<<<grid, kWgThreads, kBytes, s>>>(qm, km, vm, om, a.lse, a.seq_q,
                                          a.seq_k, a.heads, a.kv_heads,
                                          a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_by_dtype(int dtype, bool causal, const FlashArgs& a,
                    cudaStream_t s) {
  if (dtype == 0) {
    return causal ? launch_f32<DQK, DV, true>(a, s)
                  : launch_f32<DQK, DV, false>(a, s);
  }
  return causal ? launch_bf16<DQK, DV, true>(a, s)
                : launch_bf16<DQK, DV, false>(a, s);
}

}  // namespace

// q: (batch, seq_q, heads, head_dim); k: (batch, seq_k, kv_heads,
// head_dim); v: (batch, seq_k, kv_heads, v_head_dim); o: (batch, seq_q,
// heads, v_head_dim); all contiguous, one dtype (0 = float32, 1 = bfloat16;
// bf16 pointers 16-byte aligned, as TMA needs).  (head_dim, v_head_dim) one
// of (64, 64), (80, 80) (padded to 128), (128, 128), (192, 128) and
// (256, 256); heads a multiple of kv_heads.  window > 0 keeps the keys with
// q - k < window (0: no window); every query row must keep one key
// (seq_q - window < seq_k).  scale multiplies the fp32 scores (the
// reference's head_dim ** -0.5).  A non-null lse receives each row's fp32
// log-sum-exp m + log(max(l, 1e-30)), (batch, heads, seq_q), for the
// backward (ember_flash_attention_bwd); inference passes null and the
// kernels write o alone.
extern "C" int ember_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int batch,
                                     int seq_q, int seq_k, int heads,
                                     int kv_heads, int head_dim,
                                     int v_head_dim, int dtype, int causal,
                                     int window, double scale, void* lse,
                                     void* stream) {
  const bool dims_ok = (head_dim == v_head_dim &&
                        (head_dim == 64 || head_dim == 80 ||
                         head_dim == 128 || head_dim == 256)) ||
                       (head_dim == 192 && v_head_dim == 128);
  if (batch <= 0 || batch > 65535 || seq_q <= 0 || seq_k <= 0 ||
      heads <= 0 || heads > 65535 || kv_heads <= 0 ||
      heads % kv_heads != 0 || !dims_ok || (dtype != 0 && dtype != 1) ||
      window < 0 || (window > 0 && seq_q - window >= seq_k)) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1 &&
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0 ||
       (seq_q + kBQ - 1) / kBQ > 65535)) {
    return (int)cudaErrorInvalidValue;
  }
  const FlashArgs a{q, k, v, o, batch, seq_q, seq_k, heads, kv_heads,
                    head_dim, v_head_dim, window, (float)scale,
                    static_cast<float*>(lse)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  if (head_dim == 64) return launch_by_dtype<64, 64>(dtype, c, a, s);
  if (head_dim == 192) return launch_by_dtype<192, 128>(dtype, c, a, s);
  if (head_dim == 256) return launch_by_dtype<256, 256>(dtype, c, a, s);
  // head dim 80 runs the (128, 128) instantiation, padded (see the top)
  return launch_by_dtype<128, 128>(dtype, c, a, s);
}

// The KV tile of the kernel that runs `dtype` (0 = float32, 1 = bfloat16)
// at q/k width `head_dim`, or 0 where there is none.  The plain version
// must sum over chunks of this many keys to round p against the same
// running max, so the checks read their chunk from
// kernels/flash_attention.py kv_tile, which must equal this (chip_smoke.py
// phase 2 and tests/test_torch_cuda.py hold them equal).
extern "C" int ember_flash_kv_tile(int dtype, int head_dim) {
  if (head_dim != 64 && head_dim != 80 && head_dim != 128 &&
      head_dim != 192 && head_dim != 256) {
    return 0;
  }
  return dtype == 0 ? kF32BK : dtype == 1 ? wg_kv_tile(head_dim) : 0;
}
