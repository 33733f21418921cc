// The backward of flash attention on Hopper (sm_90a).
//
// The TPU package has no backward kernel: it differentiates
// blockwise_attention (src/repro/models/attention.py) with jax.grad, and
// that function is what the forward kernel ember_flash_attention
// (ember_flash_attention.cu) replaces on the card.  These kernels stand
// where that gradient stood.  They compute, from the forward's inputs, its
// output o, the cotangent do and the forward's fp32 log-sum-exp lse
// (B, H, Sq), the FlashAttention-2 recurrence:
//
//   P[s, t]  = exp(scale * <q[s], k[t]> - lse[s])   (0 where masked)
//   delta[s] = sum_e do[s, e] o[s, e]
//   dS[s, t] = P[s, t] (<do[s], v[t]> - delta[s])
//   dq[s]    = scale * sum_t dS[s, t] k[t]
//   dk[t]    = scale * sum_{h in the group} sum_s dS[s, t] q[s]
//   dv[t]    = sum_{h in the group} sum_s P[s, t] do[s]
//
// in the forward's layout (q, dq (B, Sq, H, Dqk); k, dk (B, Sk, Hkv, Dqk);
// v, dv (B, Sk, Hkv, Dv); o, do (B, Sq, H, Dv)), with its masks: t <= s when
// causal, s - t < window with a sliding window.  Every sum is fp32; each
// gradient is rounded to the input dtype once.
//
// Three passes, launched in order on the caller's stream:
//   (a) flash_bwd_rows_kernel: per (b, h) a row of lse and one of delta,
//       one warp per (token, head), into the caller's fp32 scratch, padded
//       with zeros to a multiple of 128 queries;
//   (b) dK and dV: one block per (KV tile, KV head, batch).  It keeps the
//       tile's K and V in shared memory and its dK and dV in registers, and
//       loops over the group's query heads and over the q tiles that see
//       the tile (under the causal diagonal, inside the window band), so
//       the GQA sum stays inside the block;
//   (c) dQ: one block per (q tile, head, batch), longest rows first, over
//       the KV tiles its rows see.
// No atomics: each gradient element is summed by one thread in a fixed
// order, so two calls on the same inputs give the same bits (a restarted
// training step repeats its loss bit for bit).  S and dP are recomputed in
// both (b) and (c): seven products a pair instead of five, the price of one
// writer per element.
//
// What bounds it: operations.  Each (query, key) pair the masks keep needs
// five products of its row widths -- S and dK, dQ at Dqk, dP and dV at Dv:
// 2 (3 Dqk + 2 Dv) FLOP, 10 D at D = Dqk = Dv -- against O(S (Dqk + Dv))
// elements moved.
//
// Two variants of (b) and (c); the caller picks one
// (kernels/flash_attention.py backward_variant):
//
// wgmma -- bf16 at (64, 64), (80, 80) and (128, 128), on the tensor cores
//   (flash_bwd_dkdv_wgmma_kernel, flash_bwd_dq_wgmma_kernel).  Each block
//   is three warpgroups: a producer that gives up registers (setmaxnreg) and
//   streams tiles by TMA into a ring of kWgStages stages (full and empty
//   mbarriers; the tensor maps and wgmma descriptors are the forward's,
//   ember_wgmma.cuh), and two consumers.
//   * (b): 128 keys a block, 64 a consumer.  K and V are loaded once; each
//     stage holds Q and dO of 64 queries and, by bulk copy, their lse and
//     delta rows.  A consumer computes S^T = K Q^T and dP^T = V dO^T
//     (m64n64, Q and dO K-major; K and V as A fragments kept in registers
//     at D = 80, from shared memory otherwise), so its keys are the
//     fragments' rows; P^T = exp(scale S^T - lse) and dS^T = P^T (dP^T -
//     delta) in registers; then dV += P^T dO and dK += dS^T Q with P^T
//     and dS^T rounded to bf16 pairs in place -- the accumulator layout is
//     the A fragment's, as P is in the forward's O += P V -- and dO, Q
//     read MN-major through the transpose bit.
//   * (c): 128 queries a block, 64 a consumer, Q and dO loaded once (kept
//     as A fragments in registers at D = 80 and 128), K/V tiles of 64 keys
//     streamed: S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K with
//     K read MN-major.
//   * Each consumer commits S and dP as two wgmma groups and waits for the
//     first alone (wgmma.wait_group 1): P is computed while dP is still on
//     the tensor cores, and in (b) dS while dV is.  The two consumers'
//     chains interleave on the tensor cores.
//   * The tensor cores take P and dS as bf16 (fp32 sums); the plain version
//     rounds them the same way in this variant's mode
//     (ref.attention_backward(..., tensor_cores=True)).  P takes the plain
//     version's fp32 steps -- the scaled score rounded (__fmul_rn, never
//     contracted into an FMA), lse subtracted, expf, which is torch.exp's
//     -- so P and dS are its bits wherever the scores are (danube's dQ
//     came out bit-equal to the plain version's).  Bits matter, not only
//     values: a P a few ulps off moves bf16-rounded P and dS across a step
//     often enough that sums over 16k queries differ in more elements.
//     Both cheaper exponentials tried on the H100 -- ex2.approx with
//     log2 e folded in against the plain version's exp, and exp2f against
//     a plain exp2 -- were faster but put more than check_bf16's 1 % of
//     danube's dK, dV elements a bf16 step off (PERF.md).
//   * Head dim 80 at its true width: Q K^T and dO V^T take 5 k16 steps
//     (columns 64-79 from the second 64-column block, whose zero fill past
//     80 is never read) and dV, dK, dQ are m64n80 (two 64-column blocks,
//     the second read for 16 columns).  Nothing is padded to 128.
//   * Tiles crossing the diagonal, the band's lower edge, or the end of
//     the queries or keys are masked per element; TMA zero-fills rows past
//     seq_q / seq_k, and the scratch's lse and delta are 0 there.
//   * Registers: a (b) consumer holds dK and dV (D fp32 each a thread),
//     S^T and dP^T (32 each) and their bf16 pairs; at D = 128 that is near
//     the 240 a consumer gets (chip_smoke.py phase 2 requires no spill).
//   * dK (scaled once), dV and dQ are stored from the fragments, 4 bytes a
//     thread, only columns below D and rows inside the tensors.
//
// SIMT -- everything else: f32, and bf16 at (192, 128) and (256, 256),
//   whose two D-wide fp32 accumulators would not fit a warpgroup's
//   registers (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel).  Scalar fp32
//   FMAs from shared memory, inputs widened to fp32 there, a 16 x 16
//   thread grid where thread (ty, tx) owns rows ty + 16 i and columns
//   tx + 16 j of every tile (row strides padded by one float, so neither
//   operand's reads conflict on a bank); P and dS stay fp32; kBK = 64-key
//   tiles.  Head dim 80 runs at its true width.
//
// Plain C interface (loaded with ctypes): launches on the stream it is
// given, allocates nothing (the lse/delta rows are the caller's fp32
// scratch, ember_flash_bwd_rows), returns the cudaError_t of the launches
// (cudaErrorInvalidValue for arguments the kernels do not take).

#include "ember_common.cuh"
#include "ember_hopper.cuh"
#include "ember_wgmma.cuh"

namespace {

using ember::bulk_load;
using ember::encode_bshd;
using ember::encode_tiled;
using ember::fence_regs;
using ember::from_float;
using ember::mbar_arrive;
using ember::mbar_expect_tx;
using ember::mbar_init;
using ember::mbar_init_fence;
using ember::mbar_wait;
using ember::pack_bf16;
using ember::set_smem;
using ember::setmaxnreg_dec;
using ember::setmaxnreg_inc;
using ember::smem_u32;
using ember::sw128_desc;
using ember::tma_load_4d;
using ember::to_float;
using ember::wgmma_commit;
using ember::wgmma_fence;
using ember::wgmma_m64n128_rs;
using ember::wgmma_m64n64_rs;
using ember::wgmma_m64n64_rs_kb;
using ember::wgmma_m64n64_ss;
using ember::wgmma_m64n80_rs;
using ember::wgmma_wait;
using ember::wgmma_wait_all;

constexpr int kThreads = 256;   // 16 x 16
constexpr int kBK = 64;         // keys per KV tile

// Tiles and shared memory (floats).  kBQ is the q tile: 64 rows, 32 where
// q/k is wider than 128 so the (256, 256) tiles fit a block's 227 KiB.
template <int DQK, int DV> struct BwdTiles {
  static constexpr int kBQ = DQK > 128 ? 32 : 64;
  static constexpr int kQS = DQK + 1;   // q / k row stride
  static constexpr int kVS = DV + 1;    // v / o row stride
  static constexpr int kSS = kBK + 1;   // P / dS row stride
  // (b): K, V, Q, dO, P, dS, lse, delta
  static constexpr int kDkdvFloats = kBK * kQS + kBK * kVS + kBQ * kQS +
                                     kBQ * kVS + 2 * kBQ * kSS + 2 * kBQ;
  // (c): the same without P
  static constexpr int kDqFloats = kDkdvFloats - kBQ * kSS;
  static constexpr int kDkdvBytes = kDkdvFloats * (int)sizeof(float);
  static constexpr int kDqBytes = kDqFloats * (int)sizeof(float);
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "widths a multiple of 16");
  static_assert(kDkdvBytes <= 232448, "backward tiles exceed shared memory");
};

// rows [row0, row0 + rows) of a (.., width) operand whose token rows are
// `stride` elements apart, widened to fp32 at `dst` (row stride ds); rows
// at or past n_valid read as 0
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ds,
                                          const T* __restrict__ src,
                                          long long stride, int row0,
                                          int rows, int n_valid, int width) {
  for (int e = threadIdx.x; e < rows * width; e += kThreads) {
    const int r = e / width;
    const int c = e % width;
    const int s = row0 + r;
    dst[r * ds + c] = s < n_valid ? to_float(src[s * stride + c]) : 0.0f;
  }
}

// acc[a][c] = sum_d A[ty + 16 a][d] B[tx + 16 c][d]
template <int RA, int RB, int W>
__device__ __forceinline__ void dot_rows(float (&acc)[RA][RB],
                                         const float* A, int as,
                                         const float* B, int bs, int ty,
                                         int tx) {
#pragma unroll
  for (int a = 0; a < RA; ++a) {
#pragma unroll
    for (int c = 0; c < RB; ++c) acc[a][c] = 0.0f;
  }
#pragma unroll 4
  for (int d = 0; d < W; ++d) {
    float x[RA], y[RB];
#pragma unroll
    for (int a = 0; a < RA; ++a) x[a] = A[(ty + 16 * a) * as + d];
#pragma unroll
    for (int c = 0; c < RB; ++c) y[c] = B[(tx + 16 * c) * bs + d];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
#pragma unroll
      for (int c = 0; c < RB; ++c) acc[a][c] = fmaf(x[a], y[c], acc[a][c]);
    }
  }
}

// acc[r][c] += sum_{i < N} P[i][ty + 16 r] X[i][tx + 16 c]  (P^T X)
template <int RJ, int CE, int N>
__device__ __forceinline__ void acc_tn(float (&acc)[RJ][CE], const float* P,
                                       int ps, const float* X, int xs,
                                       int ty, int tx) {
#pragma unroll 2
  for (int i = 0; i < N; ++i) {
    float p[RJ], x[CE];
#pragma unroll
    for (int r = 0; r < RJ; ++r) p[r] = P[i * ps + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < CE; ++c) x[c] = X[i * xs + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < RJ; ++r) {
#pragma unroll
      for (int c = 0; c < CE; ++c) acc[r][c] = fmaf(p[r], x[c], acc[r][c]);
    }
  }
}

__device__ __forceinline__ bool kept(bool causal, int window, int q_pos,
                                     int k_pos, int seq_q, int seq_k) {
  return q_pos < seq_q && k_pos < seq_k && (!causal || k_pos <= q_pos) &&
         (window <= 0 || q_pos - k_pos < window);
}

// (a) the rows scratch: for each (b, h), lse[b, h, s] and delta[b, h, s] =
// sum_e do[b, s, h, e] o[b, s, h, e] over s < seq_q, zeros on to seq_qp
// (so the wgmma kernels copy whole 64-row chunks of both in bounds); one
// warp a (token, head) row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_rows_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ rows,
                      long long n_rows, int seq_q, int seq_qp, int heads,
                      int dv) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  // row = (b * seq_qp + s) * heads + h
  const long long h = row % heads;
  const long long s = (row / heads) % seq_qp;
  const long long b = row / ((long long)heads * seq_qp);
  float acc = 0.0f;
  if (s < seq_q) {
    const long long src = ((b * seq_q + s) * heads + h) * dv;
    for (int c = lane; c < dv; c += 32) {
      acc = fmaf(to_float(o[src + c]), to_float(dout[src + c]), acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    float* r = rows + (b * heads + h) * 2 * seq_qp;
    r[s] = s < seq_q ? lse[(b * heads + h) * seq_q + s] : 0.0f;
    r[seq_qp + s] = acc;
  }
}

// (b) dK and dV of one KV tile
template <typename T, int DQK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ rows, T* __restrict__ dk,
                      T* __restrict__ dv, int seq_q, int seq_qp, int seq_k,
                      int heads, int kv_heads, int window, float scale) {
  using L = BwdTiles<DQK, DV>;
  constexpr int kBQ = L::kBQ;
  constexpr int RQ = kBQ / 16, RK = kBK / 16, CQK = DQK / 16, CV = DV / 16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kBK * L::kQS;
  float* qs = vs + kBK * L::kVS;
  float* dos = qs + kBQ * L::kQS;
  float* ps = dos + kBQ * L::kVS;
  float* dss = ps + kBQ * L::kSS;
  float* lse_s = dss + kBQ * L::kSS;
  float* dl_s = lse_s + kBQ;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kBK;
  const int group = heads / kv_heads;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long q_stride = (long long)heads * DQK;
  const long long o_stride = (long long)heads * DV;
  const long long k_stride = (long long)kv_heads * DQK;
  const long long v_stride = (long long)kv_heads * DV;
  const long long k_off = ((long long)b * seq_k * kv_heads + hk);

  load_rows(ks, L::kQS, k + k_off * DQK, k_stride, k0, kBK, seq_k, DQK);
  load_rows(vs, L::kVS, v + k_off * DV, v_stride, k0, kBK, seq_k, DV);

  float dk_acc[RK][CQK], dv_acc[RK][CV];
#pragma unroll
  for (int r = 0; r < RK; ++r) {
#pragma unroll
    for (int c = 0; c < CQK; ++c) dk_acc[r][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < CV; ++c) dv_acc[r][c] = 0.0f;
  }

  // the query rows that see a key of [k0, k_end): from the diagonal when
  // causal, below k_end - 1 + window with a window
  const int k_end = min(k0 + kBK, seq_k);
  const int q_lo = CAUSAL ? k0 : 0;
  const int q_hi = window > 0 ? min(seq_q, k_end - 1 + window) : seq_q;
  const int qt_lo = q_lo / kBQ;
  const int qt_hi = q_lo < q_hi ? (q_hi + kBQ - 1) / kBQ : qt_lo;

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const long long q_off = (long long)b * seq_q * heads + h;
    const float* lb = rows + ((long long)b * heads + h) * 2 * seq_qp;
    const float* db = lb + seq_qp;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();   // the previous tile's readers are done
      load_rows(qs, L::kQS, q + q_off * DQK, q_stride, q0, kBQ, seq_q, DQK);
      load_rows(dos, L::kVS, dout + q_off * DV, o_stride, q0, kBQ, seq_q, DV);
      if (threadIdx.x < kBQ) {
        const int s = q0 + threadIdx.x;
        lse_s[threadIdx.x] = s < seq_q ? lb[s] : 0.0f;
        dl_s[threadIdx.x] = s < seq_q ? db[s] : 0.0f;
      }
      __syncthreads();

      float sc[RQ][RK], dp[RQ][RK];
      dot_rows<RQ, RK, DQK>(sc, qs, L::kQS, ks, L::kQS, ty, tx);
      dot_rows<RQ, RK, DV>(dp, dos, L::kVS, vs, L::kVS, ty, tx);
#pragma unroll
      for (int a = 0; a < RQ; ++a) {
        const int i = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < RK; ++c) {
          const int j = tx + 16 * c;
          const float p = kept(CAUSAL, window, q0 + i, k0 + j, seq_q, seq_k)
                              ? expf(sc[a][c] * scale - lse_s[i])
                              : 0.0f;
          ps[i * L::kSS + j] = p;
          dss[i * L::kSS + j] = p * (dp[a][c] - dl_s[i]);
        }
      }
      __syncthreads();

      acc_tn<RK, CV, kBQ>(dv_acc, ps, L::kSS, dos, L::kVS, ty, tx);
      acc_tn<RK, CQK, kBQ>(dk_acc, dss, L::kSS, qs, L::kQS, ty, tx);
    }
  }

#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int t = k0 + ty + 16 * r;
    if (t >= seq_k) continue;
    T* dkr = dk + (k_off + (long long)t * kv_heads) * DQK;
    T* dvr = dv + (k_off + (long long)t * kv_heads) * DV;
#pragma unroll
    for (int c = 0; c < CQK; ++c) {
      dkr[tx + 16 * c] = from_float<T>(dk_acc[r][c] * scale);
    }
#pragma unroll
    for (int c = 0; c < CV; ++c) dvr[tx + 16 * c] = from_float<T>(dv_acc[r][c]);
  }
}

// (c) dQ of one q tile
template <typename T, int DQK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ rows, T* __restrict__ dq,
                    int seq_q, int seq_qp, int seq_k, int heads, int kv_heads,
                    int window, float scale) {
  using L = BwdTiles<DQK, DV>;
  constexpr int kBQ = L::kBQ;
  constexpr int RQ = kBQ / 16, RK = kBK / 16, CQK = DQK / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kBQ * L::kQS;
  float* ks = dos + kBQ * L::kVS;
  float* vs = ks + kBK * L::kQS;
  float* dss = vs + kBK * L::kVS;
  float* lse_s = dss + kBQ * L::kSS;
  float* dl_s = lse_s + kBQ;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_qt = (seq_q + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * kBQ;   // longest rows first
  const int hk = h / (heads / kv_heads);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long q_stride = (long long)heads * DQK;
  const long long o_stride = (long long)heads * DV;
  const long long k_stride = (long long)kv_heads * DQK;
  const long long v_stride = (long long)kv_heads * DV;
  const long long q_off = (long long)b * seq_q * heads + h;
  const long long k_off = (long long)b * seq_k * kv_heads + hk;

  load_rows(qs, L::kQS, q + q_off * DQK, q_stride, q0, kBQ, seq_q, DQK);
  load_rows(dos, L::kVS, dout + q_off * DV, o_stride, q0, kBQ, seq_q, DV);
  if (threadIdx.x < kBQ) {
    const int s = q0 + threadIdx.x;
    const long long row = ((long long)b * heads + h) * 2 * seq_qp + s;
    lse_s[threadIdx.x] = s < seq_q ? rows[row] : 0.0f;
    dl_s[threadIdx.x] = s < seq_q ? rows[row + seq_qp] : 0.0f;
  }

  float dq_acc[RQ][CQK];
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
#pragma unroll
    for (int c = 0; c < CQK; ++c) dq_acc[a][c] = 0.0f;
  }

  int n_kt = (seq_k + kBK - 1) / kBK;
  if (CAUSAL) {   // the KV tiles wholly above the diagonal are skipped
    n_kt = min(n_kt, (min(q0 + kBQ, seq_q) - 1) / kBK + 1);
  }
  // and those wholly below the band of the tile's first row
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  for (int kt = kt_lo; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's readers are done
    load_rows(ks, L::kQS, k + k_off * DQK, k_stride, k0, kBK, seq_k, DQK);
    load_rows(vs, L::kVS, v + k_off * DV, v_stride, k0, kBK, seq_k, DV);
    __syncthreads();

    float sc[RQ][RK], dp[RQ][RK];
    dot_rows<RQ, RK, DQK>(sc, qs, L::kQS, ks, L::kQS, ty, tx);
    dot_rows<RQ, RK, DV>(dp, dos, L::kVS, vs, L::kVS, ty, tx);
#pragma unroll
    for (int a = 0; a < RQ; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < RK; ++c) {
        const int j = tx + 16 * c;
        const float p = kept(CAUSAL, window, q0 + i, k0 + j, seq_q, seq_k)
                            ? expf(sc[a][c] * scale - lse_s[i])
                            : 0.0f;
        dss[i * L::kSS + j] = p * (dp[a][c] - dl_s[i]);
      }
    }
    __syncthreads();

    // dq[i][d] += sum_j dS[i][j] K[j][d]
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float x[RQ], y[CQK];
#pragma unroll
      for (int a = 0; a < RQ; ++a) x[a] = dss[(ty + 16 * a) * L::kSS + j];
#pragma unroll
      for (int c = 0; c < CQK; ++c) y[c] = ks[j * L::kQS + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < RQ; ++a) {
#pragma unroll
        for (int c = 0; c < CQK; ++c) {
          dq_acc[a][c] = fmaf(x[a], y[c], dq_acc[a][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    const int s = q0 + ty + 16 * a;
    if (s >= seq_q) continue;
    T* dqr = dq + (q_off + (long long)s * heads) * DQK;
#pragma unroll
    for (int c = 0; c < CQK; ++c) {
      dqr[tx + 16 * c] = from_float<T>(dq_acc[a][c] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at (64, 64), (80, 80), (128, 128): wgmma kernels fed by TMA
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;       // producer + 2 consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kWgStages = 3;          // depth of the streamed-tile ring
constexpr int kRowsPad = 128;         // seq_qp: seq_q rounded up to this

// Shared memory in bytes from a 1024-byte-aligned base.  Every operand is
// a stack of 64-column blocks (128 bytes a row, 128-byte swizzled, as TMA
// writes them); a row of width D is kCB blocks, columns past D zero-filled.
//   dK/dV kernel: K and V of the block's 128 keys ([block][128 rows]), and
//     per stage Q and dO of 64 queries ([block][64 rows]) with their 64 lse
//     and 64 delta values;
//   dQ kernel: Q and dO of the block's 128 queries ([consumer][block][64
//     rows]), and per stage K and V of 64 keys.
template <int D> struct WgBwd {
  static constexpr int kCB = (D + 63) / 64;   // 64-column blocks of a row
  static constexpr int kKSteps = D / 16;      // k16 steps over D columns
  static constexpr int kBlk = 64 * 128;       // one block of 64 rows
  static constexpr int kT64 = kCB * kBlk;     // a tile of 64 rows
  static constexpr int kT128 = 2 * kT64;      // a tile of 128 rows
  // whether a consumer keeps the fixed operand of S and dP as A fragments
  // in registers (D / 2 registers a thread for each of the two), so those
  // products read only the streamed tiles from shared memory: K and V in
  // the dK/dV kernel at D = 80 (at 128 the dK and dV accumulators leave no
  // room under kConsumerRegs), Q and dO in the dQ kernel at 80 and 128.
  // At D = 64 the register form gave wrong dK, dV and causal dQ on the
  // H100 in this loop (right in a loop that issued the next tile's scores
  // before waiting; the cause is not found: PERF.md), so 64 reads
  // both operands from shared memory, the form verified there.
  static constexpr bool kKvInRegs = D == 80;
  static constexpr bool kQdoInRegs = D >= 80;
  // dK/dV kernel
  static constexpr int kKK = 0;
  static constexpr int kKV = kT128;
  static constexpr int kKQ = 2 * kT128;                 // + stage * kT64
  static constexpr int kKDO = kKQ + kWgStages * kT64;   // + stage * kT64
  static constexpr int kKRows = kKDO + kWgStages * kT64;  // + stage * 512
  static constexpr int kKBar = kKRows + kWgStages * 512;
  static constexpr int kKBytes = kKBar + 8 * (1 + 2 * kWgStages) + 1024;
  // dQ kernel
  static constexpr int kQQ = 0;                          // + consumer * kT64
  static constexpr int kQDO = 2 * kT64;
  static constexpr int kQK = 4 * kT64;                   // + stage * kT64
  static constexpr int kQV = kQK + kWgStages * kT64;
  static constexpr int kQBar = kQV + kWgStages * kT64;
  static constexpr int kQBytes = kQBar + 8 * (1 + 2 * kWgStages) + 1024;
  static_assert(D == 64 || D == 80 || D == 128, "wgmma widths 64, 80, 128");
  static_assert(kKBytes <= 232448 && kQBytes <= 232448,
                "backward tiles exceed shared memory");
};

// d (+)= A B over the D output columns, A (4 registers of bf16 pairs) from
// registers, B MN-major in shared memory (64-column blocks `lead` apart):
// n64, n80 (the true width of head dim 80) or n128
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  if constexpr (D == 128) {
    wgmma_m64n128_rs(d, a0, a1, a2, a3, b);
  } else if constexpr (D == 80) {
    wgmma_m64n80_rs(d, a0, a1, a2, a3, b);
  } else {
    wgmma_m64n64_rs(d, a0, a1, a2, a3, b);
  }
}

// s (+)= A B^T over D columns: a 64 x 64 product, A and B K-major 64-row
// tiles whose 64-column blocks are a_blk and b_blk bytes apart
template <int D>
__device__ __forceinline__ void wgmma_rows(float (&s)[32], uint32_t a,
                                           uint32_t a_blk, uint32_t b,
                                           uint32_t b_blk) {
#pragma unroll
  for (int kk = 0; kk < WgBwd<D>::kKSteps; ++kk) {
    const uint32_t off = (kk % 4) * 32;   // 16 columns within the 128 bytes
    wgmma_m64n64_ss(s, sw128_desc(a + (kk / 4) * a_blk + off, 16),
                    sw128_desc(b + (kk / 4) * b_blk + off, 16), kk > 0);
  }
}

// This thread's A fragments of m64k16 products over D columns, read once
// from a K-major tile that TMA wrote (128-byte swizzled rows, 64-column
// blocks `blk` bytes apart): rows row0 + r0 and row0 + r0 + 8, columns
// 16 kk + c0 (+ 1) and 16 kk + 8 + c0 (+ 1) of k-step kk -- the layout
// wgmma takes A in from registers.  row0 is a multiple of 8.
template <int D>
__device__ __forceinline__ void load_a_frags(
    uint32_t (&a)[WgBwd<D>::kKSteps][4], const uint8_t* tile, int blk,
    int row0, int r0, int c0) {
#pragma unroll
  for (int kk = 0; kk < WgBwd<D>::kKSteps; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + r0 + 8 * (i % 2);
      const int chunk = 2 * (kk % 4) + i / 2;   // 16-byte chunk of the row
      a[kk][i] = *reinterpret_cast<const uint32_t*>(
          tile + (kk / 4) * blk + row * 128 + ((chunk ^ (row % 8)) * 16) +
          c0 * 2);
    }
  }
}

// Keep A fragments in their registers up to here (fence_regs for a stack
// of fragments).  wgmma reads its A registers while in flight, but the
// compiler sees them last used at the issue and could give them to
// another value before the wait, so every A operand (these, P^T, dS^T,
// dS) is fenced after the wait of the products that read it.
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) fence_regs(a[kk]);
}

// s = A B^T over D columns: a 64 x 64 product, A from registers
// (load_a_frags), B a K-major 64-row tile whose blocks are b_blk apart
template <int D>
__device__ __forceinline__ void wgmma_rows_rs(
    float (&s)[32], const uint32_t (&a)[WgBwd<D>::kKSteps][4], uint32_t b,
    uint32_t b_blk) {
#pragma unroll
  for (int kk = 0; kk < WgBwd<D>::kKSteps; ++kk) {
    wgmma_m64n64_rs_kb(s, a[kk][0], a[kk][1], a[kk][2], a[kk][3],
                       sw128_desc(b + (kk / 4) * b_blk + (kk % 4) * 32, 16),
                       kk > 0);
  }
}

// (b') dK and dV of 128 keys: consumer warpgroup c owns keys k0 + 64 c ..
// + 63 and, per q tile of 64 queries, computes S^T = K Q^T and dP^T =
// V dO^T (keys are the rows of the fragments), P^T and dS^T in registers,
// then dV += P^T dO and dK += dS^T Q with P^T and dS^T as bf16 A fragments
// and dO, Q read MN-major.  The producer streams Q, dO, lse and delta of
// the q tiles of the group's heads inside the band.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap domap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const float* __restrict__ rows,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int seq_q,
                            int seq_qp, int seq_k, int heads, int kv_heads,
                            int window, float scale) {
  using L = WgBwd<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle's alignment
  const uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::kKBar;
  const uint32_t bar_full = bar_kv + 8;               // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kWgStages;

  const int k0 = blockIdx.x * 128;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = heads / kv_heads;
  // the q tiles whose rows see a key of [k0, k_end): from the diagonal
  // when causal, below k_end - 1 + window with a window
  const int k_end = min(k0 + 128, seq_k);
  const int q_lo = CAUSAL ? k0 : 0;
  const int q_hi = window > 0 ? min(seq_q, k_end - 1 + window) : seq_q;
  const int qt_lo = q_lo / 64;
  const int n_qt = q_lo < q_hi ? (q_hi + 63) / 64 - qt_lo : 0;
  const int n_visit = group * n_qt;   // (query head, q tile), head-major

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 8);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_kv, 2 * L::kT128);
      for (int cb = 0; cb < L::kCB; ++cb) {
        tma_load_4d(base + L::kKK + cb * 2 * L::kBlk, &kmap, bar_kv, 64 * cb,
                    hk, k0, b);
        tma_load_4d(base + L::kKV + cb * 2 * L::kBlk, &vmap, bar_kv, 64 * cb,
                    hk, k0, b);
      }
      for (int i = 0; i < n_visit; ++i) {
        const int h = hk * group + i / n_qt;
        const int q0 = (qt_lo + i % n_qt) * 64;
        const int st = i % kWgStages;
        if (i >= kWgStages) {   // the stage's previous tile is released
          mbar_wait(bar_empty + 8 * st, ((i / kWgStages) & 1) ^ 1);
        }
        const uint32_t full = bar_full + 8 * st;
        // whole boxes count, zero fill included; 256 bytes of lse, of delta
        mbar_expect_tx(full, 2 * L::kT64 + 512);
        for (int cb = 0; cb < L::kCB; ++cb) {
          tma_load_4d(base + L::kKQ + st * L::kT64 + cb * L::kBlk, &qmap,
                      full, 64 * cb, h, q0, b);
          tma_load_4d(base + L::kKDO + st * L::kT64 + cb * L::kBlk, &domap,
                      full, 64 * cb, h, q0, b);
        }
        const float* r = rows + ((long long)b * heads + h) * 2 * seq_qp + q0;
        bulk_load(base + L::kKRows + st * 512, r, 256, full);
        bulk_load(base + L::kKRows + st * 512 + 256, r + seq_qp, 256,
                         full);
      }
    }
  } else {
    // ---- consumers: 64 keys each
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    // fragment: keys r0 and r0 + 8 of the 64, and in every 8-column chunk
    // j the queries 8 j + c0 and 8 j + c0 + 1; element 4 j + 2 half + e is
    // (key r0 + 8 half, query 8 j + c0 + e), and bf16 pair t = 2 j + half
    const int r0 = 16 * (tid / 32) + lane / 4;
    const int c0 = 2 * (lane % 4);
    const int k_lo = k0 + 64 * c;
    const uint32_t k_s = base + L::kKK + c * 64 * 128;
    const uint32_t v_s = base + L::kKV + c * 64 * 128;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) {
      dk_acc[e] = 0.0f;
      dv_acc[e] = 0.0f;
    }

    mbar_wait(bar_kv, 0);
    uint32_t ka[L::kKSteps][4], va[L::kKSteps][4];
    if constexpr (L::kKvInRegs) {
      load_a_frags<D>(ka, smem + L::kKK, 2 * L::kBlk, 64 * c, r0, c0);
      load_a_frags<D>(va, smem + L::kKV, 2 * L::kBlk, 64 * c, r0, c0);
    }
    for (int i = 0; i < n_visit; ++i) {
      const int st = i % kWgStages;
      const int q0 = (qt_lo + i % n_qt) * 64;
      const uint32_t q_s = base + L::kKQ + st * L::kT64;
      const uint32_t do_s = base + L::kKDO + st * L::kT64;
      mbar_wait(bar_full + 8 * st, (i / kWgStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T, committed as two groups: P^T is
      // computed while dP^T is still on the tensor cores
      float sc[32], dp[32];
      wgmma_fence();
      if constexpr (L::kKvInRegs) {
        wgmma_rows_rs<D>(sc, ka, q_s, L::kBlk);
        wgmma_commit();
        wgmma_rows_rs<D>(dp, va, do_s, L::kBlk);
      } else {
        wgmma_rows<D>(sc, k_s, 2 * L::kBlk, q_s, L::kBlk);
        wgmma_commit();
        wgmma_rows<D>(dp, v_s, 2 * L::kBlk, do_s, L::kBlk);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // P^T = exp(scale S^T - lse) (the plain version's fp32 steps: the
      // product rounded, then the difference, expf), in place of S^T,
      // masked per element only in tiles that cross the end of the queries
      // or keys, the diagonal, or the band's lower edge; each thread's 16
      // queries' lse and delta are 8 float2 pairs of the stage
      const float* lse_s =
          reinterpret_cast<const float*>(smem + L::kKRows + st * 512);
      const bool edge = q0 + 64 > seq_q || k_lo + 64 > seq_k ||
                        (CAUSAL && k_lo + 63 > q0) ||
                        (window > 0 && q0 + 63 - k_lo >= window);
      uint32_t pp[16], dsp[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + c0;
        const float2 lse = *reinterpret_cast<const float2*>(lse_s + col);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = 2 * j + half;
          float p0 = expf(__fmul_rn(sc[2 * t], scale) - lse.x);
          float p1 = expf(__fmul_rn(sc[2 * t + 1], scale) - lse.y);
          if (edge) {
            const int key = k_lo + r0 + 8 * half;
            if (!kept(CAUSAL, window, q0 + col, key, seq_q, seq_k)) p0 = 0.0f;
            if (!kept(CAUSAL, window, q0 + col + 1, key, seq_q, seq_k)) {
              p1 = 0.0f;
            }
          }
          sc[2 * t] = p0;
          sc[2 * t + 1] = p1;
          pp[t] = pack_bf16(p0, p1);
        }
      }
      fence_regs(pp);

      // dV += P^T dO over 4 steps of 16 queries, while dS^T = P^T (dP^T -
      // delta) is computed
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<D>(dv_acc, pp[4 * kk], pp[4 * kk + 1], pp[4 * kk + 2],
                    pp[4 * kk + 3],
                    sw128_desc(do_s + kk * 16 * 128, L::kBlk));
      }
      wgmma_commit();
      wgmma_wait<1>();   // dP^T has landed; dV may still be in flight
      fence_regs(dp);
      if constexpr (L::kKvInRegs) {
        fence_frags(ka);
        fence_frags(va);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(
            lse_s + 64 + 8 * j + c0);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = 2 * j + half;
          dsp[t] = pack_bf16(sc[2 * t] * (dp[2 * t] - dl.x),
                             sc[2 * t + 1] * (dp[2 * t + 1] - dl.y));
        }
      }
      fence_regs(dsp);

      // dK += dS^T Q over 4 steps of 16 queries
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<D>(dk_acc, dsp[4 * kk], dsp[4 * kk + 1], dsp[4 * kk + 2],
                    dsp[4 * kk + 3],
                    sw128_desc(q_s + kk * 16 * 128, L::kBlk));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pp);
      fence_regs(dsp);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }

    // dK scaled once; both rounded to bf16 once, stored from the fragments
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = k_lo + r0 + 8 * half;
      if (t >= seq_k) continue;
      const long long row = ((long long)b * seq_k + t) * kv_heads + hk;
      __nv_bfloat16* dkr = dk + row * D;
      __nv_bfloat16* dvr = dv + row * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int e = 4 * j + 2 * half;
        *reinterpret_cast<uint32_t*>(dkr + 8 * j + c0) =
            pack_bf16(dk_acc[e] * scale, dk_acc[e + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvr + 8 * j + c0) =
            pack_bf16(dv_acc[e], dv_acc[e + 1]);
      }
    }
  }
}

// (c') dQ of 128 queries: consumer warpgroup c owns queries q0 + 64 c ..
// + 63 and, per KV tile of 64 keys inside the band, computes S = Q K^T and
// dP = dO V^T, dS = P (dP - delta) in registers, then dQ += dS K with dS as
// the bf16 A fragment and K read MN-major.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap domap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const float* __restrict__ rows,
                          __nv_bfloat16* __restrict__ dq, int seq_q,
                          int seq_qp, int seq_k, int heads, int kv_heads,
                          int window, float scale) {
  using L = WgBwd<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kQBar;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kWgStages;

  const int n_qt = (seq_q + 127) / 128;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * 128;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  int n_kt = (seq_k + 63) / 64;
  if (CAUSAL) {   // the KV tiles wholly above the diagonal are skipped
    n_kt = min(n_kt, (min(q0 + 128, seq_q) - 1) / 64 + 1);
  }
  // and those wholly below the band of the block's first row
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / 64 : 0;
  const int n_visit = n_kt - kt_lo;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, 4 * L::kT64);
      for (int c = 0; c < 2; ++c) {
        for (int cb = 0; cb < L::kCB; ++cb) {
          tma_load_4d(base + L::kQQ + c * L::kT64 + cb * L::kBlk, &qmap,
                      bar_q, 64 * cb, h, q0 + 64 * c, b);
          tma_load_4d(base + L::kQDO + c * L::kT64 + cb * L::kBlk, &domap,
                      bar_q, 64 * cb, h, q0 + 64 * c, b);
        }
      }
      for (int i = 0; i < n_visit; ++i) {
        const int kt = kt_lo + i;
        const int st = i % kWgStages;
        if (i >= kWgStages) {
          mbar_wait(bar_empty + 8 * st, ((i / kWgStages) & 1) ^ 1);
        }
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * L::kT64);
        for (int cb = 0; cb < L::kCB; ++cb) {
          tma_load_4d(base + L::kQK + st * L::kT64 + cb * L::kBlk, &kmap,
                      full, 64 * cb, hk, kt * 64, b);
          tma_load_4d(base + L::kQV + st * L::kT64 + cb * L::kBlk, &vmap,
                      full, 64 * cb, hk, kt * 64, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    // fragment: queries r0 and r0 + 8 of the 64, keys 8 j + c0 (+ 1)
    const int r0 = 16 * (tid / 32) + lane / 4;
    const int c0 = 2 * (lane % 4);
    const int q_lo = q0 + 64 * c;
    // this thread's two rows' lse (* log2 e) and delta (seq_qp pads past
    // the block)
    const float* lr = rows + ((long long)b * heads + h) * 2 * seq_qp + q_lo;
    const float lse_r[2] = {lr[r0], lr[r0 + 8]};
    const float dl_r[2] = {lr[seq_qp + r0], lr[seq_qp + r0 + 8]};

    float dq_acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dq_acc[e] = 0.0f;

    mbar_wait(bar_q, 0);
    const uint32_t q_s = base + L::kQQ + c * L::kT64;
    const uint32_t do_s = base + L::kQDO + c * L::kT64;
    uint32_t qa[L::kKSteps][4], doa[L::kKSteps][4];
    if constexpr (L::kQdoInRegs) {
      load_a_frags<D>(qa, smem + L::kQQ + c * L::kT64, L::kBlk, 0, r0, c0);
      load_a_frags<D>(doa, smem + L::kQDO + c * L::kT64, L::kBlk, 0, r0, c0);
    }
    for (int i = 0; i < n_visit; ++i) {
      const int st = i % kWgStages;
      const int k0 = (kt_lo + i) * 64;
      const uint32_t k_s = base + L::kQK + st * L::kT64;
      const uint32_t v_s = base + L::kQV + st * L::kT64;
      mbar_wait(bar_full + 8 * st, (i / kWgStages) & 1);

      // S = Q K^T and dP = dO V^T as two groups: P is computed while dP
      // is still on the tensor cores
      float sc[32], dp[32];
      wgmma_fence();
      if constexpr (L::kQdoInRegs) {
        wgmma_rows_rs<D>(sc, qa, k_s, L::kBlk);
        wgmma_commit();
        wgmma_rows_rs<D>(dp, doa, v_s, L::kBlk);
      } else {
        wgmma_rows<D>(sc, q_s, L::kBlk, k_s, L::kBlk);
        wgmma_commit();
        wgmma_rows<D>(dp, do_s, L::kBlk, v_s, L::kBlk);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      const bool edge = k0 + 64 > seq_k || (CAUSAL && k0 + 63 > q_lo) ||
                        (window > 0 && k0 + window <= q_lo + 63);
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int half = t % 2;
        const int q_pos = q_lo + r0 + 8 * half;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k_pos = k0 + 8 * (t / 2) + c0 + e;
          float p = expf(__fmul_rn(sc[2 * t + e], scale) - lse_r[half]);
          if (edge && !kept(CAUSAL, window, q_pos, k_pos, seq_q, seq_k)) {
            p = 0.0f;
          }
          sc[2 * t + e] = p;
        }
      }
      wgmma_wait_all();
      fence_regs(dp);
      if constexpr (L::kQdoInRegs) {
        fence_frags(qa);
        fence_frags(doa);
      }
      uint32_t dsp[16];
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const float dl = dl_r[t % 2];
        dsp[t] = pack_bf16(sc[2 * t] * (dp[2 * t] - dl),
                           sc[2 * t + 1] * (dp[2 * t + 1] - dl));
      }
      fence_regs(dsp);

      // dQ += dS K over 4 steps of 16 keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<D>(dq_acc, dsp[4 * kk], dsp[4 * kk + 1], dsp[4 * kk + 2],
                    dsp[4 * kk + 3],
                    sw128_desc(k_s + kk * 16 * 128, L::kBlk));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq_acc);
      fence_regs(dsp);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = q_lo + r0 + 8 * half;
      if (s >= seq_q) continue;
      __nv_bfloat16* dqr = dq + (((long long)b * seq_q + s) * heads + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int e = 4 * j + 2 * half;
        *reinterpret_cast<uint32_t*>(dqr + 8 * j + c0) =
            pack_bf16(dq_acc[e] * scale, dq_acc[e + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* rows;
  void* dq;
  void* dk;
  void* dv;
  int batch;
  int seq_q;
  int seq_qp;
  int seq_k;
  int heads;
  int kv_heads;
  int dv_width;
  int window;
  float scale;
};

int seq_q_padded(int seq_q) {
  return (seq_q + kRowsPad - 1) / kRowsPad * kRowsPad;
}

// (a): the rows scratch, for either variant
template <typename T> int launch_rows(const BwdArgs& a, cudaStream_t s) {
  const long long n_rows = (long long)a.batch * a.seq_qp * a.heads;
  const long long blocks = (n_rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  flash_bwd_rows_kernel<T><<<(unsigned int)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse,
      a.rows, n_rows, a.seq_q, a.seq_qp, a.heads, a.dv_width);
  return (int)cudaGetLastError();
}

template <typename T, int DQK, int DV, bool CAUSAL>
int launch_simt(const BwdArgs& a, cudaStream_t s) {
  using L = BwdTiles<DQK, DV>;
  int err = launch_rows<T>(a, s);
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_kernel<T, DQK, DV, CAUSAL>;
  cudaError_t e = set_smem(dkdv, L::kDkdvBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_kv((unsigned int)a.kv_heads, (unsigned int)a.batch,
                     (unsigned int)((a.seq_k + kBK - 1) / kBK));
  dkdv<<<grid_kv, kThreads, L::kDkdvBytes, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.rows,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.seq_q, a.seq_qp,
      a.seq_k, a.heads, a.kv_heads, a.window, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto dqk = flash_bwd_dq_kernel<T, DQK, DV, CAUSAL>;
  e = set_smem(dqk, L::kDqBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_q((unsigned int)a.heads, (unsigned int)a.batch,
                    (unsigned int)((a.seq_q + L::kBQ - 1) / L::kBQ));
  dqk<<<grid_q, kThreads, L::kDqBytes, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.rows,
      static_cast<T*>(a.dq), a.seq_q, a.seq_qp, a.seq_k, a.heads,
      a.kv_heads, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int simt_by_type(int dtype, bool causal, const BwdArgs& a, cudaStream_t s) {
  if (dtype == 0) {
    return causal ? launch_simt<float, DQK, DV, true>(a, s)
                  : launch_simt<float, DQK, DV, false>(a, s);
  }
  return causal ? launch_simt<__nv_bfloat16, DQK, DV, true>(a, s)
                : launch_simt<__nv_bfloat16, DQK, DV, false>(a, s);
}

template <int D, bool CAUSAL>
int launch_wgmma(const BwdArgs& a, cudaStream_t s) {
  using L = WgBwd<D>;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  // Q and dO in 64-row boxes; K and V in 128-row boxes for the dK/dV
  // kernel, 64-row boxes for the dQ kernel
  CUtensorMap qm, dom, km128, vm128, km64, vm64;
  if (!encode_bshd(&qm, a.q, a.batch, a.seq_q, a.heads, D, 64) ||
      !encode_bshd(&dom, a.dout, a.batch, a.seq_q, a.heads, D, 64) ||
      !encode_bshd(&km128, a.k, a.batch, a.seq_k, a.kv_heads, D, 128) ||
      !encode_bshd(&vm128, a.v, a.batch, a.seq_k, a.kv_heads, D, 128) ||
      !encode_bshd(&km64, a.k, a.batch, a.seq_k, a.kv_heads, D, 64) ||
      !encode_bshd(&vm64, a.v, a.batch, a.seq_k, a.kv_heads, D, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  int err = launch_rows<__nv_bfloat16>(a, s);
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_wgmma_kernel<D, CAUSAL>;
  cudaError_t e = set_smem(dkdv, L::kKBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_kv((unsigned int)((a.seq_k + 127) / 128),
                     (unsigned int)a.kv_heads, (unsigned int)a.batch);
  dkdv<<<grid_kv, kWgThreads, L::kKBytes, s>>>(
      qm, dom, km128, vm128, a.rows, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.seq_q, a.seq_qp, a.seq_k, a.heads,
      a.kv_heads, a.window, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto dqk = flash_bwd_dq_wgmma_kernel<D, CAUSAL>;
  e = set_smem(dqk, L::kQBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_q((unsigned int)((a.seq_q + 127) / 128),
                    (unsigned int)a.heads, (unsigned int)a.batch);
  dqk<<<grid_q, kWgThreads, L::kQBytes, s>>>(
      qm, dom, km64, vm64, a.rows, static_cast<__nv_bfloat16*>(a.dq),
      a.seq_q, a.seq_qp, a.seq_k, a.heads, a.kv_heads, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int wgmma_by_mask(bool causal, const BwdArgs& a, cudaStream_t s) {
  return causal ? launch_wgmma<D, true>(a, s) : launch_wgmma<D, false>(a, s);
}

}  // namespace

// The fp32 rows of the scratch ember_flash_attention_bwd takes: seq_q
// rounded up to 128.  The scratch is (batch, heads, 2, rows).
extern "C" int ember_flash_bwd_rows(int seq_q) { return seq_q_padded(seq_q); }

// The gradients of ember_flash_attention: q, k, v, o (its output), dout (the
// cotangent of o) in the forward's layouts and dtype (0 = float32, 1 =
// bfloat16), lse its fp32 (batch, heads, seq_q) log-sum-exp; rows an fp32
// (batch, heads, 2, ember_flash_bwd_rows(seq_q)) scratch; dq, dk, dv outputs
// shaped as q, k and v, fully written.  (head_dim, v_head_dim), causal, window
// and scale as the forward takes them, but for (112, 112), which has no
// backward yet (ROADMAP.md, K1) and is refused.  variant 1 runs the wgmma
// kernels: bf16 at (64, 64), (80, 80) or (128, 128), q, k, v and dout 16-byte
// aligned (TMA reads them); variant 0 the SIMT kernels, at every other width
// pair and dtype.  The caller picks the variant (kernels/flash_attention.py
// backward_variant); a variant that cannot take the arguments returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int ember_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* rows, void* dq, void* dk,
    void* dv, int batch, int seq_q, int seq_k, int heads, int kv_heads,
    int head_dim, int v_head_dim, int dtype, int causal, int window,
    double scale, int variant, void* stream) {
  const bool dims_ok = (head_dim == v_head_dim &&
                        (head_dim == 64 || head_dim == 80 ||
                         head_dim == 128 || head_dim == 256)) ||
                       (head_dim == 192 && v_head_dim == 128);
  if (batch <= 0 || batch > 65535 || seq_q <= 0 || seq_k <= 0 ||
      heads <= 0 || heads > 65535 || kv_heads <= 0 ||
      heads % kv_heads != 0 || !dims_ok || (dtype != 0 && dtype != 1) ||
      window < 0 || (window > 0 && seq_q - window >= seq_k) ||
      seq_q > 2147483647 - kRowsPad || (variant != 0 && variant != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse),
                  static_cast<float*>(rows), dq, dk, dv, batch, seq_q,
                  seq_q_padded(seq_q), seq_k, heads, kv_heads, v_head_dim,
                  window, (float)scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  if (variant == 1) {
    if (dtype != 1 || head_dim != v_head_dim || head_dim > 128 ||
        ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) %
                16 != 0) {
      return (int)cudaErrorInvalidValue;
    }
    if (head_dim == 64) return wgmma_by_mask<64>(c, a, s);
    if (head_dim == 80) return wgmma_by_mask<80>(c, a, s);
    return wgmma_by_mask<128>(c, a, s);
  }
  if ((seq_q + 31) / 32 > 65535 || (seq_k + kBK - 1) / kBK > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (head_dim == 64) return simt_by_type<64, 64>(dtype, c, a, s);
  if (head_dim == 80) return simt_by_type<80, 80>(dtype, c, a, s);
  if (head_dim == 128) return simt_by_type<128, 128>(dtype, c, a, s);
  if (head_dim == 192) return simt_by_type<192, 128>(dtype, c, a, s);
  return simt_by_type<256, 256>(dtype, c, a, s);
}
