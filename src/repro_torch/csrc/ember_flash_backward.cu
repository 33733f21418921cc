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
// causal, s - t < window with a sliding window.  Every sum is fp32; the
// inputs are f32 or bf16 and are widened to fp32 in shared memory; each
// gradient is rounded to the input dtype once.
//
// Three kernels, launched in order on the caller's stream:
//   (a) flash_bwd_delta_kernel: delta, one warp per (token, head) row;
//   (b) flash_bwd_dkdv_kernel: one block per (KV head, batch, KV tile of
//       kBK keys).  It keeps the tile's K and V in shared memory and its dK
//       and dV in registers, and loops over the group's query heads and over
//       the q tiles that see the tile (under the causal diagonal, inside
//       the window band), so the GQA sum stays inside the block;
//   (c) flash_bwd_dq_kernel: one block per (head, batch, q tile), over the
//       KV tiles its rows see, Q, dO, lse and delta kept in shared memory.
// No atomics: each gradient element is summed by one thread in a fixed
// order, so two calls on the same inputs give the same bits (a restarted
// training step repeats its loss bit for bit).
//
// What bounds it: operations.  Each (query, key) pair the masks keep needs
// five products of its row widths -- S and dK, dQ at Dqk, dP and dV at Dv:
// 2 (3 Dqk + 2 Dv) FLOP, 10 D at D = Dqk = Dv -- against O(S (Dqk + Dv))
// elements moved.
// This first kernel is SIMT: scalar fp32 FMAs from shared memory, a 16 x 16
// thread grid where thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j of every tile (row strides padded by one float, so neither
// operand's reads conflict on a bank), and S and dP recomputed in both
// (b) and (c).  It is right first; wgmma with TMA is the follow-up
// (ROADMAP.md, Queue 2 K5).  Head dim 80 runs at its true width here.
//
// Plain C interface (loaded with ctypes): launches on the stream it is
// given, allocates nothing (delta is the caller's fp32 (B, H, Sq)
// scratch), returns the cudaError_t of the launches (cudaErrorInvalidValue
// for arguments the kernels do not take).

#include "ember_common.cuh"
#include "ember_hopper.cuh"

namespace {

using ember::from_float;
using ember::set_smem;
using ember::to_float;

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

// (a) delta[b, h, s] = sum_e do[b, s, h, e] o[b, s, h, e]: one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int seq_q,
                       int heads, int dv) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float acc = 0.0f;
  for (int c = lane; c < dv; c += 32) {
    acc = fmaf(to_float(o[row * dv + c]), to_float(dout[row * dv + c]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {   // row = (b * seq_q + s) * heads + h
    const long long h = row % heads;
    const long long s = (row / heads) % seq_q;
    const long long b = row / ((long long)heads * seq_q);
    delta[(b * heads + h) * seq_q + s] = acc;
  }
}

// (b) dK and dV of one KV tile
template <typename T, int DQK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int seq_q, int seq_k, int heads,
                      int kv_heads, int window, float scale) {
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
    const float* lb = lse + ((long long)b * heads + h) * seq_q;
    const float* db = delta + ((long long)b * heads + h) * seq_q;
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
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int seq_q, int seq_k, int heads, int kv_heads, int window,
                    float scale) {
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
    const long long row = ((long long)b * heads + h) * seq_q + s;
    lse_s[threadIdx.x] = s < seq_q ? lse[row] : 0.0f;
    dl_s[threadIdx.x] = s < seq_q ? delta[row] : 0.0f;
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

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int batch;
  int seq_q;
  int seq_k;
  int heads;
  int kv_heads;
  int dv_width;
  int window;
  float scale;
};

template <typename T, int DQK, int DV, bool CAUSAL>
int launch(const BwdArgs& a, cudaStream_t s) {
  using L = BwdTiles<DQK, DV>;
  const long long rows = (long long)a.batch * a.seq_q * a.heads;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  flash_bwd_delta_kernel<T><<<(unsigned int)delta_blocks, kThreads, 0, s>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta,
      rows, a.seq_q, a.heads, a.dv_width);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dkdv = flash_bwd_dkdv_kernel<T, DQK, DV, CAUSAL>;
  err = set_smem(dkdv, L::kDkdvBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((unsigned int)a.kv_heads, (unsigned int)a.batch,
                     (unsigned int)((a.seq_k + kBK - 1) / kBK));
  dkdv<<<grid_kv, kThreads, L::kDkdvBytes, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.seq_q,
      a.seq_k, a.heads, a.kv_heads, a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dqk = flash_bwd_dq_kernel<T, DQK, DV, CAUSAL>;
  err = set_smem(dqk, L::kDqBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((unsigned int)a.heads, (unsigned int)a.batch,
                    (unsigned int)((a.seq_q + L::kBQ - 1) / L::kBQ));
  dqk<<<grid_q, kThreads, L::kDqBytes, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.seq_q, a.seq_k, a.heads, a.kv_heads,
      a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_by_type(int dtype, bool causal, const BwdArgs& a, cudaStream_t s) {
  if (dtype == 0) {
    return causal ? launch<float, DQK, DV, true>(a, s)
                  : launch<float, DQK, DV, false>(a, s);
  }
  return causal ? launch<__nv_bfloat16, DQK, DV, true>(a, s)
                : launch<__nv_bfloat16, DQK, DV, false>(a, s);
}

}  // namespace

// The gradients of ember_flash_attention: q, k, v, o (its output), dout
// (the cotangent of o) in the forward's layouts and dtype (0 = float32,
// 1 = bfloat16), lse its fp32 (batch, heads, seq_q) log-sum-exp; delta an
// fp32 (batch, heads, seq_q) scratch; dq, dk, dv outputs shaped as q, k
// and v, fully written.  (head_dim, v_head_dim), causal, window and scale
// as the forward takes them.
extern "C" int ember_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int seq_q, int seq_k, int heads, int kv_heads,
    int head_dim, int v_head_dim, int dtype, int causal, int window,
    double scale, void* stream) {
  const bool dims_ok = (head_dim == v_head_dim &&
                        (head_dim == 64 || head_dim == 80 ||
                         head_dim == 128 || head_dim == 256)) ||
                       (head_dim == 192 && v_head_dim == 128);
  if (batch <= 0 || batch > 65535 || seq_q <= 0 || seq_k <= 0 ||
      heads <= 0 || heads > 65535 || kv_heads <= 0 ||
      heads % kv_heads != 0 || !dims_ok || (dtype != 0 && dtype != 1) ||
      window < 0 || (window > 0 && seq_q - window >= seq_k) ||
      (seq_q + 31) / 32 > 65535 || (seq_k + kBK - 1) / kBK > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse),
                  static_cast<float*>(delta), dq, dk, dv, batch, seq_q,
                  seq_k, heads, kv_heads, v_head_dim, window, (float)scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  if (head_dim == 64) return launch_by_type<64, 64>(dtype, c, a, s);
  if (head_dim == 80) return launch_by_type<80, 80>(dtype, c, a, s);
  if (head_dim == 128) return launch_by_type<128, 128>(dtype, c, a, s);
  if (head_dim == 192) return launch_by_type<192, 128>(dtype, c, a, s);
  return launch_by_type<256, 256>(dtype, c, a, s);
}
