// Flash (online-softmax) attention on Hopper (sm_90a).
//
// ember_flash_attention replaces the TPU kernel flash_attention /
// _flash_kernel (src/repro/kernels/flash_attention.py).  It computes the
// function of the reference's blockwise_attention
// (src/repro/models/attention.py), which LM.forward runs in every attention
// layer of a prefill:
//
//   o[b, s, h, :] = softmax_t(scale * <q[b, s, h], k[b, t, h / G]>) v[b, t, h / G]
//   (t <= s when causal; G = H / Hkv heads share one KV head; scale = D^-1/2)
//
// in the JAX package's layout: q, o (B, Sq, H, D) and k, v (B, Sk, Hkv, D),
// contiguous, f32 or bf16, D in {64, 128}.  The running max m, the
// denominator l and the accumulator are fp32; masked scores are -1e30; the
// probabilities are rounded to the input dtype before the PV product (as
// the reference's p.astype(v.dtype)); the denominator is clamped at 1e-30.
//
// What bounds it: operations.  Causal attention over S tokens does
// 2 * S^2 * D multiply-adds per head against 4 * S * D elements moved, far
// above the card's balance at these lengths.
//
// What the design does about it (a first, simple kernel: scalar fp32 FMAs
// from shared memory; wgmma and TMA are later work):
//   * One block of 256 threads per (q tile of kBQ rows, head, batch).  It
//     streams kBK-row K/V tiles through shared memory (held as fp32) and
//     keeps m, l and a (kBQ, D) accumulator in registers: thread (ty, tx)
//     owns rows ty + 16 i and, of the scores, columns tx + 16 j; of the
//     accumulator, columns 64 g + 4 tx + e.  Both products read 16-byte
//     vectors from shared memory, which is padded so the K reads are free of
//     bank conflicts.
//   * The row max and row sum of a score tile are reduced across the 16
//     threads of a row with shuffles.
//   * Causal: the KV tiles wholly above the diagonal are skipped (the TPU
//     kernel's `needed`), and the q tiles with the most KV tiles are
//     scheduled first.
//   * GQA: head h reads KV head h / G directly; no repeated copy of K, V.
//   * A ragged last q or KV tile is masked in the kernel (the TPU kernel
//     asserts S % block == 0).
//
// Plain C interface (loaded with ctypes): launches on the stream it is
// given, allocates nothing, returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).

#include "ember_common.cuh"

namespace {

using ember::from_float;
using ember::to_float;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

// Shared-memory layout in floats: Q (kBQ, D), K (kBK, D + 4), V (kBK, D),
// P (kBQ, kBK).  D = 128 takes 115,712 bytes, so two blocks fit one SM.
template <int D> struct FlashSmem {
  static constexpr int kQStride = D;
  static constexpr int kKStride = D + 4;
  static constexpr int kVStride = D;
  static constexpr int kPStride = kBK;
  static constexpr int kFloats = kBQ * kQStride + kBK * kKStride +
                                 kBK * kVStride + kBQ * kPStride;
  static constexpr int kBytes = kFloats * (int)sizeof(float);
};

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

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

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int seq_q,
             int seq_k, int heads, int kv_heads, float scale) {
  using S = FlashSmem<D>;
  constexpr int kG = D / 64;            // 64-column groups of the output
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * S::kQStride;
  float* vs = ks + kBK * S::kKStride;
  float* ps = vs + kBK * S::kVStride;

  const int n_qt = (seq_q + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const long long q_stride = (long long)heads * D;     // one token of q / o
  const long long kv_stride = (long long)kv_heads * D;
  const T* __restrict__ qb = q + ((long long)b * seq_q * heads + h) * D;
  const T* __restrict__ kb = k + ((long long)b * seq_k * kv_heads + hk) * D;
  const T* __restrict__ vb = v + ((long long)b * seq_k * kv_heads + hk) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int s = q0 + r;
    qs[r * S::kQStride + c] = s < seq_q ? to_float(qb[s * q_stride + c])
                                        : 0.0f;
  }

  float m[4], l[4], acc[4][4 * kG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kG; ++c) acc[i][c] = 0.0f;
  }

  int n_kt = (seq_k + kBK - 1) / kBK;
  if (CAUSAL) {   // skip the KV tiles wholly above the diagonal
    const int last_q = min(q0 + kBQ, seq_q) - 1;
    n_kt = min(n_kt, last_q / kBK + 1);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D;
      const int c = e % D;
      const int s = k0 + r;
      float kv_k = 0.0f;
      float kv_v = 0.0f;
      if (s < seq_k) {
        kv_k = to_float(kb[s * kv_stride + c]);
        kv_v = to_float(vb[s * kv_stride + c]);
      }
      ks[r * S::kKStride + c] = kv_k;
      vs[r * S::kVStride + c] = kv_v;
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
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = f4(qs + (ty + 16 * i) * S::kQStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = f4(ks + (tx + 16 * j) * S::kKStride + d);
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

    // online softmax over this tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const bool keep = k_pos < seq_k && (!CAUSAL || k_pos <= q_pos);
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
        ps[(ty + 16 * i) * S::kPStride + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kG; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V: rows ty + 16 i, columns 64 g + 4 tx + e
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
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
    T* __restrict__ orow = o + ((long long)b * seq_q + q_pos) * q_stride +
                           (long long)h * D;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        orow[64 * g + 4 * tx + e] = from_float<T>(acc[i][4 * g + e] / denom);
      }
    }
  }
}

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
  float scale;
};

template <typename T, int D, bool CAUSAL>
int launch_flash(const FlashArgs& a, cudaStream_t s) {
  constexpr int kBytes = FlashSmem<D>::kBytes;
  auto kernel = flash_kernel<T, D, CAUSAL>;
  // above 48 KB of shared memory only as dynamic shared memory, after this
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((a.seq_q + kBQ - 1) / kBQ),
                  (unsigned int)a.heads, (unsigned int)a.batch);
  kernel<<<grid, kThreads, kBytes, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.seq_q, a.seq_k,
      a.heads, a.kv_heads, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int flash_by_causal(bool causal, const FlashArgs& a, cudaStream_t s) {
  return causal ? launch_flash<T, D, true>(a, s)
                : launch_flash<T, D, false>(a, s);
}

template <typename T>
int flash_by_dim(int head_dim, bool causal, const FlashArgs& a,
                 cudaStream_t s) {
  return head_dim == 64 ? flash_by_causal<T, 64>(causal, a, s)
                        : flash_by_causal<T, 128>(causal, a, s);
}

}  // namespace

// q, o: (batch, seq_q, heads, head_dim); k, v: (batch, seq_k, kv_heads,
// head_dim); all contiguous, one dtype (0 = float32, 1 = bfloat16).
// head_dim 64 or 128; heads a multiple of kv_heads.  scale multiplies the
// fp32 scores (the reference's head_dim ** -0.5).
extern "C" int ember_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int batch,
                                     int seq_q, int seq_k, int heads,
                                     int kv_heads, int head_dim, int dtype,
                                     int causal, double scale, void* stream) {
  if (batch <= 0 || batch > 65535 || seq_q <= 0 || seq_k <= 0 ||
      heads <= 0 || heads > 65535 || kv_heads <= 0 ||
      heads % kv_heads != 0 || (head_dim != 64 && head_dim != 128) ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const FlashArgs a{q, k, v, o, batch, seq_q, seq_k, heads, kv_heads,
                    (float)scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return flash_by_dim<float>(head_dim, causal != 0, a, s);
  }
  return flash_by_dim<__nv_bfloat16>(head_dim, causal != 0, a, s);
}
