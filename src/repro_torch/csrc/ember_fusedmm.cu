// FusedMM (SDDMM fused with SpMM) for GNN message passing on Hopper
// (sm_90a).
//
// ember_fusedmm replaces the TPU kernel fusedmm_pallas / _fusedmm_kernel
// (src/repro/kernels/fusedmm.py): the `fusedmm` kind of a compiled program.
//
//   out[i, :] = sum_{p in [ptrs[i], ptrs[i+1])} f(<x[i], x[j_p]>) * x[j_p],
//   j_p = idxs[p], f in {identity, relu}; an empty segment gives 0.
//
// What bounds it: bytes.  Per neighbour row of E elements it does 4E
// floating-point operations (the dot and the axpy) on 4E or 2E bytes read,
// about one operation per byte, far below the card's balance.  The floor is
// x, idxs and ptrs read once and out written once; each neighbour row that
// misses L2 is read again from HBM, so the rate it reaches is set by how
// many independent row reads it keeps in flight.
//
// What the design does about it:
//   * The TPU kernel walks a (segment, max_lookups) grid and accumulates in
//     the output block across grid steps.  Here one group of threads (at
//     most a warp) owns one output row i and loops over its own lookups:
//     no padding to max_lookups, the padded idxs tail is never read, and
//     nothing is carried between blocks.
//   * x[i] is loaded once, into registers.  For each lookup the group loads
//     x[j] as 16-byte vectors, reduces the dot product across the group
//     with shuffles, applies f, and adds s * x[j] from the same registers:
//     the paper's single pass over the neighbour row (the workspace loop's
//     second memory pass disappears).
//   * The indices and rows of kFmmUnroll lookups are loaded before the
//     first of them is reduced, so several scattered row reads are in
//     flight per thread.
//   * f, the dtype (f32, bf16; fp32 accumulation, one cast at the store),
//     the vector path and the vectors per thread are template parameters.
//   * Row offsets are 64-bit.
//
// Plain C interface (loaded with ctypes): launches on the stream it is
// given, allocates nothing, returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).

#include "ember_common.cuh"

namespace {

using ember::kMaxBlockThreads;
using ember::RowAccess;
using ember::valid_block;

constexpr int kFnIdentity = 0;
constexpr int kFnRelu = 1;
constexpr int kFmmUnroll = 2;
constexpr int kMaxVecsPerThread = 8;

template <int FN> __device__ __forceinline__ float apply_fn(float s) {
  if constexpr (FN == kFnRelu) {
    return fmaxf(s, 0.0f);
  } else {
    return s;
  }
}

// Sum over the threads_per_row lanes of one group (aligned within the warp).
__device__ __forceinline__ float group_sum(float v, int threads_per_row,
                                           unsigned int mask) {
  for (int o = threads_per_row / 2; o > 0; o >>= 1) {
    v += __shfl_xor_sync(mask, v, o);
  }
  return v;
}

template <typename T, int FN, bool VEC, int NV>
__global__ void __launch_bounds__(kMaxBlockThreads)
fusedmm_kernel(const T* __restrict__ x, const int* __restrict__ ptrs,
               const int* __restrict__ idxs, T* __restrict__ out,
               long long num_segments, long long emb_len,
               int threads_per_row) {
  using Row = RowAccess<T, VEC>;
  constexpr int kW = Row::kElems;
  const int tpr = threads_per_row;
  const int rows_per_block = blockDim.x / tpr;
  const long long i =
      (long long)blockIdx.x * rows_per_block + threadIdx.x / tpr;
  if (i >= num_segments) return;  // whole groups leave together
  const int lane = threadIdx.x % tpr;
  const int warp_lane = threadIdx.x % 32;
  const unsigned int mask =
      tpr == 32 ? 0xffffffffu
                : (((1u << tpr) - 1u) << (warp_lane & ~(tpr - 1)));

  long long col[NV];
  bool ok[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    col[v] = ((long long)v * tpr + lane) * kW;
    ok[v] = col[v] < emb_len;
  }
  // x[i] once, in registers; lanes past the row hold 0 and add nothing
  float xi[NV][kW];
  float acc[NV][kW];
  const T* __restrict__ row_i = x + i * emb_len;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
#pragma unroll
    for (int e = 0; e < kW; ++e) {
      xi[v][e] = 0.0f;
      acc[v][e] = 0.0f;
    }
    if (ok[v]) Row::load(row_i + col[v], xi[v]);
  }

  const int beg = ptrs[i];
  const int end = ptrs[i + 1];
  int p = beg;
  for (; p + kFmmUnroll <= end; p += kFmmUnroll) {
    // access: the rows of kFmmUnroll lookups are loaded before any reduce
    float xj[kFmmUnroll][NV][kW];
#pragma unroll
    for (int u = 0; u < kFmmUnroll; ++u) {
      const T* __restrict__ row_j = x + (long long)idxs[p + u] * emb_len;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int e = 0; e < kW; ++e) xj[u][v][e] = 0.0f;
        if (ok[v]) Row::load(row_j + col[v], xj[u][v]);
      }
    }
    // execute, in lookup order: SDDMM dot, f, SpMM from the same registers
#pragma unroll
    for (int u = 0; u < kFmmUnroll; ++u) {
      float d = 0.0f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int e = 0; e < kW; ++e) d = fmaf(xi[v][e], xj[u][v][e], d);
      }
      const float s = apply_fn<FN>(group_sum(d, tpr, mask));
#pragma unroll
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int e = 0; e < kW; ++e) acc[v][e] = fmaf(s, xj[u][v][e], acc[v][e]);
      }
    }
  }
  for (; p < end; ++p) {
    float xj[NV][kW];
    const T* __restrict__ row_j = x + (long long)idxs[p] * emb_len;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int e = 0; e < kW; ++e) xj[v][e] = 0.0f;
      if (ok[v]) Row::load(row_j + col[v], xj[v]);
    }
    float d = 0.0f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int e = 0; e < kW; ++e) d = fmaf(xi[v][e], xj[v][e], d);
    }
    const float s = apply_fn<FN>(group_sum(d, tpr, mask));
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int e = 0; e < kW; ++e) acc[v][e] = fmaf(s, xj[v][e], acc[v][e]);
    }
  }
  T* __restrict__ out_i = out + i * emb_len;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (ok[v]) Row::store(out_i + col[v], acc[v]);
  }
}

struct FusedmmArgs {
  const void* x;
  const int* ptrs;
  const int* idxs;
  void* out;
  long long num_segments;
  long long emb_len;
  int threads_per_row;
};

template <typename T, int FN, bool VEC, int NV>
void launch_fusedmm(const FusedmmArgs& a, dim3 grid, dim3 block,
                    cudaStream_t s) {
  fusedmm_kernel<T, FN, VEC, NV><<<grid, block, 0, s>>>(
      static_cast<const T*>(a.x), a.ptrs, a.idxs, static_cast<T*>(a.out),
      a.num_segments, a.emb_len, a.threads_per_row);
}

template <typename T, int FN, bool VEC>
void fusedmm_by_nv(int nv, const FusedmmArgs& a, dim3 g, dim3 b,
                   cudaStream_t s) {
  if (nv <= 1) {
    launch_fusedmm<T, FN, VEC, 1>(a, g, b, s);
  } else if (nv <= 2) {
    launch_fusedmm<T, FN, VEC, 2>(a, g, b, s);
  } else if (nv <= 4) {
    launch_fusedmm<T, FN, VEC, 4>(a, g, b, s);
  } else {
    launch_fusedmm<T, FN, VEC, kMaxVecsPerThread>(a, g, b, s);
  }
}

template <typename T, int FN>
void fusedmm_by_vec(bool vec, int nv, const FusedmmArgs& a, dim3 g, dim3 b,
                    cudaStream_t s) {
  if (vec) {
    fusedmm_by_nv<T, FN, true>(nv, a, g, b, s);
  } else {
    fusedmm_by_nv<T, FN, false>(nv, a, g, b, s);
  }
}

template <typename T>
void fusedmm_by_fn(int fn, bool vec, int nv, const FusedmmArgs& a, dim3 g,
                   dim3 b, cudaStream_t s) {
  if (fn == kFnRelu) {
    fusedmm_by_vec<T, kFnRelu>(vec, nv, a, g, b, s);
  } else {
    fusedmm_by_vec<T, kFnIdentity>(vec, nv, a, g, b, s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  fn: 0 identity, 1 relu.  vec: 1 for
// 16-byte row access (the caller has checked the row width and the
// alignment of x and out).  One group of threads_per_row threads per output
// row holds the whole row: at most kMaxVecsPerThread accesses per thread.
extern "C" int ember_fusedmm(const void* x, const void* ptrs,
                             const void* idxs, void* out,
                             long long num_segments, long long emb_len,
                             int dtype, int fn, int vec, int threads_per_row,
                             int rows_per_block, void* stream) {
  if (num_segments <= 0 || emb_len <= 0 || (dtype != 0 && dtype != 1) ||
      (fn != kFnIdentity && fn != kFnRelu) ||
      !valid_block(threads_per_row, rows_per_block)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long elems = vec ? (dtype == 0 ? 4 : 8) : 1;
  if (emb_len % elems != 0) return (int)cudaErrorInvalidValue;
  const long long vecs = emb_len / elems;
  const long long nv = (vecs + threads_per_row - 1) / threads_per_row;
  if (nv > kMaxVecsPerThread) return (int)cudaErrorInvalidValue;
  const long long blocks =
      (num_segments + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const FusedmmArgs a{x,
                      static_cast<const int*>(ptrs),
                      static_cast<const int*>(idxs),
                      out,
                      num_segments,
                      emb_len,
                      threads_per_row};
  const dim3 grid((unsigned int)blocks);
  const dim3 block((unsigned int)(threads_per_row * rows_per_block));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fusedmm_by_fn<float>(fn, vec != 0, (int)nv, a, grid, block, s);
  } else {
    fusedmm_by_fn<__nv_bfloat16>(fn, vec != 0, (int)nv, a, grid, block, s);
  }
  return (int)cudaGetLastError();
}
