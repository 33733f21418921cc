// FusedMM (SDDMM fused with SpMM) for GNN message passing on Hopper
// (sm_90a).
//
// The FusedMM kernels replace the TPU kernel fusedmm_pallas /
// _fusedmm_kernel (src/repro/kernels/fusedmm.py): the `fusedmm` kind of a
// compiled program.
//
//   out[i, :] = sum_{p in [ptrs[i], ptrs[i+1])} f(<x[i], x[j_p]>) * x[j_p],
//   j_p = idxs[p], f in {identity, relu}; an empty segment gives 0.
//
// What bounds it: bytes.  Per neighbour row of E elements it does 4E
// floating-point operations (the dot and the axpy) on 4E or 2E bytes read,
// about one operation per byte, far below the card's balance.  The floor is
// x, idxs and ptrs read once and out written once; each neighbour row that
// misses L2 is read again from HBM (on a graph without locality, nearly
// every one), so the rate it reaches is set by how many independent row
// reads it keeps in flight.
//
// The TPU kernel walks a (segment, max_lookups) grid and accumulates in the
// output block across grid steps.  Here one group of threads owns one output
// row i and loops over its own lookups: no padding to max_lookups, the
// padded idxs tail is never read, and nothing is carried between blocks.
// x[i] and the accumulator stay in registers; each neighbour row is read
// once for the dot, f and the axpy (the paper's single pass: the workspace
// loop's second memory pass disappears).  The dot and the sums are fp32 (bf16
// is widened and cast once at the store); rows are summed in lookup order.
// Row offsets are 64-bit.  Two variants, chosen by the caller from the row:
//
// ring (fusedmm_ring_kernel; rows of whole 16-byte units up to 4 KB,
// 16-byte aligned x and out):
//   * One warp per output row, persistent: warp w owns the contiguous
//     segments [n w / W, n (w + 1) / W), so its lookups are one contiguous
//     stretch of idxs and its ring runs on across segment boundaries (the
//     next segment's first rows load while this one finishes).
//   * Each warp has a ring of S stages of shared memory (S from the row
//     bytes: kRingBytesPerWarp, at most kRingMaxStages).  Lane 0 issues a
//     cp.async.bulk load of each neighbour row x[j] into a stage, on that
//     stage's mbarrier, S rows ahead of the consumer.
//   * idxs are read 32 at a time by one coalesced warp load, the next 32
//     already in flight, and handed to lane 0 by shuffle: no row address
//     waits on its own index load.
//   * All 32 lanes read a landed row from shared memory, lane l the 32-bit
//     words l, l + 32, ... (an f32 element or a bf16 pair): no lane idles
//     at E = 100.  The dot is reduced by a butterfly of shuffles.
//   * What bounds it on the H100, measured (PERF.md section 6): a bulk
//     copy costs the SM's copy engine ~12 ns however small, and a row that
//     straddles 128-byte lines arrives as whole lines (a 400-byte row as
//     512 bytes), so at ogbn-products sizes the ring (~21 ms) stays behind
//     the rows variant (~19.3 ms), and far behind it for rows of 256 bytes
//     or less.  Deeper rings, several rows reduced together, 16-byte
//     cp.async instead of the bulk copy, and the two mixed were no faster.
//
// rows (fusedmm_kernel; any other row): a group of threads_per_row threads
// (at most a warp) per output row loads x[j] as 16-byte vectors (or single
// elements), kFmmUnroll lookups ahead of the reduce; f, the dtype, the
// vector path and the vectors per thread are template parameters.
//
// Plain C interface (loaded with ctypes): launches on the stream it is
// given, allocates nothing, returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).

#include <algorithm>

#include "ember_common.cuh"
#include "ember_hopper.cuh"

namespace {

using ember::bulk_load;
using ember::kMaxBlockThreads;
using ember::mbar_expect_tx;
using ember::mbar_init;
using ember::mbar_init_fence;
using ember::mbar_wait;
using ember::RowAccess;
using ember::set_smem;
using ember::smem_u32;
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


// ---------------------------------------------------------------------------
// ring variant
// ---------------------------------------------------------------------------

constexpr int kRingWarps = 8;               // output rows in flight per block
constexpr int kRingMaxStages = 16;
constexpr int kRingBytesPerWarp = 6144;     // the ring one warp aims for
constexpr int kRingBarBytes = kRingWarps * kRingMaxStages * 8;
constexpr int kRingMaxWordsPerLane = 32;    // rows up to 4 KB
constexpr unsigned int kFull = 0xffffffffu;

// A row as 32-bit words: one f32 element, or a pair of bf16 elements.
template <typename T> struct Word;

template <> struct Word<float> {
  static constexpr int kElems = 1;
  __device__ __forceinline__ static void widen(uint32_t w, float* v) {
    v[0] = __uint_as_float(w);
  }
  __device__ __forceinline__ static uint32_t narrow(const float* v) {
    return __float_as_uint(v[0]);
  }
};

template <> struct Word<__nv_bfloat16> {
  static constexpr int kElems = 2;
  __device__ __forceinline__ static void widen(uint32_t w, float* v) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
    v[0] = f.x;
    v[1] = f.y;
  }
  __device__ __forceinline__ static uint32_t narrow(const float* v) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
};

// NW: 32-bit words per lane (a power of two covering row_words / 32).  The
// dot is reduced by a butterfly of shuffles, which leaves the same sum in
// every lane.
//
// Stage reuse: a stage is refilled only after the __syncwarp() that follows
// every lane's reads of it; the warp barrier's memory ordering puts those
// reads before lane 0's refill.  The refill (async proxy) is thus ordered
// after the generic-proxy reads it overwrites -- the consumer-release
// pattern of TMA pipelines, which needs no proxy fence (a fence is needed
// the other way round, before the async proxy reads what threads wrote).
//
// No __launch_bounds__: with it ptxas held the bf16 four-word instantiation
// to 48 registers and spilled; without it none spills, and the most any
// takes (177) still fits a 256-thread block.
template <typename T, int FN, int NW>
__global__ void fusedmm_ring_kernel(const T* __restrict__ x,
                                    const int* __restrict__ ptrs,
                                    const int* __restrict__ idxs,
                                    T* __restrict__ out,
                                    long long num_segments, int row_words,
                                    int stages) {
  using Wd = Word<T>;
  constexpr int kE = Wd::kElems;
  extern __shared__ __align__(128) uint8_t fmm_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t row_bytes = 4u * (uint32_t)row_words;
  const uint32_t ring_off =
      kRingBarBytes + (uint32_t)warp * (uint32_t)stages * row_bytes;
  const uint32_t bars = smem_u32(fmm_smem) + warp * kRingMaxStages * 8;
  const uint32_t ring = smem_u32(fmm_smem) + ring_off;
  const uint32_t* __restrict__ ring_words =
      reinterpret_cast<const uint32_t*>(fmm_smem + ring_off);
  const long long warps = (long long)gridDim.x * kRingWarps;
  const long long w = (long long)blockIdx.x * kRingWarps + warp;
  const long long seg_lo = num_segments * w / warps;
  const long long seg_hi = num_segments * (w + 1) / warps;
  if (seg_lo >= seg_hi) return;  // the whole warp; no block barrier follows
  if (lane == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 1);
    mbar_init_fence();
  }
  __syncwarp();

  // producer: the warp's lookups are idxs[p0, p1); lane l holds
  // idxs[pb + l] in buf and idxs[pb + 32 + l] in nbuf
  const int p0 = __ldg(ptrs + seg_lo);
  const int p1 = __ldg(ptrs + seg_hi);
  const uint8_t* __restrict__ xb = reinterpret_cast<const uint8_t*>(x);
  int pb = p0;
  int buf = p0 + lane < p1 ? __ldg(idxs + p0 + lane) : 0;
  int nbuf = p0 + 32 + lane < p1 ? __ldg(idxs + p0 + 32 + lane) : 0;
  // lookup p (called for p = p0, p0 + 1, ... in turn) into stage st
  auto produce = [&](int p, int st) {
    if (p - pb >= 32) {
      pb += 32;
      buf = nbuf;
      nbuf = pb + 32 + lane < p1 ? __ldg(idxs + pb + 32 + lane) : 0;
    }
    const int j = __shfl_sync(kFull, buf, p - pb);
    if (lane == 0) {
      mbar_expect_tx(bars + 8 * st, row_bytes);
      bulk_load(ring + (uint32_t)st * row_bytes, xb + (long long)j * row_bytes,
                row_bytes, bars + 8 * st);
    }
  };
  for (int p = p0; p < p1 && p < p0 + stages; ++p) produce(p, p - p0);

  int q = p0;      // the next lookup to reduce: in stage st, phase `phase`
  int st = 0;
  uint32_t phase = 0;
  for (long long i = seg_lo; i < seg_hi; ++i) {
    const int end = __ldg(ptrs + i + 1);
    const uint32_t* __restrict__ xrow =
        reinterpret_cast<const uint32_t*>(x) + i * row_words;
    float xi[NW][kE];
    float acc[NW][kE];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        xi[k][e] = 0.0f;
        acc[k][e] = 0.0f;
      }
      if (lane + 32 * k < row_words) Wd::widen(__ldg(xrow + lane + 32 * k), xi[k]);
    }
    for (; q < end; ++q) {
      mbar_wait(bars + 8 * st, phase);
      // two passes over the landed row (the dot, then the axpy) read it
      // from shared memory twice rather than hold it in registers
      const uint32_t* __restrict__ xs = ring_words + st * row_words;
      float d = 0.0f;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        if (lane + 32 * k < row_words) {
          float v[kE];
          Wd::widen(xs[lane + 32 * k], v);
#pragma unroll
          for (int e = 0; e < kE; ++e) d = fmaf(xi[k][e], v[e], d);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
      const float s = apply_fn<FN>(d);
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        if (lane + 32 * k < row_words) {
          float v[kE];
          Wd::widen(xs[lane + 32 * k], v);
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[k][e] = fmaf(s, v[e], acc[k][e]);
        }
      }
      __syncwarp();
      if (q + stages < p1) produce(q + stages, st);
      if (++st == stages) {
        st = 0;
        phase ^= 1u;
      }
    }
    uint32_t* __restrict__ orow = reinterpret_cast<uint32_t*>(out) + i * row_words;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      if (lane + 32 * k < row_words) orow[lane + 32 * k] = Wd::narrow(acc[k]);
    }
  }
}

struct RingArgs {
  const void* x;
  const int* ptrs;
  const int* idxs;
  void* out;
  long long num_segments;
  int row_words;
};

template <typename T, int FN, int NW>
int launch_ring(const RingArgs& a, cudaStream_t s) {
  const int row_bytes = 4 * a.row_words;
  const int stages =
      std::min(kRingMaxStages, std::max(2, kRingBytesPerWarp / row_bytes));
  const int smem = kRingBarBytes + kRingWarps * stages * row_bytes;
  auto kernel = fusedmm_ring_kernel<T, FN, NW>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kRingWarps * 32, smem);
  if (err != cudaSuccess) return (int)err;
  // every resident warp, no more warps than segments
  long long blocks = (long long)sms * std::max(per_sm, 1);
  blocks = std::min(blocks, (a.num_segments + kRingWarps - 1) / kRingWarps);
  kernel<<<(unsigned int)blocks, kRingWarps * 32, smem, s>>>(
      static_cast<const T*>(a.x), a.ptrs, a.idxs, static_cast<T*>(a.out),
      a.num_segments, a.row_words, stages);
  return (int)cudaGetLastError();
}

template <typename T, int FN>
int ring_by_nw(int nw, const RingArgs& a, cudaStream_t s) {
  switch (nw) {
    case 1: return launch_ring<T, FN, 1>(a, s);
    case 2: return launch_ring<T, FN, 2>(a, s);
    case 4: return launch_ring<T, FN, 4>(a, s);
    case 8: return launch_ring<T, FN, 8>(a, s);
    case 16: return launch_ring<T, FN, 16>(a, s);
    default: return launch_ring<T, FN, kRingMaxWordsPerLane>(a, s);
  }
}

template <typename T>
int ring_by_fn(int fn, int nw, const RingArgs& a, cudaStream_t s) {
  return fn == kFnRelu ? ring_by_nw<T, kFnRelu>(nw, a, s)
                       : ring_by_nw<T, kFnIdentity>(nw, a, s);
}

}  // namespace

// The rows variant.  dtype: 0 = float32, 1 = bfloat16.  fn: 0 identity,
// 1 relu.  vec: 1 for 16-byte row access (the caller has checked the row width and the
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

// The ring variant.  dtype: 0 = float32, 1 = bfloat16.  fn: 0 identity,
// 1 relu.  Rows of emb_len elements must be whole 16-byte units of at most
// 4 KB (E <= 1024 f32, 2048 bf16), x and out 16-byte aligned.
extern "C" int ember_fusedmm_ring(const void* x, const void* ptrs,
                                  const void* idxs, void* out,
                                  long long num_segments, long long emb_len,
                                  int dtype, int fn, void* stream) {
  if (num_segments <= 0 || num_segments > 0x7fffffffLL || emb_len <= 0 ||
      (dtype != 0 && dtype != 1) || (fn != kFnIdentity && fn != kFnRelu) ||
      ((uintptr_t)x | (uintptr_t)out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long row_bytes = emb_len * (dtype == 0 ? 4 : 2);
  if (row_bytes % 16 != 0 || row_bytes > 4LL * 32 * kRingMaxWordsPerLane) {
    return (int)cudaErrorInvalidValue;
  }
  const int row_words = (int)(row_bytes / 4);
  int nw = 1;
  while (32 * nw < row_words) nw <<= 1;
  const RingArgs a{x, static_cast<const int*>(ptrs),
                   static_cast<const int*>(idxs), out, num_segments,
                   row_words};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? ring_by_fn<float>(fn, nw, a, s)
                    : ring_by_fn<__nv_bfloat16>(fn, nw, a, s);
}
