// Hand-written Hopper (sm_90a) kernels of the Ember embedding runtime.
//
// ember_sls replaces the TPU kernel sls_pallas / _sls_kernel
// (src/repro/kernels/sls.py): every CSR unit of a compiled program (sls,
// weighted spmm, kg as one-lookup CSR, fused multi-table units through the
// per-segment seg_base stream) runs through it.
//
//   out[b, :] = (+)_{p in [ptrs[b], ptrs[b+1])} w_p (x) T[idxs[p] + seg_base[b], :]
//   (+) in {add, max, min}, (x) in {mul, add}; an empty segment gives 0.
//
// ember_block_gather replaces block_gather_pallas / _gather_kernel
// (src/repro/kernels/gather.py): every gather unit (token embedding, label
// gather, MoE dispatch, fused gathers rebased by roff).
//
//   out[g, r, :] = T[(idxs[g] + roff[g]) * R + r, :]
//
// What bounds them: bytes.  Both do at most one floating-point operation per
// element read (the gather none), far below the card's ~20 operations per
// byte of fp32 balance, so their floor is the looked-up rows read once and
// the output written once over the 3.35 TB/s of HBM3.  Rows are scattered, so
// the rate a kernel reaches is set by how many independent row reads it keeps
// in flight.
//
// What the design does about it:
//   * 16-byte loads and stores (float4, or 8 bf16) whenever the row width
//     and the base pointers allow it; neighbouring threads read neighbouring
//     vectors of one row, so each row read is a few full 128-byte lines.
//   * SLS: a group of threads_per_row threads (a warp or less) owns one
//     (segment, column tile) and loops over the segment's own lookups -- no
//     padding to a max_lookups grid, so the padded tail of idxs is never read.
//     The loop is unrolled by kUnroll: the indices and the rows of the next
//     kUnroll lookups are all loaded before any is reduced, which keeps
//     several scattered reads in flight per thread (the access stream running
//     ahead of execute, the DAE queue).  The accumulator is fp32 in registers
//     and is stored once, in the table's dtype.
//   * Gather: a grid-stride copy of whole rows with no compute; four
//     independent 16-byte loads are issued before their stores.
//   * Row offsets are computed in 64 bits: a stacked table can hold more than
//     2^31 elements.
//
// Plain C interface (loaded with ctypes).  Both entry points launch on the
// stream they are given, allocate nothing, and return the cudaError_t of the
// launch (cudaErrorInvalidValue for arguments the kernels do not take).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kAddSum = 0;
constexpr int kAddMax = 1;
constexpr int kAddMin = 2;
constexpr int kMulMul = 0;
constexpr int kMulAdd = 1;
constexpr int kUnroll = 4;
constexpr int kMaxBlockThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte vector of T, widened to / narrowed from fp32 registers.
template <typename T> struct Vec16;

template <> struct Vec16<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Vec16<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    unsigned int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned int*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Row access of one thread: a 16-byte vector, or one element (scalar path
// for rows whose width or alignment rules out 16-byte access).
template <typename T, bool VEC> struct RowAccess {
  static constexpr int kElems = VEC ? Vec16<T>::kElems : 1;
  __device__ __forceinline__ static void load(const T* p, float* v) {
    if constexpr (VEC) {
      Vec16<T>::load(p, v);
    } else {
      v[0] = to_float(p[0]);
    }
  }
  __device__ __forceinline__ static void store(T* p, const float* v) {
    if constexpr (VEC) {
      Vec16<T>::store(p, v);
    } else {
      p[0] = from_float<T>(v[0]);
    }
  }
};

template <int ADD> __device__ __forceinline__ float add_identity() {
  const float inf = __int_as_float(0x7f800000);
  if constexpr (ADD == kAddSum) {
    return 0.0f;
  } else if constexpr (ADD == kAddMax) {
    return -inf;
  } else {
    return inf;
  }
}

template <int ADD> __device__ __forceinline__ float add_op(float a, float b) {
  if constexpr (ADD == kAddSum) {
    return a + b;
  } else if constexpr (ADD == kAddMax) {
    return fmaxf(a, b);
  } else {
    return fminf(a, b);
  }
}

template <int MUL> __device__ __forceinline__ float mul_op(float v, float w) {
  if constexpr (MUL == kMulMul) {
    return v * w;
  } else {
    return v + w;
  }
}

template <typename T, int ADD, int MUL, bool WEIGHTED, bool VEC>
__global__ void __launch_bounds__(kMaxBlockThreads)
sls_kernel(const T* __restrict__ table, const int* __restrict__ ptrs,
           const int* __restrict__ idxs, const T* __restrict__ weights,
           const int* __restrict__ seg_base, T* __restrict__ out,
           long long num_segments, long long emb_len, int threads_per_row,
           long long tiles) {
  using Row = RowAccess<T, VEC>;
  constexpr int kW = Row::kElems;
  const int rows_per_block = blockDim.x / threads_per_row;
  const long long item = (long long)blockIdx.x * rows_per_block +
                         threadIdx.x / threads_per_row;
  if (item >= num_segments * tiles) return;
  const long long b = item / tiles;
  const long long col =
      ((item % tiles) * threads_per_row + threadIdx.x % threads_per_row) *
      (long long)kW;
  if (col >= emb_len) return;  // ragged last tile
  const int beg = ptrs[b];
  const int end = ptrs[b + 1];
  const long long base = seg_base != nullptr ? (long long)seg_base[b] : 0LL;
  const T* __restrict__ src = table + col;

  float acc[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) acc[i] = add_identity<ADD>();

  int p = beg;
  for (; p + kUnroll <= end; p += kUnroll) {
    // access: all kUnroll row reads are issued before any is reduced
    long long row[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) row[u] = (long long)idxs[p + u] + base;
    float v[kUnroll][kW];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) Row::load(src + row[u] * emb_len, v[u]);
    // execute: reduce in lookup order
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if constexpr (WEIGHTED) {
        const float w = to_float(weights[p + u]);
#pragma unroll
        for (int i = 0; i < kW; ++i)
          acc[i] = add_op<ADD>(acc[i], mul_op<MUL>(v[u][i], w));
      } else {
#pragma unroll
        for (int i = 0; i < kW; ++i) acc[i] = add_op<ADD>(acc[i], v[u][i]);
      }
    }
  }
  for (; p < end; ++p) {
    float v[kW];
    Row::load(src + ((long long)idxs[p] + base) * emb_len, v);
    if constexpr (WEIGHTED) {
      const float w = to_float(weights[p]);
#pragma unroll
      for (int i = 0; i < kW; ++i)
        acc[i] = add_op<ADD>(acc[i], mul_op<MUL>(v[i], w));
    } else {
#pragma unroll
      for (int i = 0; i < kW; ++i) acc[i] = add_op<ADD>(acc[i], v[i]);
    }
  }
  if (end == beg) {  // SLS convention: an empty segment is 0 under every (+)
#pragma unroll
    for (int i = 0; i < kW; ++i) acc[i] = 0.0f;
  }
  Row::store(out + b * emb_len + col, acc);
}

// V is the unit of the copy: uint4 (16 bytes) or one 4- or 2-byte element.
template <typename V>
__global__ void __launch_bounds__(kMaxBlockThreads)
gather_kernel(const V* __restrict__ table, const int* __restrict__ idxs,
              const int* __restrict__ roff, V* __restrict__ out,
              long long out_rows, long long row_vecs, long long block_rows,
              int threads_per_row) {
  const int rows_per_block = blockDim.x / threads_per_row;
  const int lane = threadIdx.x % threads_per_row;
  const long long stride = (long long)gridDim.x * rows_per_block;
  for (long long row = (long long)blockIdx.x * rows_per_block +
                       threadIdx.x / threads_per_row;
       row < out_rows; row += stride) {
    const long long g = row / block_rows;
    const long long blk =
        (long long)idxs[g] + (roff != nullptr ? (long long)roff[g] : 0LL);
    const V* __restrict__ s =
        table + (blk * block_rows + row % block_rows) * row_vecs;
    V* __restrict__ d = out + row * row_vecs;
    const long long t = threads_per_row;
    long long c = lane;
    for (; c + 3 * t < row_vecs; c += 4 * t) {
      const V a0 = __ldg(s + c);
      const V a1 = __ldg(s + c + t);
      const V a2 = __ldg(s + c + 2 * t);
      const V a3 = __ldg(s + c + 3 * t);
      d[c] = a0;
      d[c + t] = a1;
      d[c + 2 * t] = a2;
      d[c + 3 * t] = a3;
    }
    for (; c < row_vecs; c += t) d[c] = __ldg(s + c);
  }
}

struct SlsArgs {
  const void* table;
  const int* ptrs;
  const int* idxs;
  const void* weights;
  const int* seg_base;
  void* out;
  long long num_segments;
  long long emb_len;
  int threads_per_row;
  long long tiles;
};

template <typename T, int ADD, int MUL, bool WEIGHTED, bool VEC>
void launch_sls(const SlsArgs& a, dim3 grid, dim3 block, cudaStream_t s) {
  sls_kernel<T, ADD, MUL, WEIGHTED, VEC><<<grid, block, 0, s>>>(
      static_cast<const T*>(a.table), a.ptrs, a.idxs,
      static_cast<const T*>(a.weights), a.seg_base, static_cast<T*>(a.out),
      a.num_segments, a.emb_len, a.threads_per_row, a.tiles);
}

template <typename T, int ADD, int MUL, bool WEIGHTED>
void sls_by_vec(bool vec, const SlsArgs& a, dim3 g, dim3 b, cudaStream_t s) {
  if (vec) {
    launch_sls<T, ADD, MUL, WEIGHTED, true>(a, g, b, s);
  } else {
    launch_sls<T, ADD, MUL, WEIGHTED, false>(a, g, b, s);
  }
}

template <typename T, int ADD>
void sls_by_mul(bool weighted, int mul, bool vec, const SlsArgs& a, dim3 g,
                dim3 b, cudaStream_t s) {
  if (!weighted) {
    sls_by_vec<T, ADD, kMulMul, false>(vec, a, g, b, s);
  } else if (mul == kMulMul) {
    sls_by_vec<T, ADD, kMulMul, true>(vec, a, g, b, s);
  } else {
    sls_by_vec<T, ADD, kMulAdd, true>(vec, a, g, b, s);
  }
}

template <typename T>
void sls_by_add(int add, bool weighted, int mul, bool vec, const SlsArgs& a,
                dim3 g, dim3 b, cudaStream_t s) {
  if (add == kAddSum) {
    sls_by_mul<T, kAddSum>(weighted, mul, vec, a, g, b, s);
  } else if (add == kAddMax) {
    sls_by_mul<T, kAddMax>(weighted, mul, vec, a, g, b, s);
  } else {
    sls_by_mul<T, kAddMin>(weighted, mul, vec, a, g, b, s);
  }
}

bool valid_block(int threads_per_row, int rows_per_block) {
  return threads_per_row > 0 && threads_per_row <= 32 &&
         (threads_per_row & (threads_per_row - 1)) == 0 &&
         rows_per_block > 0 &&
         threads_per_row * rows_per_block <= kMaxBlockThreads;
}

}  // namespace

extern "C" const char* ember_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  add_op: 0 add, 1 max, 2 min.
// mul_op: 0 mul, 1 add.  vec: 1 for 16-byte row access (the caller has
// checked the row width and the alignment of table and out).
extern "C" int ember_sls(const void* table, const void* ptrs,
                         const void* idxs, const void* weights,
                         const void* seg_base, void* out,
                         long long num_segments, long long emb_len, int dtype,
                         int add_op, int mul_op, int vec, int threads_per_row,
                         int rows_per_block, void* stream) {
  if (num_segments <= 0 || emb_len <= 0 || (dtype != 0 && dtype != 1) ||
      add_op < 0 || add_op > 2 || mul_op < 0 || mul_op > 1 ||
      !valid_block(threads_per_row, rows_per_block)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long elems = vec ? (dtype == 0 ? 4 : 8) : 1;
  if (emb_len % elems != 0) return (int)cudaErrorInvalidValue;
  const long long vecs = emb_len / elems;
  const long long tiles = (vecs + threads_per_row - 1) / threads_per_row;
  const long long blocks =
      (num_segments * tiles + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const SlsArgs a{table,
                  static_cast<const int*>(ptrs),
                  static_cast<const int*>(idxs),
                  weights,
                  static_cast<const int*>(seg_base),
                  out,
                  num_segments,
                  emb_len,
                  threads_per_row,
                  tiles};
  const dim3 grid((unsigned int)blocks);
  const dim3 block((unsigned int)(threads_per_row * rows_per_block));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool weighted = weights != nullptr;
  if (dtype == 0) {
    sls_by_add<float>(add_op, weighted, mul_op, vec != 0, a, grid, block, s);
  } else {
    sls_by_add<__nv_bfloat16>(add_op, weighted, mul_op, vec != 0, a, grid,
                              block, s);
  }
  return (int)cudaGetLastError();
}

// unit_bytes: 16 (uint4 vectors), 4 or 2 (one element); row_bytes must be a
// multiple of it, and table / out aligned to it.
extern "C" int ember_block_gather(const void* table, const void* idxs,
                                  const void* roff, void* out,
                                  long long num_blocks, long long block_rows,
                                  long long row_bytes, int unit_bytes,
                                  int threads_per_row, int rows_per_block,
                                  void* stream) {
  if (num_blocks <= 0 || block_rows <= 0 || row_bytes <= 0 ||
      (unit_bytes != 16 && unit_bytes != 4 && unit_bytes != 2) ||
      row_bytes % unit_bytes != 0 ||
      !valid_block(threads_per_row, rows_per_block)) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long out_rows = num_blocks * block_rows;
  const long long row_vecs = row_bytes / unit_bytes;
  const int block_threads = threads_per_row * rows_per_block;
  // enough blocks to fill every SM (2048 resident threads each), no more:
  // the kernel strides over the rest
  long long blocks = (out_rows + rows_per_block - 1) / rows_per_block;
  const long long fill = (long long)sms * (2048 / block_threads);
  if (blocks > fill) blocks = fill;
  const dim3 grid((unsigned int)blocks);
  const dim3 block((unsigned int)block_threads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(idxs);
  const int* off = static_cast<const int*>(roff);
  if (unit_bytes == 16) {
    gather_kernel<uint4><<<grid, block, 0, s>>>(
        static_cast<const uint4*>(table), ids, off, static_cast<uint4*>(out),
        out_rows, row_vecs, block_rows, threads_per_row);
  } else if (unit_bytes == 4) {
    gather_kernel<unsigned int><<<grid, block, 0, s>>>(
        static_cast<const unsigned int*>(table), ids, off,
        static_cast<unsigned int*>(out), out_rows, row_vecs, block_rows,
        threads_per_row);
  } else {
    gather_kernel<unsigned short><<<grid, block, 0, s>>>(
        static_cast<const unsigned short*>(table), ids, off,
        static_cast<unsigned short*>(out), out_rows, row_vecs, block_rows,
        threads_per_row);
  }
  return (int)cudaGetLastError();
}
