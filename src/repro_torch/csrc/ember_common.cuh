// Device helpers shared by the Ember kernels: fp32 widening of f32 / bf16
// elements and 16-byte row vectors.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace ember {

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

constexpr int kMaxBlockThreads = 256;

// threads_per_row a power of two of at most a warp; the block at most
// kMaxBlockThreads threads
inline bool valid_block(int threads_per_row, int rows_per_block) {
  return threads_per_row > 0 && threads_per_row <= 32 &&
         (threads_per_row & (threads_per_row - 1)) == 0 &&
         rows_per_block > 0 &&
         threads_per_row * rows_per_block <= kMaxBlockThreads;
}

}  // namespace ember
