// Hopper (sm_90a) tensor-core primitives shared by the flash kernels
// (ember_flash_attention.cu, ember_flash_backward.cu), in PTX: TMA loads
// and stores through tensor maps, named barriers, register reallocation
// (setmaxnreg), wgmma with its fences and shared-memory descriptors, and
// on the host the encoding of a (batch, seq, heads, d) bf16 tensor as a
// tensor map.  (mbarriers and bulk copies: ember_hopper.cuh.)
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ember {

// one box of a 4-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// wait until at most N of this warpgroup's committed wgmma groups are in
// flight (groups complete in order)
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads of wgmma-written registers above the
// wait, or writes below the issue.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1
// (SWIZZLE_128B).  K-major: rows of 128 bytes, 8-row groups 1024 bytes
// apart (stride); the leading offset is unused.  MN-major (V): 8 rows of
// the reduction dimension per 1024 bytes (stride), and `lead` bytes between
// 64-column blocks of the output dimension.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lead >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)(1024u >> 4) << 32) | (1ull << 62);
}

#define EMBER_F8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] (+)= A B: m64n128k16, A and B K-major in shared memory.
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : EMBER_F8(d, 0), EMBER_F8(d, 8), EMBER_F8(d, 16), EMBER_F8(d, 24),
        EMBER_F8(d, 32), EMBER_F8(d, 40), EMBER_F8(d, 48), EMBER_F8(d, 56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64] += A B: m64n128k16, A (4 registers of bf16 pairs) from registers, B
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64], uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : EMBER_F8(d, 0), EMBER_F8(d, 8), EMBER_F8(d, 16), EMBER_F8(d, 24),
        EMBER_F8(d, 32), EMBER_F8(d, 40), EMBER_F8(d, 48), EMBER_F8(d, 56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d[32] += A B: m64n64k16, as above (D = 64).
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : EMBER_F8(d, 0), EMBER_F8(d, 8), EMBER_F8(d, 16), EMBER_F8(d, 24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d[32] (+)= A B: m64n64k16, A (4 registers of bf16 pairs) from registers,
// B K-major in shared memory (no transpose).  scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64_rs_kb(float (&d)[32],
                                                   uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3,
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : EMBER_F8(d, 0), EMBER_F8(d, 8), EMBER_F8(d, 16), EMBER_F8(d, 24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d));
}

// d[32] (+)= A B: m64n64k16, A and B K-major in shared memory (the scores
// of a 64-key tile, DQK = 256).  scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : EMBER_F8(d, 0), EMBER_F8(d, 8), EMBER_F8(d, 16), EMBER_F8(d, 24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[128] += A B: m64n256k16, A from registers, B MN-major in shared memory
// (DV = 256).
__device__ __forceinline__ void wgmma_m64n256_rs(float (&d)[128], uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : EMBER_F8(d, 0), EMBER_F8(d, 8), EMBER_F8(d, 16), EMBER_F8(d, 24),
        EMBER_F8(d, 32), EMBER_F8(d, 40), EMBER_F8(d, 48), EMBER_F8(d, 56),
        EMBER_F8(d, 64), EMBER_F8(d, 72), EMBER_F8(d, 80), EMBER_F8(d, 88),
        EMBER_F8(d, 96), EMBER_F8(d, 104), EMBER_F8(d, 112),
        EMBER_F8(d, 120)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d[40] += A B: m64n80k16, A from registers, B MN-major in shared memory:
// an output 80 columns wide at its true width (the flash backward at head
// dim 80), the first 64 from one 64-column block, the last 16 from the
// next, `lead` bytes on.
__device__ __forceinline__ void wgmma_m64n80_rs(float (&d)[40], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"
      "}\n"
      : EMBER_F8(d, 0), EMBER_F8(d, 8), EMBER_F8(d, 16), EMBER_F8(d, 24),
        EMBER_F8(d, 32)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

#undef EMBER_F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Host side: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no link
// against libcuda); null where the driver lacks it
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 (batch, seq, heads, d) tensor as a 4-D map (d, heads, seq, batch)
// read in boxes of 64 columns x `rows` tokens of one head, 128-byte swizzled;
// out-of-bounds rows and columns (past d, when d is not a multiple of 64)
// read as 0 and are never written.
inline bool encode_bshd(CUtensorMap* map, const void* ptr, int batch,
                        int seq, int heads, int d, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)seq * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace ember
