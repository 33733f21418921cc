// The stable transposition of a block gather's lookups into CSR, for the
// gather's backward on Hopper (sm_90a).
//
// What it stands in for: the reference takes the block gather's gradient
// with jax.grad of jnp.take (the function of block_gather_pallas,
// src/repro/kernels/gather.py), a scatter-add that XLA sums in an order of
// its own.  The port sums each table row's cotangents with ember_sls (the
// counterpart of sls_pallas, src/repro/kernels/sls.py) over the lookups
// transposed into CSR, in ascending lookup order, so two runs give the same
// bits.  This file computes that CSR:
//
//   order   = the lookups g, sorted stably by block id idxs[g] + roff[g]
//   ptrs[k] = #{g : idxs[g] + roff[g] < k},  k = 0 .. n_tbl
//
// What bounds it: bytes, in principle -- G ids read, G + n_tbl + 1 ints
// written -- but at the sizes of a training step (G up to ~10^5) the floor
// is a few microseconds of dependent steps and launches: a sort cannot
// place an item before it has counted the items ahead of it.
//
// What the design does about it:
//   * A stable LSD radix sort on 8-bit digits of the block id, only the
//     digits n_tbl needs (two passes up to 65,536 blocks, three up to 2^24),
//     the lookup index g riding along as the value.  A pass ranks a tile of
//     items stably with no atomic deciding an order: a warp takes its items
//     in lookup order, nine ballots group one step's equal digits, the
//     group's leader bumps the (digit, warp) count in shared memory, and an
//     exclusive scan of the counts in digit-major, warp-minor order gives
//     each item its place (block_rank).
//   * G <= kSmallMax (8,192: whisper's 1,500, danube's 8,192 and the
//     reduced MoE's 2,048 ids): one block of 1024 threads holds all the
//     items in shared memory (a thread's 2 to 8 keys also in registers,
//     the 64 a thread has at 1024 threads) and runs every pass in one
//     launch.
//   * Larger G (DeepSeek-V2-Lite's 98,304 un-dispatch rows): per pass, tiles
//     of kTile items -- a digit histogram per tile, then a stable scatter
//     of each tile, which finds its digits' places itself from all tiles'
//     histograms (its digit's count in the tiles before it and every
//     smaller digit's total): two launches a pass.  Every tile reads every
//     tile's histogram, which is cheap up to a few hundred thousand
//     lookups.
//   * ptrs is a lower bound of k in the sorted block ids, one thread per k:
//     no histogram over the n_tbl blocks and no scan of it.
//
// Plain C interface (loaded with ctypes); launches on the given stream,
// allocates nothing (the scratch is the caller's) and returns the
// cudaError_t of the launches.  Block ids must lie in [0, n_tbl): others
// are sorted by their low digits only, but no write leaves the outputs.

#include <algorithm>

#include "ember_common.cuh"
#include "ember_hopper.cuh"

namespace {

constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr unsigned int kFull = 0xffffffffu;
constexpr int kSmallThreads = 1024;
constexpr int kSmallMaxItems = 8;  // a thread's items in the one-block sort
constexpr long long kSmallMax = (long long)kSmallThreads * kSmallMaxItems;
constexpr int kTileThreads = 256;
constexpr int kTileItems = 8;
constexpr int kTile = kTileThreads * kTileItems;
constexpr int kPtrsThreads = 256;
constexpr long long kMaxLookups = 0x7fffffffLL;

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive scan of one int a thread over the block; *total gets the sum.
// s_warp holds THREADS / 32 + 1 ints and is free again after the call.
template <int THREADS>
__device__ __forceinline__ int block_exclusive_scan(int x, int* s_warp,
                                                    int* total) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(x, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? s_warp[lane] : 0;
    const int wi = warp_inclusive_scan(w, lane);
    if (lane < kWarps) s_warp[lane] = wi - w;
    if (lane == kWarps - 1) s_warp[kWarps] = wi;
  }
  __syncthreads();
  *total = s_warp[kWarps];
  const int out = s_warp[warp] + incl - x;
  __syncthreads();
  return out;
}

// Shared memory of block_rank: the tile's item counts by (digit, warp),
// digit-major, a pad column keeping one warp's leaders on distinct banks.
template <int THREADS> struct RankSmem {
  static constexpr int kWarps = THREADS / 32;
  static constexpr int kStride = kWarps + 1;
  int cnt[kRadix * kStride];
  int warp_sums[kWarps + 1];
  int digit_start[kRadix];  // the tile's first place of each digit
};

__device__ __forceinline__ int digit_of(int key, int shift) {
  return (int)(((unsigned int)key >> shift) & (kRadix - 1));
}

// The tile's element of item j of lane l of warp w: (w * IPT + j) * 32 + l.
template <int IPT>
__device__ __forceinline__ int tile_element(int j) {
  return ((threadIdx.x >> 5) * IPT + j) * 32 + (threadIdx.x & 31);
}

// The stable ranks of a tile's items by the digit of their keys at shift;
// items at tile element `valid` or later are past the end and take no
// rank.  rank[j] becomes the item's place in the tile sorted stably by
// digit; sm.digit_start[d] the first place of digit d.
// Equal digits keep the order of their elements: within a warp by step,
// then lane; across warps by the warp-minor order of the scan.  (The
// digits are taken from the keys where needed, not kept: at 1024 threads
// a thread has 64 registers.)
template <int THREADS, int IPT>
__device__ __forceinline__ void block_rank(const int (&key)[IPT], int shift,
                                           long long valid, int (&rank)[IPT],
                                           RankSmem<THREADS>& sm) {
  constexpr int kWarps = RankSmem<THREADS>::kWarps;
  constexpr int kStride = RankSmem<THREADS>::kStride;
  constexpr int kPer = kRadix * kWarps / THREADS;  // scan entries a thread
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the previous pass has read its counts
  for (int i = threadIdx.x; i < kRadix * kStride; i += THREADS) sm.cnt[i] = 0;
  __syncthreads();
  const unsigned int lt = (1u << lane) - 1u;
  auto digit = [&](int j) {  // kRadix past the end
    return tile_element<IPT>(j) < valid ? digit_of(key[j], shift) : kRadix;
  };
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int d = digit(j);
    // the lanes of this step with digit d: one ballot a bit of the digit
    // and one for "past the end" (kRadix)
    unsigned int peers = kFull;
#pragma unroll
    for (int b = 0; b <= kRadixBits; ++b) {
      const bool bit = (d >> b) & 1;
      const unsigned int m = __ballot_sync(kFull, bit);
      peers &= bit ? m : ~m;
    }
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (lane == leader && d < kRadix) {
      int* c = &sm.cnt[d * kStride + warp];
      base = *c;
      *c = base + __popc(peers);
    }
    rank[j] = __shfl_sync(kFull, base, leader) + __popc(peers & lt);
    __syncwarp();  // the next step's leader may be another lane
  }
  __syncthreads();
  int vals[kPer];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x * kPer + i;
    vals[i] = sm.cnt[(e / kWarps) * kStride + e % kWarps];
    sum += vals[i];
  }
  int total = 0;
  int run = block_exclusive_scan<THREADS>(sum, sm.warp_sums, &total);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x * kPer + i;
    const int d = e / kWarps;
    const int w = e % kWarps;
    sm.cnt[d * kStride + w] = run;
    if (w == 0) sm.digit_start[d] = run;
    run += vals[i];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int d = digit(j);
    if (d < kRadix) rank[j] += sm.cnt[d * kStride + warp];
  }
}

__device__ __forceinline__ int block_id(const int* __restrict__ idxs,
                                        const int* __restrict__ roff,
                                        long long g) {
  return __ldg(idxs + g) + (roff != nullptr ? __ldg(roff + g) : 0);
}

// G <= kSmallThreads * IPT: every pass in one block, the items in shared
// memory between passes; writes order and the sorted block ids.  A thread
// keeps its items' keys in registers and their lookup indices only in
// shared memory (two buffers, one a pass), so that 1024 threads of 8
// items fit 64 registers.
template <int IPT>
__global__ void __launch_bounds__(kSmallThreads)
transpose_block_kernel(const int* __restrict__ idxs,
                       const int* __restrict__ roff, int num_lookups,
                       int passes, int* __restrict__ order,
                       int* __restrict__ sorted) {
  extern __shared__ __align__(16) int transpose_smem[];
  auto& sm = *reinterpret_cast<RankSmem<kSmallThreads>*>(transpose_smem);
  int* s_key = transpose_smem + sizeof(RankSmem<kSmallThreads>) / 4;
  int* s_val[2] = {s_key + kSmallThreads * IPT,
                   s_key + 2 * kSmallThreads * IPT};
  // every load is issued unconditionally (an item past the end reads the
  // last id): a load under a condition makes the compiler wait for it
  // before the next is issued
  int key[IPT];
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    key[j] = block_id(idxs, roff, min(tile_element<IPT>(j), num_lookups - 1));
  }
  for (int pass = 0; pass < passes; ++pass) {
    int rank[IPT];
    block_rank<kSmallThreads, IPT>(key, pass * kRadixBits, num_lookups, rank,
                                   sm);
    const int* vals_in = s_val[(pass + 1) & 1];  // the last pass's order
    int* vals_out = s_val[pass & 1];
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      const int e = tile_element<IPT>(j);
      if (e < num_lookups) {
        s_key[rank[j]] = key[j];
        vals_out[rank[j]] = pass == 0 ? e : vals_in[e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      const int e = tile_element<IPT>(j);
      if (e < num_lookups) key[j] = s_key[e];
    }
  }
  const int* vals = s_val[(passes - 1) & 1];
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int e = tile_element<IPT>(j);
    if (e < num_lookups) {
      order[e] = vals[e];
      sorted[e] = key[j];
    }
  }
}

// Larger G, one pass: tile t's items are elements t * kTile + (w * IPT + j)
// * 32 + l.  keys_in null: the first pass, keys from idxs + roff, values g.

__global__ void __launch_bounds__(kTileThreads)
transpose_hist_kernel(const int* __restrict__ idxs,
                      const int* __restrict__ roff,
                      const int* __restrict__ keys_in, long long num_lookups,
                      int shift, int* __restrict__ hist, int tiles) {
  __shared__ int s_hist[kRadix];
  for (int d = threadIdx.x; d < kRadix; d += kTileThreads) s_hist[d] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kTile;
  int key[kTileItems];  // all loaded before the first is counted
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const long long at =
        min(base + j * kTileThreads + threadIdx.x, num_lookups - 1);
    key[j] = keys_in != nullptr ? __ldg(keys_in + at)
                                : block_id(idxs, roff, at);
  }
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    if (base + j * kTileThreads + threadIdx.x < num_lookups) {
      atomicAdd(&s_hist[digit_of(key[j], shift)], 1);  // a count: no order
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kRadix; d += kTileThreads) {
    hist[(long long)blockIdx.x * kRadix + d] = s_hist[d];
  }
}

__global__ void __launch_bounds__(kTileThreads)
transpose_scatter_kernel(const int* __restrict__ idxs,
                         const int* __restrict__ roff,
                         const int* __restrict__ keys_in,
                         const int* __restrict__ vals_in,
                         long long num_lookups, int shift,
                         const int* __restrict__ hist, int tiles,
                         int* __restrict__ keys_out,
                         int* __restrict__ vals_out) {
  static_assert(kTileThreads == kRadix, "a thread a digit");
  __shared__ RankSmem<kTileThreads> sm;
  __shared__ int s_place[kRadix];  // this tile's first global place a digit
  const long long base = (long long)blockIdx.x * kTile;
  {
    // digit d = threadIdx.x: its count in the tiles before this one, and
    // its total; the totals' exclusive scan gives the smaller digits' sum
    int before = 0;
    int total = 0;
    for (int t = 0; t < tiles; ++t) {
      const int c = __ldg(hist + (long long)t * kRadix + threadIdx.x);
      if (t < (int)blockIdx.x) before += c;
      total += c;
    }
    int sum = 0;
    const int smaller =
        block_exclusive_scan<kTileThreads>(total, sm.warp_sums, &sum);
    s_place[threadIdx.x] = smaller + before;
  }
  int key[kTileItems];
  int val[kTileItems];
  int rank[kTileItems];
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const long long e = base + tile_element<kTileItems>(j);
    const long long at = min(e, num_lookups - 1);  // loaded unconditionally
    key[j] = keys_in != nullptr ? __ldg(keys_in + at)
                                : block_id(idxs, roff, at);
    val[j] = vals_in != nullptr ? __ldg(vals_in + at) : (int)e;
  }
  block_rank<kTileThreads, kTileItems>(key, shift, num_lookups - base, rank,
                                       sm);
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    if (base + tile_element<kTileItems>(j) < num_lookups) {
      const int d = digit_of(key[j], shift);
      const long long dest =
          (long long)s_place[d] + rank[j] - sm.digit_start[d];
      keys_out[dest] = key[j];
      vals_out[dest] = val[j];
    }
  }
}

// ptrs[k] = the first place of a block id >= k among the sorted ids.
__global__ void __launch_bounds__(kPtrsThreads)
transpose_ptrs_kernel(const int* __restrict__ sorted, long long num_lookups,
                      long long n_tbl, int* __restrict__ ptrs) {
  const long long k = (long long)blockIdx.x * kPtrsThreads + threadIdx.x;
  if (k > n_tbl) return;
  long long lo = 0;
  long long hi = num_lookups;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if ((long long)__ldg(sorted + mid) < k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  ptrs[k] = (int)lo;
}

// The caller's scratch: the sorted block ids, then (G > kSmallMax) two
// (keys, values) buffers for the passes between and the (tile, digit)
// counts.
struct TransposeScratch {
  int* sorted;
  int* keys[2];
  int* vals[2];
  int* hist;
  long long bytes;
};

inline TransposeScratch transpose_scratch(void* base, long long g) {
  TransposeScratch sc{};
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  long long off = 0;
  auto take = [&](long long ints) {
    int* at = reinterpret_cast<int*>(p + (uintptr_t)off);
    off += (4 * ints + 15) & ~15LL;
    return at;
  };
  sc.sorted = take(g);
  if (g > kSmallMax) {
    for (int b = 0; b < 2; ++b) {
      sc.keys[b] = take(g);
      sc.vals[b] = take(g);
    }
    sc.hist = take((long long)kRadix * ((g + kTile - 1) / kTile));
  }
  sc.bytes = off;
  return sc;
}

template <int IPT>
cudaError_t launch_block_sort(const int* idxs, const int* roff, int g,
                              int passes, int* order, int* sorted,
                              cudaStream_t s) {
  const int smem = (int)sizeof(RankSmem<kSmallThreads>) +
                   3 * kSmallThreads * IPT * (int)sizeof(int);
  auto kernel = transpose_block_kernel<IPT>;
  static bool smem_set[64] = {false};  // once a device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!smem_set[device]) {
    err = ember::set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    smem_set[device] = true;
  }
  kernel<<<1, kSmallThreads, smem, s>>>(idxs, roff, g, passes, order, sorted);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the transposition's scratch for num_lookups lookups (0 for none
// or more than the kernels take).
extern "C" long long ember_transpose_scratch_bytes(long long num_lookups) {
  if (num_lookups <= 0 || num_lookups > kMaxLookups) return 0;
  return transpose_scratch(nullptr, num_lookups).bytes;
}

// order (G,) int32 and ptrs (n_tbl + 1,) int32 of the lookups idxs[g] +
// roff[g] (roff may be null); scratch: ember_transpose_scratch_bytes(G)
// bytes, 16-byte aligned.
extern "C" int ember_transpose(const void* idxs, const void* roff,
                               void* order, void* ptrs, void* scratch,
                               long long num_lookups, long long n_tbl,
                               void* stream) {
  if (num_lookups <= 0 || num_lookups > kMaxLookups || n_tbl <= 0 ||
      n_tbl >= kMaxLookups || idxs == nullptr || order == nullptr ||
      ptrs == nullptr || scratch == nullptr ||
      (uintptr_t)scratch % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int bits = 0;
  while ((1LL << bits) < n_tbl) ++bits;
  const int passes = std::max(1, (bits + kRadixBits - 1) / kRadixBits);
  const TransposeScratch sc = transpose_scratch(scratch, num_lookups);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(idxs);
  const int* off = static_cast<const int*>(roff);
  int* out_order = static_cast<int*>(order);
  cudaError_t err = cudaSuccess;
  if (num_lookups <= kSmallMax) {
    const int g = (int)num_lookups;
    if (g <= kSmallThreads * 2) {
      err = launch_block_sort<2>(ids, off, g, passes, out_order, sc.sorted, s);
    } else if (g <= kSmallThreads * 4) {
      err = launch_block_sort<4>(ids, off, g, passes, out_order, sc.sorted, s);
    } else {
      err = launch_block_sort<kSmallMaxItems>(ids, off, g, passes, out_order,
                                              sc.sorted, s);
    }
  } else {
    const int tiles = (int)((num_lookups + kTile - 1) / kTile);
    for (int pass = 0; pass < passes && err == cudaSuccess; ++pass) {
      const bool last = pass == passes - 1;
      const int* keys_in = pass == 0 ? nullptr : sc.keys[(pass - 1) % 2];
      const int* vals_in = pass == 0 ? nullptr : sc.vals[(pass - 1) % 2];
      int* keys_out = last ? sc.sorted : sc.keys[pass % 2];
      int* vals_out = last ? out_order : sc.vals[pass % 2];
      const int shift = pass * kRadixBits;
      transpose_hist_kernel<<<tiles, kTileThreads, 0, s>>>(
          ids, off, keys_in, num_lookups, shift, sc.hist, tiles);
      transpose_scatter_kernel<<<tiles, kTileThreads, 0, s>>>(
          ids, off, keys_in, vals_in, num_lookups, shift, sc.hist, tiles,
          keys_out, vals_out);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_tbl + 1 + kPtrsThreads - 1) / kPtrsThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  transpose_ptrs_kernel<<<(unsigned int)blocks, kPtrsThreads, 0, s>>>(
      sc.sorted, num_lookups, n_tbl, static_cast<int*>(ptrs));
  return (int)cudaGetLastError();
}
