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
// The block gather replaces block_gather_pallas / _gather_kernel
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
//   * Gather, bulk variant (blocks of whole 16-byte units, 16-byte aligned
//     table and out): each DISTINCT block is read once -- the paper's
//     filtering of revisited blocks (gather.py's "revisit" note, Fig. 18).
//     A uniform id stream repeats a block ~27 % of the time and a skewed one
//     far more, and a repeat lands too far away to hit the 50 MB L2.
//     - Grouping pre-pass (ember_gather_group: one memset, three small
//       kernels, no host work): an open-addressed hash table of >= 2 G
//       slots keyed by the 64-bit block idxs[g] + roff[g] (atomicCAS),
//       a warp-aggregated count and rank per slot (__match_any_sync), then
//       a warp-scanned range per distinct block, and every g scattered to
//       its block's range -- a counting sort, so a block's outputs are an
//       array, not a chain one thread walks.  A block's range is cut into
//       work items of at most kGatherPerItem outputs (one store per lane):
//       a hot block of a skewed stream (thousands of outputs) spreads over
//       many warps instead of queueing on one SM, and its repeated loads
//       are served by L2.  The order of ranks and ranges depends on
//       atomics, which is harmless: every output is an exact copy of its
//       block.
//     - Copy (gather_bulk_kernel): persistent one-warp blocks, each with a
//       ring of kGatherStages shared-memory stages.  One lane issues
//       cp.async.bulk loads of an item's block (in chunks of at most
//       kGatherMaxChunk bytes) kGatherAhead items ahead, completing on the
//       stage's mbarrier; once it lands, the lanes issue one
//       cp.async.bulk store of it per output position of the item.  A stage is loaded
//       again only after cp.async.bulk.wait_group.read says the stores
//       issued from it have read it.  No thread copies a byte itself.
//   * Gather, rows variant (other widths, unaligned tables): a grid-stride
//     copy of whole rows with no compute; four independent 16-byte loads
//     are issued before their stores; a repeated block is read again.
//   * SLS, sparse variant (ember_sls_sparse: an unweighted sum, no
//     seg_base, rows of whole 16-byte vectors, no more lookups than
//     segments -- the block gather's backward over its transposed lookups,
//     where most of the table's rows get no lookup, a Zipf head gets
//     hundreds and the next ranks tens).  The kernel above gives each
//     (segment, 32-vector tile) a warp whose ptrs -> idxs -> row chain an
//     empty row pays before storing its zeros, and walks a hot row's
//     lookups a few loads deep.  Here a plan pass sorts the segments into
//     lists by length, and persistent warps take, longest work first:
//     - each hot segment (more than kSparseWarm lookups) in column slices
//       of 32 four-byte units, one a lane, kSparseDepth lookups in flight,
//       the rows of the round after next prefetched into L2: the hottest
//       row is the critical path, as many rounds as its lookups / 32;
//     - each warm segment (up to kSparseWarm) by 32-vector column tile,
//       its lookups walked kSparseAhead rows at a time, their indices from
//       a window the lanes load together;
//     - each batch of up to kSparseSegs segments that holds a cold one (up
//       to kSparseCold lookups), by tile, its cold segments' lookups walked
//       in order across segment boundaries the same way: a Zipf stream's
//       low ids are its frequent ones, so without the lists the first
//       batches would walk hundreds of lookups each;
//     - every batch's empty segments' zeros, by tile, which wait on
//       nothing but the batch's ptrs load and keep HBM's write stream full
//       while the items above wait on their loads.
//     A warp takes its next item from a queue (one atomic an item), so the
//     warps that drew long items take fewer zero items.  Every element is
//     still summed from 0 in fp32 in lookup order and rounded once: the
//     bits of sls_kernel on the same CSR.
//   * Row offsets are computed in 64 bits: a stacked table can hold more than
//     2^31 elements.
//
// Plain C interface (loaded with ctypes).  Every entry point launches on the
// stream it is given, allocates nothing (the gather's grouping scratch is
// the caller's), and returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments the kernels do not take).

#include <algorithm>

#include "ember_common.cuh"
#include "ember_hopper.cuh"

namespace {

using ember::bulk_commit;
using ember::bulk_load;
using ember::bulk_store;
using ember::bulk_wait;
using ember::bulk_wait_read;
using ember::kMaxBlockThreads;
using ember::mbar_expect_tx;
using ember::mbar_init;
using ember::mbar_init_fence;
using ember::mbar_wait;
using ember::RowAccess;
using ember::set_smem;
using ember::smem_u32;
using ember::to_float;
using ember::valid_block;
using ember::Vec16;

constexpr int kAddSum = 0;
constexpr int kAddMax = 1;
constexpr int kAddMin = 2;
constexpr int kMulMul = 0;
constexpr int kMulAdd = 1;
constexpr int kUnroll = 4;

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


// ---------------------------------------------------------------------------
// Block gather, bulk variant: grouping pre-pass, then the bulk copy
// ---------------------------------------------------------------------------

constexpr int kGroupThreads = 256;
constexpr long long kGatherMaxBlocks = 1LL << 30;  // 2 G slots fit 32 bits
constexpr int kGatherStages = 8;       // the ring of one warp
constexpr int kGatherAhead = 4;        // loads issued ahead of the stores
constexpr int kGatherMaxChunk = 8192;  // bytes of one stage
constexpr int kGatherBarBytes = 128;   // the ring's mbarriers, then stages
constexpr int kGatherPerItem = 32;     // output positions of one work item
constexpr unsigned int kFull = 0xffffffffu;

// One work item of the copy: a distinct block, by its index in the table,
// and a range of at most kGatherPerItem of its output positions in `order`.
struct __align__(16) GatherGroup {
  long long block;
  int start;
  int count;
};

// The grouping scratch, carved from one caller buffer of `bytes` bytes; the
// first `zero_bytes` (counter, keys, counts) are cleared before each pass.
struct GatherScratch {
  unsigned long long* counter;  // work items << 32 | positions ranged
  unsigned long long* keys;     // per slot: block + 1, 0 when empty
  int* cnt;                     // per slot: the block's output positions
  int* start;                   // per slot: the first of its range
  int* slot_of;                 // per g: its slot
  int* rank;                    // per g: its place in the block's range
  int* order;                   // the g's, grouped by block
  GatherGroup* groups;          // the work items (at most one per g)
  long long zero_bytes;
  long long bytes;
  int slot_bits;                // 2^slot_bits >= 2 G slots
};

inline GatherScratch gather_scratch(void* base, long long g) {
  GatherScratch sc;
  sc.slot_bits = 5;
  while ((1LL << sc.slot_bits) < 2 * g) ++sc.slot_bits;
  const long long slots = 1LL << sc.slot_bits;
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  long long off = 0;
  auto take = [&](long long bytes) {
    const uintptr_t at = p + (uintptr_t)off;
    off += (bytes + 15) & ~15LL;
    return at;
  };
  sc.counter = reinterpret_cast<unsigned long long*>(take(8));
  sc.keys = reinterpret_cast<unsigned long long*>(take(8 * slots));
  sc.cnt = reinterpret_cast<int*>(take(4 * slots));
  sc.zero_bytes = off;
  sc.start = reinterpret_cast<int*>(take(4 * slots));
  sc.slot_of = reinterpret_cast<int*>(take(4 * g));
  sc.rank = reinterpret_cast<int*>(take(4 * g));
  sc.order = reinterpret_cast<int*>(take(4 * g));
  sc.groups = reinterpret_cast<GatherGroup*>(take(16 * g));
  sc.bytes = off;
  return sc;
}

__device__ __forceinline__ uint32_t slot_hash(unsigned long long key,
                                              int bits) {
  return (uint32_t)((key * 0x9E3779B97F4A7C15ull) >> (64 - bits));
}

// Pass 1, per g: find or claim the slot of block idxs[g] + roff[g] (linear
// probing), then take a rank among the g's of that block.
__global__ void __launch_bounds__(kGroupThreads)
group_insert_kernel(const int* __restrict__ idxs, const int* __restrict__ roff,
                    long long num_blocks, unsigned long long* keys, int* cnt,
                    int* __restrict__ slot_of, int* __restrict__ rank,
                    int slot_bits) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = g < num_blocks;
  const uint32_t mask = (1u << slot_bits) - 1u;
  uint32_t slot = kFull;  // never a slot: lanes past the end group apart
  if (valid) {
    const long long block =
        (long long)idxs[g] + (roff != nullptr ? (long long)roff[g] : 0LL);
    const unsigned long long want = (unsigned long long)block + 1ull;
    uint32_t s = slot_hash((unsigned long long)block, slot_bits);
    for (;;) {
      unsigned long long cur =
          *reinterpret_cast<volatile unsigned long long*>(keys + s);
      if (cur == 0ull) cur = atomicCAS(keys + s, 0ull, want);
      if (cur == 0ull || cur == want) break;  // claimed, or found
      s = (s + 1u) & mask;
    }
    slot = s;
  }
  // the warp's g's of one block take their ranks with one atomic
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t peers = __match_any_sync(kFull, slot);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (valid && (int)lane == leader) base = atomicAdd(cnt + slot, __popc(peers));
  base = __shfl_sync(kFull, base, leader);
  if (valid) {
    slot_of[g] = (int)slot;
    rank[g] = base + __popc(peers & ((1u << lane) - 1u));
  }
}

// Pass 2, per slot: give each distinct block a range of output positions
// and its work items, one per kGatherPerItem positions (one atomic per warp
// on the packed counter).
__global__ void __launch_bounds__(kGroupThreads)
group_range_kernel(const unsigned long long* __restrict__ keys,
                   const int* __restrict__ cnt, int* __restrict__ start,
                   GatherGroup* __restrict__ groups,
                   unsigned long long* counter, long long slots) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int c = s < slots ? cnt[s] : 0;
  const int n = (c + kGatherPerItem - 1) / kGatherPerItem;
  int incl_n = n;
  int incl_c = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int tn = __shfl_up_sync(kFull, incl_n, o);
    const int tc = __shfl_up_sync(kFull, incl_c, o);
    if (lane >= o) {
      incl_n += tn;
      incl_c += tc;
    }
  }
  unsigned long long base = 0ull;
  if (lane == 31 && incl_n > 0) {
    base = atomicAdd(counter, ((unsigned long long)incl_n << 32) |
                                  (unsigned long long)(unsigned int)incl_c);
  }
  base = __shfl_sync(kFull, base, 31);
  if (c > 0) {
    const int first = (int)(base & 0xffffffffull) + incl_c - c;
    const long long item = (long long)(base >> 32) + incl_n - n;
    const long long block = (long long)(keys[s] - 1ull);
    start[s] = first;
    for (int k = 0; k < n; ++k) {
      groups[item + k] =
          GatherGroup{block, first + k * kGatherPerItem,
                      min(kGatherPerItem, c - k * kGatherPerItem)};
    }
  }
}

// Pass 3, per g: its place in its block's range.
__global__ void __launch_bounds__(kGroupThreads)
group_scatter_kernel(const int* __restrict__ start,
                     const int* __restrict__ slot_of,
                     const int* __restrict__ rank, int* __restrict__ order,
                     long long num_blocks) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < num_blocks) order[start[slot_of[g]] + rank[g]] = (int)g;
}

// One work item of the copy in one chunk of its block, as one lane holds
// it; lanes past the block's items hold count 0.
struct GatherItem {
  long long src;  // byte offset of the chunk in the table
  long long off;  // byte offset of the chunk in its block
  int bytes;
  int start;
  int count;
  int first;      // order[start], loaded with the item
};

__device__ __forceinline__ GatherItem gather_item(
    const GatherGroup* __restrict__ groups, const int* __restrict__ order,
    long long w, long long block_bytes, int chunk, int n_chunks) {
  const long long u = w / n_chunks;
  const int4 v = __ldg(reinterpret_cast<const int4*>(groups) + u);
  const long long block =
      (long long)(((unsigned long long)(unsigned int)v.y << 32) |
                  (unsigned long long)(unsigned int)v.x);
  GatherItem it;
  it.off = (w - u * n_chunks) * chunk;
  it.src = block * block_bytes + it.off;
  it.bytes = (int)min((long long)chunk, block_bytes - it.off);
  it.start = v.z;
  it.count = v.w;
  it.first = __ldg(order + v.z);
  return it;
}

// Persistent one-warp blocks over the work items w = blockIdx.x + k *
// gridDim.x.  Item k uses stage k % S: lane 0 loads it L items ahead; all
// lanes store it to its output positions.  Before stage (k + L) % S is
// loaded again, every lane waits until at most S - L - 1 of its store
// groups (one per item, committed even when empty) still read shared
// memory, so the stores of item k + L - S have read the stage.  Loads and
// stores are both async-proxy operations, ordered by that wait and the
// warp barrier; no thread reads or writes a stage itself.
template <int S, int L>
__global__ void __launch_bounds__(32)
gather_bulk_kernel(const uint8_t* __restrict__ table,
                   uint8_t* __restrict__ out,
                   const GatherGroup* __restrict__ groups,
                   const int* __restrict__ order,
                   const unsigned long long* __restrict__ counter,
                   long long block_bytes, int chunk, int n_chunks) {
  static_assert(L >= 1 && L < S && L < 32, "loads ahead: within the ring");
  extern __shared__ __align__(128) uint8_t gather_smem[];
  const uint32_t bars = smem_u32(gather_smem);
  const uint32_t ring = bars + kGatherBarBytes;
  const int lane = threadIdx.x;
  const long long items = (long long)(counter[0] >> 32) * n_chunks;
  if ((long long)blockIdx.x >= items) return;
  const long long mine = (items - 1 - blockIdx.x) / gridDim.x + 1;
  if (lane == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, 1);
    mbar_init_fence();
  }
  __syncwarp();

  // lane j holds item batch + j of `cur` and batch + 32 + j of `nxt`
  auto item_at = [&](long long k) {
    GatherItem it{0, 0, 0, 0, 0, 0};
    if (k < mine) {
      it = gather_item(groups, order, blockIdx.x + k * gridDim.x,
                       block_bytes, chunk, n_chunks);
    }
    return it;
  };
  long long batch = 0;
  GatherItem cur = item_at(lane);
  GatherItem nxt = item_at(32 + lane);
  auto issue = [&](long long k) {
    const bool later = k >= batch + 32;
    const int j = (int)(k & 31);
    const long long src = __shfl_sync(kFull, later ? nxt.src : cur.src, j);
    const int bytes = __shfl_sync(kFull, later ? nxt.bytes : cur.bytes, j);
    if (lane == 0) {
      const uint32_t st = (uint32_t)(k % S);
      mbar_expect_tx(bars + 8 * st, (uint32_t)bytes);
      bulk_load(ring + st * (uint32_t)chunk, table + src, (uint32_t)bytes,
                bars + 8 * st);
    }
  };
  for (long long k = 0; k < mine && k < L; ++k) issue(k);
  for (long long k = 0; k < mine; ++k) {
    if (k == batch + 32) {
      batch = k;
      cur = nxt;
      nxt = item_at(k + 32 + lane);
    }
    if (k + L < mine) {
      bulk_wait_read<S - L - 1>();
      __syncwarp();
      issue(k + L);
    }
    const uint32_t st = (uint32_t)(k % S);
    mbar_wait(bars + 8 * st, (uint32_t)((k / S) & 1));
    const int j = (int)(k & 31);
    const long long off = __shfl_sync(kFull, cur.off, j);
    const int bytes = __shfl_sync(kFull, cur.bytes, j);
    const int start = __shfl_sync(kFull, cur.start, j);
    const int count = __shfl_sync(kFull, cur.count, j);
    const int first = __shfl_sync(kFull, cur.first, j);
    const uint32_t src = ring + st * (uint32_t)chunk;
    for (int i = lane; i < count; i += 32) {
      const int g = i == 0 ? first : __ldg(order + start + i);
      bulk_store(out + (long long)g * block_bytes + off, src,
                 (uint32_t)bytes);
    }
    bulk_commit();
  }
  bulk_wait<0>();
}

// ---------------------------------------------------------------------------
// SLS, sparse variant: an unweighted sum over mostly empty segments
// ---------------------------------------------------------------------------

constexpr int kSparseThreads = 256;
constexpr int kSparseCold = 4;      // a cold segment's lookups, at most
constexpr int kSparseWarm = 32;     // a warm segment's lookups, at most
constexpr int kSparseHotter = 256;  // past this, the first hot list
constexpr int kSparseDepth = 32;    // a hot slice's lookups in flight
constexpr int kSparseAhead = 8;     // a walk's lookups in flight
constexpr int kSparseSegs = 32;     // segments of a batch, at most

template <typename T> struct SparseUnits;

template <> struct SparseUnits<float> {
  static constexpr int kVec = 4;   // elements of a 16-byte vector
  static constexpr int kUnit = 1;  // elements of a 4-byte unit
  __device__ __forceinline__ static void add_vec(float* acc, uint4 r) {
    acc[0] += __uint_as_float(r.x);
    acc[1] += __uint_as_float(r.y);
    acc[2] += __uint_as_float(r.z);
    acc[3] += __uint_as_float(r.w);
  }
  __device__ __forceinline__ static void add_unit(float* acc, uint32_t r) {
    acc[0] += __uint_as_float(r);
  }
  __device__ __forceinline__ static uint32_t pack_unit(const float* acc) {
    return __float_as_uint(acc[0]);
  }
};

template <> struct SparseUnits<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kUnit = 2;
  __device__ __forceinline__ static void add_unit(float* acc, uint32_t r) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
    acc[0] += f.x;
    acc[1] += f.y;
  }
  __device__ __forceinline__ static void add_vec(float* acc, uint4 r) {
    add_unit(acc, r.x);
    add_unit(acc + 2, r.y);
    add_unit(acc + 4, r.z);
    add_unit(acc + 6, r.w);
  }
  __device__ __forceinline__ static uint32_t pack_unit(const float* acc) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(acc[0], acc[1]);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
};

// The plan's lists, each in any order (every entry's rows are summed by
// its own work items, so the order moves no bit): 0, hot segments of more
// than kSparseHotter lookups; 1, hot segments of more than kSparseWarm; 2,
// warm segments (more than kSparseCold); 3, the batches holding a cold
// segment (seg: the batch's index).  Their items run in this order, so the
// longest start first.
constexpr int kLists = 4;

__host__ __device__ constexpr int list_floor(int list) {
  return list == 0 ? kSparseHotter : list == 1 ? kSparseWarm : kSparseCold;
}

struct __align__(16) SparseEntry {
  int seg;
  int beg;
  int end;
  int pad;
};

// The plan, carved from the caller's scratch: the lists' counts and the
// work queue's next item (32 bytes), then list i of cap[i] entries.
struct SparsePlan {
  int* count;
  unsigned int* next;
  SparseEntry* list[kLists];
  long long cap[kLists];
  long long bytes;
};

inline SparsePlan sparse_plan(void* scratch, long long num_segments,
                              long long lookups) {
  SparsePlan h{};
  const uintptr_t base = reinterpret_cast<uintptr_t>(scratch);
  h.count = reinterpret_cast<int*>(base);
  h.next = reinterpret_cast<unsigned int*>(base) + kLists;
  long long off = 32;
  for (int i = 0; i < kLists; ++i) {
    const long long most =
        i < kLists - 1 ? lookups / (list_floor(i) + 1) : lookups;
    h.cap[i] = std::max(0LL, std::min(num_segments, most));
    h.list[i] = reinterpret_cast<SparseEntry*>(base + (uintptr_t)off);
    off += 16 * h.cap[i];
  }
  h.bytes = off;
  return h;
}

// Appends the lanes' entries (where want) to list i with one atomic a warp.
__device__ __forceinline__ void plan_append(const SparsePlan& h, int i,
                                            bool want, SparseEntry e) {
  const unsigned int mask = __ballot_sync(kFull, want);
  if (mask == 0u) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(h.count + i, __popc(mask));
  base = __shfl_sync(kFull, base, leader);
  const long long at = base + __popc(mask & ((1u << lane) - 1u));
  if (want && at < h.cap[i]) h.list[i][at] = e;
}

// One thread a segment: the hot and warm segments into lists 0-2, and the
// batches of seg_per_batch segments (a power of two up to 32, so a batch
// lies in one warp) that hold a cold segment into list 3.
__global__ void __launch_bounds__(kSparseThreads)
sls_sparse_plan_kernel(const int* __restrict__ ptrs, long long num_segments,
                       int seg_per_batch, SparsePlan h) {
  const long long s = (long long)blockIdx.x * kSparseThreads + threadIdx.x;
  const int beg = s < num_segments ? __ldg(ptrs + s) : 0;
  const int end = s < num_segments ? __ldg(ptrs + s + 1) : 0;
  const int len = end - beg;
  const SparseEntry e{(int)s, beg, end, 0};
#pragma unroll
  for (int i = 0; i < kLists - 1; ++i) {
    plan_append(h, i, len > list_floor(i) &&
                      (i == 0 || len <= list_floor(i - 1)), e);
  }
  const int lane = threadIdx.x & 31;
  const unsigned int cold =
      __ballot_sync(kFull, len > 0 && len <= kSparseCold);
  const unsigned int batch =
      seg_per_batch == 32 ? kFull : (1u << seg_per_batch) - 1u;
  plan_append(h, kLists - 1,
              lane % seg_per_batch == 0 && ((cold >> lane) & batch) != 0u,
              SparseEntry{(int)(s / seg_per_batch), 0, 0, 0});
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// A hot segment's column slice of 32 four-byte units, one a lane (128
// bytes of each row): its lookups in rounds of kSparseDepth loads in
// flight, summed in lookup order.  A round's loads would wait on HBM
// behind the zero stores, so the rows of the round after next are
// prefetched into L2 (lane l the line of lookup l) and the indices of the
// round after that loaded, each after the round's own loads are issued:
// nothing the round waits on was asked for in it.
template <typename T>
__device__ __forceinline__ void sparse_hot_slice(
    const T* __restrict__ table, const int* __restrict__ idxs,
    T* __restrict__ out, SparseEntry h, long long slice, long long row_units) {
  using U = SparseUnits<T>;
  const int lane = threadIdx.x & 31;
  const long long c = slice * 32 + lane;
  const bool ok = c < row_units;
  const uint32_t* __restrict__ line =
      reinterpret_cast<const uint32_t*>(table) + slice * 32;
  // every load is issued unconditionally (an idle lane of the last slice
  // reads the row's last unit, a lookup past the end repeats the last
  // one): a load under a condition makes the compiler wait for it before
  // the next is issued
  const uint32_t* __restrict__ src =
      reinterpret_cast<const uint32_t*>(table) + (ok ? c : row_units - 1);
  float acc[U::kUnit];
#pragma unroll
  for (int i = 0; i < U::kUnit; ++i) acc[i] = 0.0f;
  // lane l holds the l-th lookup of this round (gl), of the next (g1) and
  // of the one after (g2)
  static_assert(kSparseDepth == 32, "a round's lookups, one a lane");
  auto index = [&](int q) { return __ldg(idxs + min(q, h.end - 1)); };
  auto prefetch = [&](int g) {
    prefetch_l2(line + (long long)g * row_units);
  };
  int gl = index(h.beg + lane);
  int g1 = index(h.beg + kSparseDepth + lane);
  int g2 = index(h.beg + 2 * kSparseDepth + lane);
  prefetch(g1);
  for (int p = h.beg; p < h.end; p += kSparseDepth) {
    const int n = min(kSparseDepth, h.end - p);
    uint32_t v[kSparseDepth];
#pragma unroll
    for (int d = 0; d < kSparseDepth; ++d) {
      v[d] = __ldg(src + (long long)__shfl_sync(kFull, gl, d) * row_units);
    }
    prefetch(g2);
    gl = g1;
    g1 = g2;
    g2 = index(p + 3 * kSparseDepth + lane);
#pragma unroll
    for (int d = 0; d < kSparseDepth; ++d) {
      if (d < n) U::add_unit(acc, v[d]);
    }
  }
  if (ok) {
    reinterpret_cast<uint32_t*>(out)[(long long)h.seg * row_units + c] =
        U::pack_unit(acc);
  }
}

// The walk of sparse_batch_item: the cold segments (bit s of cold: segment
// s of the item, its lookups [pl, nxt) of lane s) summed into dst's rows.
template <typename T>
__device__ __forceinline__ void sparse_cold_walk(
    const T* __restrict__ table, const int* __restrict__ idxs,
    T* __restrict__ dst, long long emb_len, bool ok, long long col, int pl,
    int nxt, int pend, unsigned int cold) {
  using U = SparseUnits<T>;
  constexpr int kW = U::kVec;
  const int lane = threadIdx.x & 31;
  int seg = __ffs(cold) - 1;
  cold &= cold - 1u;
  int p = __shfl_sync(kFull, pl, seg);
  int seg_end = __shfl_sync(kFull, nxt, seg);
  int wbase = p;  // the window: lane l holds idxs[wbase + l]
  int gw = __ldg(idxs + p + min(lane, pend - 1 - p));
  // every row load is issued unconditionally (an idle lane reads the row's
  // last vector, an empty slot the group's first row again): a load under a
  // condition makes the compiler wait for it before the next is issued
  const T* __restrict__ rows = table + (ok ? col : emb_len - kW);
  float acc[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) acc[k] = 0.0f;
  int cur = seg;
  bool more = true;
  while (more) {
    int sg[kSparseAhead];
    int g[kSparseAhead];
    bool valid[kSparseAhead];
    bool outside = false;  // a slot past the window (a skipped segment)
    int mine = 0;          // lane u: slot u's position
#pragma unroll
    for (int u = 0; u < kSparseAhead; ++u) {
      if (p == seg_end && cold != 0u) {  // the next cold segment
        seg = __ffs(cold) - 1;
        cold &= cold - 1u;
        p = __shfl_sync(kFull, pl, seg);
        seg_end = __shfl_sync(kFull, nxt, seg);
      }
      valid[u] = p < seg_end;
      sg[u] = seg;
      const int j = p - wbase;
      g[u] = __shfl_sync(kFull, gw, j & 31);
      outside |= valid[u] && (j < 0 || j >= 32);
      if (lane == u) mine = p;
      if (valid[u]) ++p;
    }
    if (!valid[0]) break;
    if (outside) {  // rare: the slots' indices loaded one a lane
      const int q = __ldg(idxs + min(mine, pend - 1));
#pragma unroll
      for (int u = 0; u < kSparseAhead; ++u) {
        g[u] = __shfl_sync(kFull, q, u);
      }
    }
#pragma unroll
    for (int u = 1; u < kSparseAhead; ++u) {
      if (!valid[u]) g[u] = g[0];
    }
    more = valid[kSparseAhead - 1];
    if (more && p - wbase >= 32 - kSparseAhead) {  // slide the window
      wbase = p;
      gw = __ldg(idxs + p + min(lane, pend - 1 - p));
    }
    uint4 r[kSparseAhead];
#pragma unroll
    for (int u = 0; u < kSparseAhead; ++u) {
      r[u] = __ldg(reinterpret_cast<const uint4*>(
          rows + (long long)g[u] * emb_len));
    }
#pragma unroll
    for (int u = 0; u < kSparseAhead; ++u) {
      if (valid[u]) {
        if (sg[u] != cur) {
          if (ok) Vec16<T>::store(dst + cur * emb_len, acc);
#pragma unroll
          for (int k = 0; k < kW; ++k) acc[k] = 0.0f;
          cur = sg[u];
        }
        U::add_vec(acc, r[u]);
      }
    }
  }
  if (ok) Vec16<T>::store(dst + cur * emb_len, acc);
}

// A batch item: the segments [s0, s0 + ns), from the item's one ptrs load.
// WALK: in one column tile of 32 16-byte vectors (one a lane), the cold
// nonempty segments' lookups walked in order (sparse_cold_walk), hot
// segments skipped, each segment summed from 0 in fp32 and stored once.
// Else, in that tile, the empty segments' zeros, which wait on no other
// load: a warp that takes such an item keeps the store stream full while
// others wait on their loads.
template <typename T, bool WALK>
__device__ __forceinline__ void sparse_batch_item(
    const T* __restrict__ table, const int* __restrict__ ptrs,
    const int* __restrict__ idxs, T* __restrict__ out, long long s0, int ns,
    long long tile, long long row_vecs) {
  constexpr int kW = SparseUnits<T>::kVec;
  const int lane = threadIdx.x & 31;
  const long long emb_len = row_vecs * kW;
  const long long cv = tile * 32 + lane;
  const bool ok = cv < row_vecs;
  const long long col = cv * kW;
  // lane l holds ptrs[s0 + l] (l <= ns); pend = ptrs[s0 + ns]
  const int pl = __ldg(ptrs + s0 + min(lane, ns));
  const int pend = __ldg(ptrs + s0 + ns);
  int nxt = __shfl_down_sync(kFull, pl, 1);
  if (lane == 31) nxt = pend;
  const int len = lane < ns ? nxt - pl : 0;
  T* __restrict__ dst = out + s0 * emb_len + col;
  if constexpr (WALK) {
    const unsigned int cold =
        __ballot_sync(kFull, len > 0 && len <= kSparseCold);
    if (cold != 0u) {
      sparse_cold_walk<T>(table, idxs, dst, emb_len, ok, col, pl, nxt, pend,
                          cold);
    }
  } else {
    for (unsigned int m = __ballot_sync(kFull, lane < ns && len == 0);
         m != 0u; m &= m - 1u) {
      if (ok) {
        *reinterpret_cast<uint4*>(dst + (__ffs(m) - 1) * emb_len) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
}

// Persistent warps over the work items, in order: the hot lists' slices,
// the warm segments' walks and the listed batches' walks, then every
// batch's zeros, the last three by 32-vector column tile.
template <typename T>
__global__ void __launch_bounds__(kSparseThreads)
sls_sparse_kernel(const T* __restrict__ table, const int* __restrict__ ptrs,
                  const int* __restrict__ idxs, T* __restrict__ out,
                  SparsePlan h, long long num_segments, long long row_vecs,
                  int tiles, int seg_per_batch, long long batches) {
  static_assert(kLists == 4, "the lists' items are told apart below");
  const long long row_units = row_vecs * 4;
  const long long slices = (row_units + 31) / 32;
  long long listed[kLists];
#pragma unroll
  for (int i = 0; i < kLists; ++i) {
    listed[i] = min((long long)__ldg(h.count + i), h.cap[i]);
  }
  const long long end0 = listed[0] * slices;
  const long long end1 = end0 + listed[1] * slices;
  const long long walk0 = end1 + listed[2] * tiles;
  const long long zero0 = walk0 + listed[3] * tiles;
  const long long items = zero0 + batches * tiles;
  // Warp w of block b starts with item w * gridDim.x + b (neighbouring
  // items, a hot segment's slices, on different SMs, whose memory pipes
  // each keep only so many loads in flight), then takes the queue's next
  // item whenever it is done with one (asked for before the current one
  // runs): the warps that drew a hot slice take fewer zero items.
  const long long warps = ((long long)gridDim.x * kSparseThreads) >> 5;
  const int lane = threadIdx.x & 31;
  const long long emb_len = row_vecs * SparseUnits<T>::kVec;
  long long item = (long long)(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  while (item < items) {
    const long long ahead =
        lane == 0 ? warps + (long long)atomicAdd(h.next, 1u) : 0LL;
    if (item < end1) {
      const bool first = item < end0;
      const long long k = item - (first ? 0 : end0);
      const int4* list = reinterpret_cast<const int4*>(h.list[first ? 0 : 1]);
      const int4 e = __ldg(list + k / slices);
      sparse_hot_slice<T>(table, idxs, out, SparseEntry{e.x, e.y, e.z, 0},
                          k % slices, row_units);
    } else if (item < walk0) {
      const long long k = item - end1;
      const int4 e =
          __ldg(reinterpret_cast<const int4*>(h.list[2]) + k / tiles);
      const long long cv = (k % tiles) * 32 + lane;
      const long long col = cv * SparseUnits<T>::kVec;
      sparse_cold_walk<T>(table, idxs, out + (long long)e.x * emb_len + col,
                          emb_len, cv < row_vecs, col, e.y, e.z, e.z, 1u);
    } else if (item < zero0) {
      const long long k = item - walk0;
      const long long s0 =
          (long long)__ldg(&h.list[3][k / tiles].seg) * seg_per_batch;
      sparse_batch_item<T, true>(
          table, ptrs, idxs, out, s0,
          (int)min((long long)seg_per_batch, num_segments - s0), k % tiles,
          row_vecs);
    } else {
      const long long z = item - zero0;
      const long long s0 = (z / tiles) * seg_per_batch;
      sparse_batch_item<T, false>(
          table, ptrs, idxs, out, s0,
          (int)min((long long)seg_per_batch, num_segments - s0), z % tiles,
          row_vecs);
    }
    item = __shfl_sync(kFull, ahead, 0);
  }
}

// Resident blocks of a kernel on the current device, looked up once a
// device.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, long long* blocks) {
  static int cached[64] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    int sms = 0;
    int per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
    if (err != cudaSuccess) return err;
    cached[device] = sms * std::max(per_sm, 1);
  }
  *blocks = cached[device];
  return cudaSuccess;
}

template <typename T>
int launch_sls_sparse(const void* table, const int* ptrs, const int* idxs,
                      void* out, void* scratch, long long num_segments,
                      long long emb_len, long long lookups,
                      cudaStream_t s) {
  constexpr int kW = SparseUnits<T>::kVec;
  if (emb_len % kW != 0) return (int)cudaErrorInvalidValue;
  const long long row_vecs = emb_len / kW;
  const long long tiles_ll = (row_vecs + 31) / 32;
  if (tiles_ll > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int tiles = (int)tiles_ll;
  auto kernel = sls_sparse_kernel<T>;
  long long resident = 0;
  cudaError_t err = resident_blocks(kernel, kSparseThreads, &resident);
  if (err != cudaSuccess) return (int)err;
  // fewer segments a batch while the batches' walks would not fill the
  // card twice over
  int seg_per_batch = kSparseSegs;
  const long long per_block = kSparseThreads / 32;
  const long long warps = resident * per_block;
  while (seg_per_batch > 1 &&
         (num_segments + seg_per_batch - 1) / seg_per_batch * tiles <
             2 * warps) {
    seg_per_batch /= 2;
  }
  const long long batches =
      (num_segments + seg_per_batch - 1) / seg_per_batch;
  const SparsePlan h = sparse_plan(scratch, num_segments, lookups);
  const long long slices = (row_vecs * 4 + 31) / 32;
  const long long most = (h.cap[0] + h.cap[1]) * slices +
                         (h.cap[2] + h.cap[3]) * tiles + batches * tiles;
  if (most + warps > 0xffffffffLL) {  // the queue's counter
    return (int)cudaErrorInvalidValue;
  }
  err = cudaMemsetAsync(h.count, 0, 32, s);
  if (err != cudaSuccess) return (int)err;
  sls_sparse_plan_kernel<<<(unsigned int)((num_segments + kSparseThreads -
                                            1) / kSparseThreads),
                           kSparseThreads, 0, s>>>(ptrs, num_segments,
                                                   seg_per_batch, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // enough warps for every item, at most the resident ones
  const long long blocks =
      std::max(1LL, std::min(resident, (most + per_block - 1) / per_block));
  kernel<<<(unsigned int)blocks, kSparseThreads, 0, s>>>(
      static_cast<const T*>(table), ptrs, idxs, static_cast<T*>(out), h,
      num_segments, row_vecs, tiles, seg_per_batch, batches);
  return (int)cudaGetLastError();
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

// Bytes of the sparse variant's scratch (the hot segments' list).
extern "C" long long ember_sls_sparse_scratch_bytes(long long num_segments,
                                                    long long lookups) {
  if (num_segments <= 0 || lookups < 0) return 0;
  return sparse_plan(nullptr, num_segments, lookups).bytes;
}

// ember_sls's sparse variant: out[b] = sum over p in [ptrs[b], ptrs[b+1])
// of table[idxs[p]], unweighted, no seg_base, each segment summed in fp32
// in p order and rounded once (ember_sls's bits on the same CSR).  Rows of
// whole 16-byte vectors; table and out 16-byte aligned; lookups: the length
// of idxs; scratch: ember_sls_sparse_scratch_bytes bytes, 16-byte aligned.
extern "C" int ember_sls_sparse(const void* table, const void* ptrs,
                                const void* idxs, void* out, void* scratch,
                                long long num_segments, long long emb_len,
                                long long lookups, int dtype, void* stream) {
  if (num_segments <= 0 || num_segments >= 0x7fffffffLL || emb_len <= 0 ||
      lookups < 0 || (dtype != 0 && dtype != 1) || table == nullptr ||
      ptrs == nullptr || out == nullptr || scratch == nullptr ||
      ((uintptr_t)table | (uintptr_t)out | (uintptr_t)scratch) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(ptrs);
  const int* ids = static_cast<const int*>(idxs);
  if (dtype == 0) {
    return launch_sls_sparse<float>(table, p, ids, out, scratch,
                                    num_segments, emb_len, lookups, s);
  }
  return launch_sls_sparse<__nv_bfloat16>(table, p, ids, out, scratch,
                                          num_segments, emb_len, lookups, s);
}

// The block gather, rows variant.  unit_bytes: 16 (uint4 vectors), 4 or 2
// (one element); row_bytes must be a multiple of it, and table / out aligned
// to it.
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

// Bytes of the grouping scratch for num_blocks lookups (0 when there are
// more than the kernels take).
extern "C" long long ember_gather_scratch_bytes(long long num_blocks) {
  if (num_blocks <= 0 || num_blocks > kGatherMaxBlocks) return 0;
  return gather_scratch(nullptr, num_blocks).bytes;
}

// The bulk gather's grouping pre-pass: groups the lookups idxs[g] + roff[g]
// (roff may be null) by block into `scratch` (ember_gather_scratch_bytes
// bytes, 16-byte aligned), for ember_block_gather_bulk.
extern "C" int ember_gather_group(const void* idxs, const void* roff,
                                  void* scratch, long long num_blocks,
                                  void* stream) {
  if (num_blocks <= 0 || num_blocks > kGatherMaxBlocks || idxs == nullptr ||
      scratch == nullptr || (uintptr_t)scratch % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const GatherScratch sc = gather_scratch(scratch, num_blocks);
  const long long slots = 1LL << sc.slot_bits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)sc.zero_bytes, s);
  if (err != cudaSuccess) return (int)err;
  const unsigned int per_g =
      (unsigned int)((num_blocks + kGroupThreads - 1) / kGroupThreads);
  const unsigned int per_slot =
      (unsigned int)((slots + kGroupThreads - 1) / kGroupThreads);
  const int* ids = static_cast<const int*>(idxs);
  group_insert_kernel<<<per_g, kGroupThreads, 0, s>>>(
      ids, static_cast<const int*>(roff), num_blocks, sc.keys, sc.cnt,
      sc.slot_of, sc.rank, sc.slot_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_range_kernel<<<per_slot, kGroupThreads, 0, s>>>(
      sc.keys, sc.cnt, sc.start, sc.groups, sc.counter, slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_scatter_kernel<<<per_g, kGroupThreads, 0, s>>>(
      sc.start, sc.slot_of, sc.rank, sc.order, num_blocks);
  return (int)cudaGetLastError();
}

// The bulk gather: out[g] = table block idxs[g] + roff[g], each block of
// block_bytes bytes (a multiple of 16; table and out 16-byte aligned), over
// the groups ember_gather_group left in `scratch`.
extern "C" int ember_block_gather_bulk(const void* table, void* out,
                                       const void* scratch,
                                       long long num_blocks,
                                       long long block_bytes, void* stream) {
  if (num_blocks <= 0 || num_blocks > kGatherMaxBlocks || block_bytes <= 0 ||
      block_bytes % 16 != 0 || table == nullptr || out == nullptr ||
      scratch == nullptr ||
      ((uintptr_t)table | (uintptr_t)out | (uintptr_t)scratch) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const GatherScratch sc =
      gather_scratch(const_cast<void*>(scratch), num_blocks);
  const int chunk = (int)std::min(block_bytes, (long long)kGatherMaxChunk);
  const long long n_chunks = (block_bytes + chunk - 1) / chunk;
  if (n_chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = kGatherBarBytes + kGatherStages * chunk;
  auto kernel = gather_bulk_kernel<kGatherStages, kGatherAhead>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  // as many resident one-warp blocks as fit, no more than there are items
  long long blocks = (long long)sms * std::max(per_sm, 1);
  blocks = std::min(blocks, num_blocks * n_chunks);
  kernel<<<(unsigned int)blocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), static_cast<uint8_t*>(out),
      sc.groups, sc.order, sc.counter, block_bytes, chunk, (int)n_chunks);
  return (int)cudaGetLastError();
}
