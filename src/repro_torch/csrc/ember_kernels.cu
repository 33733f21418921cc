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
