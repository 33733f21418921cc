"""DAE machine-balance cost model (paper §3, §8.1 — Figs 6, 7, 16, 17).

We cannot run gem5+McPAT here, so the paper's *hardware* results are
reproduced with a first-principles queue-balance model of the abstract DAE
machine (Fig 9): the achieved throughput of an embedding operation is the
minimum of

  * the **execute-unit** rate at which tokens/operands can be popped and
    computed,
  * the **access-unit** rate at which the traversal engine can generate
    addresses and marshal operands into the queues, and
  * the **memory** rate allowed by outstanding-request capacity
    (Little's law: requests/s = outstanding / effective latency, with the
    effective latency set by the reuse-distance hit probability).

Cycle-level constants are derived from the paper's structure and calibrated
once against its published ratios (Fig 16: emb-opt3/emb-opt0 = 6.6× / 12.1×
/ 21× for RM1/RM2/RM3; vectorization ≈ 5.13× with 17% deviation; Fig 6:
TMU ≈ 5.7× requests/s of a core; Fig 7 geomean 5.8×).  The *model shape* is
what matters: per-element token+pop costs at O0, per-chunk at O1,
per-lookup at O2/O3, with the access-side per-lookup traversal overhead
(index load + token push) as the O3 floor.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .ops import EmbeddingOp

# SVE-512 f32 vector length used throughout the paper's evaluation.
VLEN = 16


@dataclasses.dataclass(frozen=True)
class Machine:
    """Cycle/structure constants of the DAE processor under study (§3.1)."""
    freq_ghz: float = 2.0
    # execute unit (superscalar SIMD core), cycles amortized per unit of work
    c_elem_scalar: float = 1.0    # O0: pipelined pop+pop+pop+fma per element
    c_chunk_vector: float = 3.12  # O1: token + 2 scalar pops + vpop + vfma
    c_row_token: float = 1.6      # O2: per-row token pop + row-id pop
    c_chunk_buffered: float = 0.7 # O2/O3: fused vpop+vfma per chunk (dual issue)
    # access unit (TMU dataflow traversal engine)
    h_lookup: float = 4.4         # per-lookup: idxs mem_str + loop_tr + token
    a_elem_scalar: float = 0.5    # O0 marshaling per element (3 pushes, pipelined)
    a_chunk: float = 0.21         # vectorized marshal per chunk
    # memory subsystem
    outstanding_tmu: int = 96     # TMU tracks ~8-10× the core's requests (§3.2)
    outstanding_core: int = 10
    lat_hbm_cycles: float = 180.0
    lat_cache_cycles: float = 16.0
    line_bytes: int = 64
    hbm_gbps: float = 450.0       # one HBM2 stack


DEFAULT = Machine()


def _chunks(emb_len: int) -> int:
    return -(-emb_len // VLEN)


def effective_latency(m: Machine, hit_rate: float) -> float:
    return hit_rate * m.lat_cache_cycles + (1 - hit_rate) * m.lat_hbm_cycles


def mem_cycles_per_lookup(op: EmbeddingOp, m: Machine, hit_rate: float,
                          outstanding: int) -> float:
    """Little's-law bound: cycles between completed row fetches per slot."""
    lines = max(1.0, op.emb_len * 4 / m.line_bytes)
    lam = effective_latency(m, hit_rate)
    return lines * lam / outstanding


def compute_cycles_per_lookup(op: EmbeddingOp, m: Machine, lvl: int) -> float:
    e = op.emb_len
    c = _chunks(e)
    flop_scale = max(1.0, op.compute_per_lookup)  # MP does 4 flops/element
    if not op.has_compute and lvl >= 3:
        return 0.0  # store streams: fully offloaded (§7.4)
    if lvl == 0:
        return e * m.c_elem_scalar * flop_scale
    if lvl == 1:
        return c * m.c_chunk_vector * flop_scale
    if lvl == 2:
        return m.c_row_token + c * m.c_chunk_buffered * flop_scale
    return 0.25 * m.c_row_token + c * m.c_chunk_buffered * flop_scale


def access_cycles_per_lookup(op: EmbeddingOp, m: Machine, lvl: int) -> float:
    e = op.emb_len
    c = _chunks(e)
    if lvl == 0:
        return m.h_lookup + e * m.a_elem_scalar
    if lvl == 1:
        return m.h_lookup + c * (m.a_chunk + 2 * m.a_elem_scalar / VLEN)
    # O2 still marshals the row id scalar; O3 drops it (queue alignment)
    extra = m.a_elem_scalar if lvl == 2 else 0.0
    return m.h_lookup + extra + c * m.a_chunk


def lookup_cycles(op: EmbeddingOp, lvl: int, hit_rate: float = 0.0,
                  m: Machine = DEFAULT, decoupled: bool = True) -> dict:
    """All three balance terms (cycles/lookup) + the binding bottleneck."""
    outstanding = m.outstanding_tmu if decoupled else m.outstanding_core
    comp = compute_cycles_per_lookup(op, m, lvl)
    acc = access_cycles_per_lookup(op, m, lvl)
    mem = mem_cycles_per_lookup(op, m, hit_rate, outstanding)
    if not decoupled:
        # traditional core: access + compute share one pipeline, and the
        # loop cannot run ahead — costs add instead of overlapping
        coupled = comp + acc
        total = max(coupled, mem)
        which = "core" if coupled >= mem else "memory"
        return {"compute": comp, "access": acc, "memory": mem,
                "total": total, "bottleneck": which}
    total = max(comp, acc, mem)
    which = ("compute" if total == comp else
             "access" if total == acc else "memory")
    return {"compute": comp, "access": acc, "memory": mem,
            "total": total, "bottleneck": which}


def throughput_eps(op: EmbeddingOp, lvl: int, hit_rate: float = 0.0,
                   m: Machine = DEFAULT, decoupled: bool = True) -> float:
    """Elements marshaled+computed per second."""
    t = lookup_cycles(op, lvl, hit_rate, m, decoupled)["total"]
    if t == 0.0:
        # fully offloaded store-stream path: memory-rate bound
        t = mem_cycles_per_lookup(op, m, hit_rate, m.outstanding_tmu)
    return op.emb_len * m.freq_ghz * 1e9 / t


def speedup_over_opt0(op: EmbeddingOp, lvl: int, hit_rate: float = 0.0,
                      m: Machine = DEFAULT) -> float:
    """Fig 16: emb-optN over emb-opt0."""
    return (throughput_eps(op, lvl, hit_rate, m) /
            throughput_eps(op, 0, hit_rate, m))


def dae_speedup_over_core(op: EmbeddingOp, hit_rate: float = 0.0,
                          m: Machine = DEFAULT) -> float:
    """Fig 7: optimized DAE code vs an optimized traditional core.

    The traditional-core baseline is the *fused, vectorized* loop (it has no
    queues to pay for), but it is limited by the core's outstanding-request
    capacity and cannot decouple traversal from compute.
    """
    core = throughput_eps(op, 1, hit_rate, m, decoupled=False)
    dae = throughput_eps(op, 3, hit_rate, m, decoupled=True)
    return dae / core


def requests_per_second(m: Machine = DEFAULT, decoupled: bool = True,
                        hit_rate: float = 0.0) -> float:
    """Fig 6a: sustainable memory requests/s of TMU vs core."""
    outstanding = m.outstanding_tmu if decoupled else m.outstanding_core
    lam = effective_latency(m, hit_rate)
    return outstanding / lam * m.freq_ghz * 1e9


# ---------------------------------------------------------------------------
# Batched-plan resource model (fusion partitioning, PR 2)
#
# A fused multi-table unit compiles to ONE batched KernelPlan whose on-chip
# working set grows with the group: the double-buffered row tiles and the
# output tile are fixed, but the scalar-prefetched access-stream operands
# (ptrs, idxs, roff, vals) are resident for the whole launch.  The fusion
# partitioner uses these estimates to fuse only groups that fit the budget
# and to split giant groups into sub-units balanced on *access* cycles (the
# serial resource of the DAE machine — the execute unit drains whatever the
# access stream feeds it, so skewed sub-units idle the narrow side).
# ---------------------------------------------------------------------------

#: Default budget for one batched plan's working set (row-tile double
#: buffers + output tile + access-stream operand arrays).  The value is the
#: reference compiler's default, kept unchanged so that this port's fusion
#: pass groups a program's ops into exactly the same units as the reference
#: does.  The Hopper kernels do not stage the access streams on chip, so this
#: number models no limit of the GPU; whether Hopper wants another budget is
#: open work (see ROADMAP.md).
VMEM_BUDGET_BYTES = 4 * 2 ** 20


@dataclasses.dataclass(frozen=True)
class FusionBudget:
    """Resource envelope the fusion partitioner must respect."""

    vmem_bytes: int = VMEM_BUDGET_BYTES
    num_buffers: int = 2          # DMA pipeline depth (KernelPlan default)
    #: target ceiling on access/execute cycle skew of one fused plan; groups
    #: above it are still legal (skew is reported, not enforced) — balance
    #: is what the partitioner optimizes when it has to split anyway.
    balance_target: float = 8.0
    #: vocab-shard count of the executor that will run the plan.  The budget
    #: is PER SHARD: sharding divides the per-device index/vals streams (and
    #: the stacked-table footprint) by S, so the partitioner splits far
    #: fewer groups.  Part of the compile-cache key via this dataclass.
    shards: int = 1
    #: per-table byte budget for the replicated hot slab of locality-aware
    #: hot/cold sharding (see :mod:`repro.core.access_plan`): the classified
    #: Zipf head of each vocab may replicate up to this many bytes per shard
    #: — lookups it absorbs pay zero exchange.  0 disables classification
    #: (:func:`~repro.core.access_plan.hot_rows_from_traces` sizes heads
    #: against it).  Part of the compile-cache key via this dataclass.
    hot_slab_bytes: int = 0


def lane_tile(emb_len: int, vlen: int) -> int:
    """THE column-tile choice of a KernelPlan (backend_pallas.make_plan
    calls this too — one definition, so the partitioner's VMEM audit can
    never drift from what the backend actually tiles)."""
    def up(x, m):
        return -(-x // m) * m
    return min(up(max(vlen, 128), 128), up(emb_len, 128))


def plan_tile_bytes(op: EmbeddingOp, vlen: int = 128,
                    num_buffers: int = 2) -> int:
    """Fixed VMEM of one batched plan: in-flight row tiles + output tile."""
    itemsize = 4  # f32 tiles (lower precision still DMA-pads to lanes)
    tile = lane_tile(op.emb_len, vlen)
    rows = op.block_rows if op.kind == "gather" else 1
    return (num_buffers + 1) * rows * tile * itemsize


def operand_bytes(op: EmbeddingOp, force_vals: bool = False,
                  shards: int = 1) -> int:
    """Scalar-prefetch (access stream) footprint of one member op: the CSR
    ``ptrs``, the expected ``idxs``/``vals`` nnz, and its ``roff`` slot.

    ``force_vals``: a mixed weighted/unweighted group unit-weight-upcasts,
    so EVERY member marshals a vals word per lookup — the group-level
    estimators pass ``group_needs_vals`` here so the audit counts what the
    fused plan actually prefetches.

    ``shards``: vocab-sharded execution re-emits the CSR per shard, so each
    shard still prefetches the full ``ptrs``/``roff`` control streams but
    only its ~1/S slice of the index/vals streams.
    """
    lookups = -(-expected_lookups(op) // max(shards, 1))
    words = op.num_segments + 1          # ptrs (kg: the degenerate arange)
    words += lookups                     # idxs
    words += op.num_segments             # roff entry per segment
    if force_vals or op.weighted or op.kind in ("spmm", "kg"):
        words += lookups                 # vals
    return words * 4


def group_needs_vals(ops) -> bool:
    """Does a fused group of ``ops`` marshal a vals stream (and hence
    unit-weight-upcast its unweighted members)?  Mirrors _build_group."""
    return any(op.weighted or op.kind in ("spmm", "kg") for op in ops)


def expected_lookups(op: EmbeddingOp) -> int:
    """Expected access-stream length (kg is one lookup per segment)."""
    if op.kind == "kg":
        return op.num_segments
    if op.kind == "gather":
        return op.num_segments
    return op.num_segments * max(op.avg_lookups, 1)


def access_weight(op: EmbeddingOp, lvl: int = 3, m: Machine = DEFAULT) -> float:
    """Total access-unit cycles this op contributes to a fused plan's
    (serial) traversal stream — the partitioner's balance weight."""
    return expected_lookups(op) * access_cycles_per_lookup(op, m, lvl)


def execute_weight(op: EmbeddingOp, lvl: int = 3, m: Machine = DEFAULT) -> float:
    return expected_lookups(op) * compute_cycles_per_lookup(op, m, lvl)


def table_bytes(op: EmbeddingOp, shards: int = 1) -> int:
    """Stacked-table rows this member contributes per shard (ceil-split of
    its vocab over ``shards`` — the layout of :mod:`repro.core.shard_plan`).
    Shared-table dedup happens at stack time; this is the audit's upper
    bound, consistent with :func:`operand_bytes`."""
    rows = -(-op.num_embeddings // max(shards, 1))
    blk = op.block_rows if op.kind == "gather" else 1
    return rows * blk * op.emb_len * np.dtype(op.dtype).itemsize


def exchange_bytes(ops, shards: int = 1,
                   hot_traffic_fraction: float = 0.0,
                   replicate_outputs: bool = True,
                   collective: bool = False) -> dict:
    """Per-step exchange-volume estimate of running ``ops`` as one fused
    unit vocab-sharded over ``shards``: indices out (each lookup's index —
    and its vals word in an upcast group — lands on its owning shard;
    (S-1)/S of them are remote, the collective link model: diagonal traffic
    of the all_to_all send lattice never crosses a link) and pooled rows
    back.  With ``replicate_outputs`` the (B, E) partial pools all-reduce
    (each shard ships its partials S-1 hops); reduce-scattered outputs
    (``replicate_outputs=False``) ship only (S-1)/S of the
    segment-padded pools — the replicated volume ÷ S, plus the padding
    rows of the scatter grid.

    ``hot_traffic_fraction`` is the share of lookups the replicated hot
    slab absorbs (hot rows are local on every shard — zero index exchange);
    ``index_savings_bytes`` reports what the classification saved vs. the
    all-interleaved layout.  ``collective`` adds the fused-segment-id word
    every lookup of the all_to_all send lattice carries (the receiver
    rebuilds its sub-CSR from it), matching the executor's wire counter."""
    ops = list(ops)
    if shards <= 1:
        return {"index_bytes": 0, "row_bytes": 0, "total_bytes": 0,
                "index_savings_bytes": 0}
    h = min(max(float(hot_traffic_fraction), 0.0), 1.0)
    lookups = sum(expected_lookups(op) for op in ops)
    words = 2 if group_needs_vals(ops) else 1
    if collective:
        words += 1                       # the per-lookup segment id
    idx_all = int(lookups * words * 4 * (shards - 1) / shards)
    idx = int(idx_all * (1.0 - h))

    def out_width(op):                   # bytes per output segment row
        blk = op.block_rows if op.kind == "gather" else 1
        return blk * op.emb_len * 4

    if replicate_outputs:
        rows = sum(op.num_segments * out_width(op) for op in ops) \
            * (shards - 1)
    else:
        segs = sum(op.num_segments for op in ops)
        pad = -(-segs // shards) * shards - segs
        # per-op widths summed like the replicate branch (a fused group is
        # width-homogeneous, but the helper is public); pad rows take the
        # group width of ops[0]
        rows = (sum(op.num_segments * out_width(op) for op in ops)
                + pad * out_width(ops[0])) * (shards - 1) // shards
    return {"index_bytes": idx, "row_bytes": rows,
            "total_bytes": idx + rows,
            "index_savings_bytes": idx_all - idx}


def fused_plan_resources(ops, vlen: int = 128, lvl: int = 3,
                         num_buffers: int = 2,
                         m: Machine = DEFAULT, shards: int = 1,
                         hot_rows_total: int = 0,
                         hot_traffic_fraction: float = 0.0,
                         replicate_outputs: bool = True,
                         collective: bool = False) -> dict:
    """Resource estimate of compiling ``ops`` as ONE batched KernelPlan.

    Returns vmem_bytes (tiles + scalar operands — PER SHARD when
    ``shards`` > 1, which is what the partitioner budgets), the split of
    that total, the stacked-table footprint (total and per shard — the
    per-shard figure includes the replicated hot slab of
    ``hot_rows_total`` classified rows — an int COUNT, not the
    ``{name: ids}`` mapping the compile entry points take), the per-step
    exchange volume of the sharded path
    with the savings the hot slab buys (``hot_traffic_fraction`` of the
    index stream stays local), total access/execute cycles of the batched
    stream, and their skew (``queue_balance`` ≥ 1; 1.0 = perfectly
    balanced DAE queues).
    """
    ops = list(ops)
    assert ops, "empty fusion candidate"
    tiles = max(plan_tile_bytes(op, vlen, num_buffers) for op in ops)
    upcast = group_needs_vals(ops)
    operands = sum(operand_bytes(op, force_vals=upcast, shards=shards)
                   for op in ops)
    acc = sum(access_weight(op, lvl, m) for op in ops)
    exe = sum(execute_weight(op, lvl, m) for op in ops)
    hi, lo = max(acc, exe), min(acc, exe)
    # the replicated hot slab every shard carries (0 rows when disabled);
    # compatibility already guarantees a homogeneous (emb_len, blk, dtype)
    op0 = ops[0]
    blk = op0.block_rows if op0.kind == "gather" else 1
    hot_slab = (int(hot_rows_total) * blk * op0.emb_len
                * np.dtype(op0.dtype).itemsize if shards > 1 else 0)
    exch = exchange_bytes(ops, shards, hot_traffic_fraction,
                          replicate_outputs=replicate_outputs,
                          collective=collective)
    return {
        "vmem_bytes": tiles + operands,
        "tile_bytes": tiles,
        "operand_bytes": operands,
        "table_bytes": sum(table_bytes(op) for op in ops),
        "table_bytes_per_shard":
            sum(table_bytes(op, shards) for op in ops) + hot_slab,
        "hot_slab_bytes": hot_slab,
        "exchange_bytes": exch["total_bytes"],
        "exchange_savings_bytes": exch["index_savings_bytes"],
        "shards": shards,
        "access_cycles": acc,
        "execute_cycles": exe,
        "queue_balance": (hi / lo) if lo > 0 else math.inf,
    }


def fits_budget(ops, vlen: int = 128,
                budget: FusionBudget = FusionBudget()) -> bool:
    """May ``ops`` legally compile as one fused unit under ``budget``?"""
    res = fused_plan_resources(ops, vlen, num_buffers=budget.num_buffers,
                               shards=budget.shards)
    return res["vmem_bytes"] <= budget.vmem_bytes


def queue_plane_point(op: EmbeddingOp, lvl: int, hit_rate: float = 0.0,
                      m: Machine = DEFAULT) -> tuple:
    """Fig 17: (access-unit queue-write rate, execute-unit queue-read rate),
    normalized to emb-opt0, for the ablation plane plot."""
    def rates(level):
        acc = access_cycles_per_lookup(op, m, level)
        acc = max(acc, mem_cycles_per_lookup(op, m, hit_rate,
                                             m.outstanding_tmu))
        comp = compute_cycles_per_lookup(op, m, level)
        return (op.emb_len / acc if acc else math.inf,
                op.emb_len / comp if comp else math.inf)
    a0, c0 = rates(0)
    a, c = rates(lvl)
    return a / a0, c / c0
