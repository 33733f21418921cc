"""Capacity-bucket lattice — THE canonical shape-bucketing policy.

Every ragged extent that reaches a kernel (`max_lookups` grid size, the nnz
of the idxs/vals streams, the per-shard exchange buckets) is a *static*
specialization parameter: each distinct value is a distinct jit trace.  The
steady-state paths therefore pad to a small lattice of capacity buckets so a
ragged step sequence reuses one trace per bucket.

This module is the single home of that policy.  It used to be spread over
:mod:`repro.kernels.sls` and re-derived by the executor and the shard
planner; now the kernel layer re-exports it and the compiled
:class:`~repro.core.access_plan.AccessPlan` carries a
:class:`CapacityLattice` instance so host marshaling can never drift from
what the kernels retrace on.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def lookup_capacity(n: int) -> int:
    """Round a ragged extent up to its power-of-two capacity bucket (>= 1).

    Used for the nnz of the idxs/vals operand streams: the bucket only
    controls the retrace count (padding slots are masked by the CSR ``ptrs``
    bounds), so the coarse power-of-two lattice is right.
    """
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def grid_capacity(n: int) -> int:
    """Quarter-octave bucket for the ``max_lookups`` *grid* extent.

    Unlike the operand buffers, every padded ``max_lookups`` slot is a real
    masked grid step, so a 2x overshoot doubles the kernel's inner loop.
    Rounding to the next quarter of a power of two keeps the overshoot
    <= 33% while still giving ragged steps only ~4 buckets per octave."""
    n = max(int(n), 1)
    if n <= 4:
        return n
    q = 1 << ((n - 1).bit_length() - 2)
    return -(-n // q) * q


def exchange_capacity(nnz_per_shard, max_seg_per_shard) -> tuple:
    """Joint ``(nnz_cap, max_lookups)`` bucket of one vocab-sharded exchange
    step (see :mod:`repro.core.access_plan`): every shard's routed bucket is
    padded to the SAME capacities — SPMD needs uniform shapes — so the
    bucket is the max over shards, rounded with the same pow-2 /
    quarter-octave rules the single-device executor retraces on.  A shard
    receiving zero indices still gets the >=1-slot bucket (all-empty CSR is
    a valid kernel input)."""
    nnz = max((int(n) for n in nnz_per_shard), default=0)
    seg = max((int(n) for n in max_seg_per_shard), default=0)
    return lookup_capacity(nnz), grid_capacity(seg)


def collective_exchange_capacity(pair_counts, max_seg_per_shard) -> tuple:
    """Joint ``(pair_cap, max_lookups)`` bucket of one device-collective
    exchange step: every ``(src, dst)`` send bucket of the ``all_to_all``
    must have the SAME static width (the collective splits uniformly), so
    the bucket is the max over all shard pairs, rounded with the same pow-2
    rule as the single-device nnz streams; ``max_lookups`` stays the
    quarter-octave grid bucket over the *receiving* shards' densest
    segment.  An all-empty step still gets the >=1-slot bucket."""
    pair = max((int(n) for n in np.ravel(pair_counts)), default=0)
    seg = max((int(n) for n in max_seg_per_shard), default=0)
    return lookup_capacity(pair), grid_capacity(seg)


@dataclasses.dataclass(frozen=True)
class CapacityLattice:
    """The bucketing policy as a value, carried by every AccessPlan.

    One instance per plan keeps the lattice an explicit part of the compiled
    access artifact (a future backend could subclass with different
    rounding); today there is exactly one policy, shared by all plans."""

    def lookup_capacity(self, n: int) -> int:
        return lookup_capacity(n)

    def grid_capacity(self, n: int) -> int:
        return grid_capacity(n)

    def exchange_capacity(self, nnz_per_shard, max_seg_per_shard) -> tuple:
        return exchange_capacity(nnz_per_shard, max_seg_per_shard)

    def collective_exchange_capacity(self, pair_counts,
                                     max_seg_per_shard) -> tuple:
        return collective_exchange_capacity(pair_counts, max_seg_per_shard)


DEFAULT_LATTICE = CapacityLattice()
