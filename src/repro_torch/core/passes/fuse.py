"""Multi-table fusion pass (program stage).

A model step's lookups over *distinct* tables (the multi-table DLRM shape
from the paper's Table 1; RecNMP/MicroRec show co-scheduling lookups across
tables is where the large wins are) compile today into N independent DAE
schedules — N access streams, N dispatches, N compile artifacts.  This pass
merges compatible SLS/SpMM/gather/KG ops into ONE batched loop nest over the
row-stacked table:

* one access stream walks the concatenated segments (``ptrs`` offset-merged,
  ``idxs`` unchanged);
* a per-segment **table-offset stream** ``roff`` rebases indices onto the
  stacked table on the access unit (MemStr + AluStr — never marshaled);
* the execute unit sees one interleaved queue, so every downstream
  optimization (vectorize/bufferize/align/store-streams) applies once to
  the whole group.

Ops naming a shared table (``EmbeddingProgram.shared_tables``) stack that
table once and point their ``roff`` entries at the same base.

Compatibility: same CSR class — ``kg`` fuses with ``sls`` as a *degenerate
CSR* (one lookup per segment, ``ptrs = arange``) — plus equal emb_len,
dtype, semiring, block_rows and the ``offsets`` index format.  Mixed
weighted/unweighted members fuse via a **unit-weight upcast**: unweighted
members marshal a constant ⊗-identity ``vals`` stream (1 for mul, 0 for
add).  Incompatible ops compile as singleton units, unchanged.

**Cost-model partitioning**: compatibility only proposes candidates.  Each
candidate group is checked against :class:`repro.core.cost_model.FusionBudget`
— the estimated on-chip working set of the batched KernelPlan (row-tile
buffers + scalar-prefetched access-stream operands) must fit — and a group
that does not fit is split into the fewest sub-units that do, balanced on
access-unit cycles (LPT) so no sub-unit's traversal stream becomes the
straggler.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import numpy as np

from .. import cost_model
from ..ops import EmbeddingOp, EmbeddingProgram

FUSABLE_KINDS = ("sls", "spmm", "gather", "kg")

#: kinds that share the batched CSR loop nest ('kg' = degenerate CSR)
_CSR_CLASS = {"sls": "sls", "kg": "sls", "spmm": "spmm"}


@dataclasses.dataclass(frozen=True)
class FusedGroup:
    """A set of member ops compiled as one batched multi-table op."""

    members: tuple           # op names, program order
    member_ops: tuple        # the original EmbeddingOps
    op: EmbeddingOp          # the fused op (num_tables = #stacked tables)
    seg_offsets: tuple       # per-member first output row in the fused out
    row_offsets: tuple       # per-member base row in the stacked table
                             # (block units for 'gather')

    @property
    def num_tables(self) -> int:
        return self.op.num_tables

    @property
    def unit_weight(self) -> float:
        """⊗-identity marshaled for unweighted members in an upcast group."""
        return 1.0 if self.op.semiring.mul == "mul" else 0.0


def fusion_key(prog: EmbeddingProgram, name: str):
    """Ops with equal keys may fuse; None means never fused."""
    op = prog.op(name)
    if (op.kind not in FUSABLE_KINDS or op.index_format != "offsets"
            or op.num_tables != 1):
        return None
    # 'weighted' is deliberately absent: mixed groups unit-weight upcast
    return (_CSR_CLASS.get(op.kind, op.kind), op.emb_len, op.dtype,
            op.semiring, op.block_rows)


def fuse_program(prog: EmbeddingProgram, vlen: int = 128,
                 budget: Optional[cost_model.FusionBudget] = None):
    """Group compatible ops under the resource budget.  Returns
    ``(units, note)`` where each unit is either ``(name, op)`` for a
    singleton or a :class:`FusedGroup`."""
    budget = budget or cost_model.FusionBudget()
    groups: dict = {}
    order: list = []
    for name, _ in prog.ops:
        key = fusion_key(prog, name)
        groups.setdefault(key, []).append(name)
        order.append((key, name))

    units: list = []
    emitted: set = set()
    n_split = 0
    for key, name in order:
        if name in emitted:
            continue
        members = groups[key] if key is not None else [name]
        if key is None or len(members) < 2:
            units.append((name, prog.op(name)))
            emitted.add(name)
            continue
        parts = partition_members(prog, tuple(members), vlen, budget)
        n_split += len(parts) > 1
        for part in parts:
            if len(part) < 2:
                units.append((part[0], prog.op(part[0])))
            else:
                units.append(_build_group(prog, part))
        emitted.update(members)
    n_fused = sum(1 for u in units if isinstance(u, FusedGroup))
    note = (f"{len(prog.ops)} ops -> {len(units)} units "
            f"({n_fused} fused group{'s' if n_fused != 1 else ''}")
    note += f", {n_split} split by budget)" if n_split else ")"
    return units, note


def partition_members(prog: EmbeddingProgram, members: tuple, vlen: int,
                      budget: cost_model.FusionBudget) -> list:
    """Split one compatibility group into sub-groups that fit ``budget``,
    balanced on access-unit cycles.

    Greedy LPT bin packing: members sorted by descending access weight go to
    the least-loaded sub-unit with operand headroom; a member that fits
    nowhere opens a new sub-unit.  The result preserves program order within
    each part and never exceeds the budget (a lone member that alone exceeds
    it stays a singleton — there is nothing left to split).
    """
    ops = {n: prog.op(n) for n in members}
    if cost_model.fits_budget(ops.values(), vlen, budget):
        return [tuple(members)]       # the whole group fits: fuse it all
    tile = max(cost_model.plan_tile_bytes(op, vlen, budget.num_buffers)
               for op in ops.values())
    cap = budget.vmem_bytes - tile
    # conservative: parts inherit the whole group's upcast (a part keeping
    # any weighted/kg member marshals vals for all of its members).  The
    # footprint is per shard — vocab sharding divides the index streams, so
    # a sharded executor's budget admits much larger groups.
    upcast = cost_model.group_needs_vals(ops.values())
    foot = {n: cost_model.operand_bytes(op, force_vals=upcast,
                                        shards=budget.shards)
            for n, op in ops.items()}

    index = {n: i for i, n in enumerate(members)}
    weight = {n: cost_model.access_weight(op) for n, op in ops.items()}
    # LPT over access cycles; ties broken by program order for determinism
    ranked = sorted(members, key=lambda n: (-weight[n], index[n]))
    bins: list = []                   # each: [load, operand_bytes, names]
    for n in ranked:
        best = None
        for b in bins:
            if b[1] + foot[n] <= cap and (best is None or b[0] < best[0]):
                best = b
        if best is None:
            bins.append([weight[n], foot[n], [n]])
        else:
            best[0] += weight[n]
            best[1] += foot[n]
            best[2].append(n)
    for b in bins:
        b[2].sort(key=index.__getitem__)
    bins.sort(key=lambda b: index[b[2][0]])
    return [tuple(b[2]) for b in bins]


def _effective_avg_lookups(op: EmbeddingOp) -> int:
    return 1 if op.kind == "kg" else op.avg_lookups


def _build_group(prog: EmbeddingProgram, members: tuple) -> FusedGroup:
    ops = tuple(prog.op(n) for n in members)
    proto = ops[0]
    kind = _CSR_CLASS.get(proto.kind, proto.kind)
    # unit-weight upcast: a group with any weighted/kg member marshals a
    # vals stream for every member (⊗-identity for the unweighted ones)
    weighted = (kind == "sls" and
                any(op.weighted or op.kind == "kg" for op in ops))
    # stack each distinct table once; shared tables share a base offset
    slot_base: dict = {}
    row_offsets: list = []
    next_row = 0
    for name, op in zip(members, ops):
        slot = prog.table_slot(name)
        if slot not in slot_base:
            slot_base[slot] = next_row
            next_row += op.num_embeddings
        row_offsets.append(slot_base[slot])
    seg_offsets = tuple(int(x) for x in
                        np.cumsum([0] + [op.num_segments for op in ops[:-1]]))
    fused = EmbeddingOp(
        kind=kind,
        num_segments=sum(op.num_segments for op in ops),
        num_embeddings=next_row,
        emb_len=proto.emb_len,
        avg_lookups=max(_effective_avg_lookups(op) for op in ops),
        block_rows=proto.block_rows,
        weighted=weighted,
        semiring=proto.semiring,
        dtype=proto.dtype,
        index_format="offsets",
        # even an all-shared-table group keeps the roff nest (all-zero
        # offsets): num_tables > 1 is what selects the fused loop shape
        num_tables=max(len(slot_base), 2),
    )
    return FusedGroup(tuple(members), ops, fused, seg_offsets,
                      tuple(row_offsets))


# ---------------------------------------------------------------------------
# Runtime marshaling: per-op inputs <-> fused inputs/outputs.
#
# The layout logic lives in repro.core.access_plan — these helpers build the
# group's (single-device) AccessPlan and interpret it, so the one-shot path
# can never diverge from what the executor and the shard planner marshal.
# ---------------------------------------------------------------------------

#: group -> its single-device AccessPlan.  Weak-keyed: the one-shot helpers
#: below run once per program execution and the plan build is O(vocab), so
#: rebuilding per call would dominate small interpreted steps; weak keys
#: keep dropped groups (and their numpy remap arrays) collectable.
_PLAN_CACHE = weakref.WeakKeyDictionary()


def _plan_of(group: FusedGroup):
    from ..access_plan import plan_for_group
    plan = _PLAN_CACHE.get(group)
    if plan is None:
        plan = _PLAN_CACHE[group] = plan_for_group(group)
    return plan


def stack_tables(group: FusedGroup, inputs: dict) -> np.ndarray:
    """Row-stack the member tables per the compiled AccessPlan layout.

    Placement follows the plan's slots (which honor the program's
    shared-table annotation): each declared table slot is written once into
    the stacked buffer, so the runtime marshaling can never diverge from the
    compiled fused op — regardless of whether shared tables arrive as one
    array object or equal-valued copies.
    """
    plan = _plan_of(group)
    parts = []
    for slot, name in zip(plan.slots, plan.slot_first_member):
        tbl = np.asarray(inputs[name]["table"])
        expect = slot.rows * plan.blk
        assert tbl.shape[0] == expect, \
            f"{name}: table has {tbl.shape[0]} rows, op declares {expect}"
        parts.append(tbl)
    return plan.stack_np(parts)


def group_roff(group: FusedGroup) -> np.ndarray:
    """The per-segment table-offset stream (static per signature)."""
    return _plan_of(group).roff


def fuse_index_inputs(group: FusedGroup, inputs: dict) -> dict:
    """The *per-step* half of the marshaling: offset-merged ``ptrs``,
    concatenated ``idxs``/``vals`` and the ``roff`` stream — everything
    except the stacked table (see :func:`stack_tables`).  Unweighted members
    of an upcast group emit a constant ⊗-identity ``vals`` run; kg members
    emit their degenerate one-per-segment CSR."""
    return _plan_of(group).fused_index_inputs(inputs)


def fuse_inputs(group: FusedGroup, inputs: dict) -> dict:
    """Build the fused op's concrete inputs from per-op input dicts (the
    one-shot path: stacked table + per-step index streams)."""
    fused_in = fuse_index_inputs(group, inputs)
    fused_in["table"] = stack_tables(group, inputs)
    return fused_in


def split_outputs(group: FusedGroup, fused_out) -> dict:
    """Slice the fused output back into per-op outputs, keyed by name."""
    out: dict = {}
    for name, op, off in zip(group.members, group.member_ops,
                             group.seg_offsets):
        out[name] = fused_out[off:off + op.num_segments]
    return out
