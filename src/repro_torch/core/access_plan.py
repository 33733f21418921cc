"""AccessPlan — the compiled host-side access artifact (DLC stage).

Ember's thesis is that the *access side* of an embedding operation deserves
its own compiled representation: the paper lowers lookups through dedicated
IRs (SCF -> SLC -> SLCV -> DLC) so access-stream generation is optimized
code, not ad-hoc host glue.  Before this module the program-scope access
work had drifted back into glue: CSR merging + ``roff`` synthesis lived in
``passes/fuse.py``, capacity bucketing was re-derived by the executor, and
the shard-routing layout was a private implementation inside
``core/shard_plan.py`` — three host paths each re-deriving the same stream
layout.

The ``plan-access`` pass (registered after ``lower-dlc`` in the
PassManager pipeline) now emits ONE :class:`AccessPlan` per compiled unit,
capturing as *data*:

* the stacked-slot geometry (slot bases, per-segment ``roff`` table-offset
  stream) of the fused unit;
* the capacity-bucket lattice (:mod:`repro.core.capacity`) every ragged
  extent is padded to;
* the vocab-shard routing table — per-slot ownership divisors, local bases,
  and the per-lookup owner/local-address computation of the offset-stream
  exchange;
* the **hot/cold row classification**: the Zipf head of each vocab slot
  (scored by :func:`repro.data.locality.classify_hot` reuse counts) is
  replicated on every shard as a *hot slab*, so hot lookups are local on
  whichever shard is least loaded (round-robin) and pay **zero exchange**;
  only the interleave-sharded cold tail routes indices across the mesh.

All host marshaling — the executor's per-step packing, the shard planner's
routed exchange, the one-shot ``fuse_inputs`` path — is *interpretation of
one AccessPlan*; none of those layers derives layout on its own anymore.

Sharded local-table layout (one fused unit, S shards)::

    shard s = [ slot0 cold slice s | slot1 cold slice s | ...
                | slot0 hot slab | slot1 hot slab | ... ]

    cold slice s of slot t = rows with cold-rank in [s*C_t, (s+1)*C_t),
    C_t = ceil(#cold_t / S); the hot slabs are identical on every shard.

Every shard's local table has the same shape and the same local bases
(SPMD), and the routed per-lookup indices are emitted *fully rebased* to
the local layout (the access-unit ALU resolving the complete address), so
the kernel-side ``seg_base`` stream degenerates to zeros on the sharded
path.  With an empty hot classification the layout and routing reduce
exactly to the PR-3 interleaved ceil-split (regression-tested).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .capacity import DEFAULT_LATTICE, CapacityLattice
from .ops import EmbeddingOp


class EmberFault(RuntimeError):
    """Base of the typed fault vocabulary.

    Lives here (the lowest layer that raises one) so :mod:`core` never
    imports :mod:`repro.runtime`; :mod:`repro.runtime.faults` is the
    user-facing home that re-exports it alongside the runtime faults
    (``InjectedFailure``, ``WaveTimeout``, ...)."""


class MalformedAccessError(EmberFault, ValueError):
    """An offset stream failed validation against its compiled
    :class:`AccessPlan` — out-of-bounds indices under ``strict`` policy,
    or structural damage (non-monotone ``ptrs``, stream-length mismatches,
    extents past the capacity lattice's int32 address space) under *any*
    policy.  Carries the op name and a machine-checkable ``reason``."""

    def __init__(self, op_name, reason: str, detail: str = ""):
        self.op_name = op_name
        self.reason = reason
        super().__init__(
            f"malformed access stream for op {op_name!r}: {reason}"
            + (f" ({detail})" if detail else ""))


class RpcError(EmberFault):
    """Disaggregated-tier transport failure (framing, closed socket).

    Defined here with :class:`EmberFault` (not in :mod:`repro.runtime`)
    because the executor's disaggregated submit path must classify it —
    transport faults fail over / degrade, application faults propagate —
    and core never imports runtime."""


class RpcTimeout(RpcError):
    """A per-call RPC deadline lapsed (``rpc_timeout_s``)."""


class ServiceUnavailable(RpcError):
    """Every embedding-service replica is dark after bounded retry; the
    executor's ``degrade_policy`` decides whether the step serves locally
    (hot slab / stale tables) or fails typed."""


#: index-validation policies of the marshaling path (``strict`` raises a
#: typed error; ``clamp``/``drop`` degrade per-lookup and count it)
INDEX_POLICIES = ("strict", "clamp", "drop")

#: the kernels address streams in int32 — a padded capacity bucket past
#: this is un-marshalable regardless of policy (structural, always raises)
_INT32_MAX = 2 ** 31 - 1


def canonical_hot(hot_rows) -> tuple:
    """Hashable canonical form of a ``{op name: hot row ids}`` mapping —
    the compile-cache / executor-cache key component."""
    if not hot_rows:
        return ()
    return tuple(sorted(
        (str(name), tuple(int(i) for i in sorted(set(ids))))
        for name, ids in dict(hot_rows).items() if len(ids)))


@dataclasses.dataclass(frozen=True)
class MemberPlan:
    """One member op's slice of the fused access stream.  Whether a vals
    stream is marshaled is a *unit*-level property (``AccessPlan.need_vals``
    — a mixed group unit-weight-upcasts every member), so it is not
    duplicated here."""

    name: Optional[str]      # op name (None for a singleton unit)
    kind: str                # sls | kg | gather | spmm | fusedmm
    num_segments: int
    seg_offset: int          # first fused output row of this member
    slot: int                # stacked-slot index (shared tables share one)


@dataclasses.dataclass
class SlotPlan:
    """One stacked table slot's layout: single-device base + shard split +
    hot/cold classification.  ``remap``/``is_hot`` are only materialized on
    sharded plans (they are the per-row address-translation tables of the
    routed exchange)."""

    rows: int                     # index-unit rows of the slot
    base: int                     # single-device stacked base (index units)
    hot_ids: np.ndarray           # sorted global unit-row ids, replicated
    cold_ids: np.ndarray          # ascending ids of the interleaved tail
    cap: int                      # per-shard cold capacity ceil(#cold / S)
    cold_base: int                # local base of this slot's cold slice
    hot_base: int                 # local base of this slot's hot slab
    remap: Optional[np.ndarray]   # row -> cold rank | hot slab position
    is_hot: Optional[np.ndarray]  # row -> replicated?

    @property
    def hot_rows(self) -> int:
        return len(self.hot_ids)

    @property
    def cold_rows(self) -> int:
        return len(self.cold_ids)


@dataclasses.dataclass
class AccessPlan:
    """The per-unit access artifact: stream layout + routing as data.

    Built once per compiled unit by the ``plan-access`` pass (part of the
    compile-cache artifact) and interpreted by every host marshaling path.
    All methods are pure; a plan may be shared by concurrent executors.
    """

    op: EmbeddingOp               # the unit's (fused) op
    group: Optional[object]       # the FusedGroup (None for singletons)
    kind: str                     # csr | gather (the fused loop class)
    shards: int
    blk: int                      # physical rows per index unit
    num_segments: int
    members: tuple                # of MemberPlan
    slots: tuple                  # of SlotPlan
    roff: np.ndarray              # per-segment single-device stacked base
    lattice: CapacityLattice
    need_vals: bool
    unit_weight: float            # ⊗-identity for unit-weight upcast
    hot_spec: tuple = ()          # canonical_hot() the plan was built with
    #: monotone slab generation: bumped on every adaptive hot-slab swap so
    #: marshaling can assert it interprets the plan the tables were stacked
    #: under (an epoch mismatch means a stale plan — a correctness bug)
    epoch: int = 0
    #: hot-spill table ``{src_shard: (dst_shard, fraction)}`` — when a
    #: source shard's lattice diagonal is overloaded, route this bounded
    #: fraction of its hot lookups to the named (least-loaded) peer.  The
    #: slab is replicated, so reassigning a hot lookup's owner is always
    #: legal; it merely moves the lookup off the diagonal onto the wire.
    #: Mutable feedback state: the executor refreshes it from the previous
    #: step's ``pair_counts`` (never shared across executors).
    spill: dict = dataclasses.field(default_factory=dict, repr=False)
    #: starting shard of the host-path round-robin hot owner assignment;
    #: the executor points it at the shard with the lightest routed bucket
    #: observed on the previous step.
    rr_start: int = 0
    _kg_ptrs: dict = dataclasses.field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------
    # Geometry
    # ------------------------------------------------------------------

    @property
    def fused(self) -> bool:
        return self.group is not None

    @property
    def local_rows(self) -> int:
        """Index-unit rows of ONE shard's local table (cold slices + hot
        slabs); equals the full stacked rows on a 1-shard plan."""
        if self.shards == 1:
            return sum(s.rows for s in self.slots)
        return sum(s.cap for s in self.slots) + self.hot_rows_total

    @property
    def hot_rows_total(self) -> int:
        return sum(s.hot_rows for s in self.slots)

    @property
    def seg_cap(self) -> int:
        """Contiguous segment-slice size of the collective exchange layout:
        shard ``s`` *originates* fused segments ``[s·seg_cap, (s+1)·seg_cap)``
        (its slice of the batch — the multi-host arrival model) and, with
        reduce-scattered outputs, *owns* their pooled rows."""
        return -(-self.num_segments // self.shards)

    @property
    def padded_segments(self) -> int:
        """Fused output rows after padding to the reduce-scatter grid
        (``seg_cap · shards``); rows ``>= num_segments`` are never read."""
        return self.seg_cap * self.shards

    @property
    def hot_slab_bytes(self) -> int:
        """Bytes of replicated hot rows each shard carries (0 when cold-only)."""
        item = np.dtype(self.op.dtype).itemsize
        return self.hot_rows_total * self.blk * self.op.emb_len * item

    @property
    def table_bytes_per_shard(self) -> int:
        item = np.dtype(self.op.dtype).itemsize
        return self.local_rows * self.blk * self.op.emb_len * item

    @property
    def slot_first_member(self) -> tuple:
        """Per slot, the first member name bound to it — the executor reads
        each slot's source table array through this member's inputs."""
        first: dict = {}
        for m in self.members:
            first.setdefault(m.slot, m.name)
        return tuple(first[t] for t in range(len(self.slots)))

    def stats(self) -> dict:
        return {"shards": self.shards, "slots": len(self.slots),
                "members": len(self.members),
                "hot_rows": self.hot_rows_total,
                "hot_slab_bytes": self.hot_slab_bytes,
                "local_rows": self.local_rows}

    # ------------------------------------------------------------------
    # Input hardening
    # ------------------------------------------------------------------

    def harden_step(self, inputs: dict, policy: str,
                    fallback_name: Optional[str] = None) -> tuple:
        """Validate (and, under ``clamp``/``drop``, repair) one step's
        member streams against this plan before any marshaling path
        interprets them.  Returns ``(inputs, oob, dropped)``.

        * *Structural* damage — wrong stream lengths, non-monotone or
          non-zero-based ``ptrs``, negative ``lens``, non-integer index
          dtypes, an nnz whose padded capacity bucket leaves int32 — has
          no graceful reading and raises :class:`MalformedAccessError`
          under **every** policy.
        * *Value* damage — indices outside the member's vocab bound
          (``slots[m.slot].rows``) — raises under ``strict``; ``clamp``
          clips to the valid range (counted in ``oob``); ``drop`` removes
          the offending CSR entries (counted in ``dropped``; for
          one-lookup-per-segment streams — gather/kg members — a segment
          cannot be empty, so drop degrades to clamp and counts ``oob``).

        The returned dict is the *same object* when every stream is clean
        (the zero-copy fast path — marshaling is then bit-identical to an
        unhardened executor); repaired members get shallow-copied entries.
        """
        assert policy in INDEX_POLICIES, (policy, INDEX_POLICIES)
        out, oob, dropped = inputs, 0, 0
        for m in self.members:
            name = m.name if m.name is not None else fallback_name
            ins = inputs[name]
            new, o, d = self._harden_member(m, ins, policy, name)
            oob += o
            dropped += d
            if new is not ins:
                if out is inputs:
                    out = dict(inputs)
                out[name] = new
        return out, oob, dropped

    def _member_idxs(self, m: MemberPlan, ins: dict, name) -> np.ndarray:
        idxs = np.asarray(ins["idxs"])
        if idxs.ndim != 1:
            raise MalformedAccessError(
                name, "idxs must be 1-D", f"got shape {idxs.shape}")
        if not np.issubdtype(idxs.dtype, np.integer):
            raise MalformedAccessError(
                name, "idxs must be an integer array",
                f"got dtype {idxs.dtype}")
        return idxs

    def _harden_member(self, m: MemberPlan, ins: dict, policy: str,
                       name) -> tuple:
        rows = self.slots[m.slot].rows
        idxs = self._member_idxs(m, ins, name)
        if m.kind in ("gather", "kg"):
            # one lookup per segment: the stream IS the segment axis
            if len(idxs) != m.num_segments:
                raise MalformedAccessError(
                    name, "idxs length != num_segments",
                    f"{len(idxs)} != {m.num_segments}")
            vals = ins.get("vals")
            if m.kind == "kg" and vals is not None \
                    and len(np.asarray(vals)) != m.num_segments:
                raise MalformedAccessError(
                    name, "vals length != num_segments",
                    f"{len(np.asarray(vals))} != {m.num_segments}")
            bad = (idxs < 0) | (idxs >= rows)
            nbad = int(bad.sum())
            if nbad == 0:
                return ins, 0, 0
            if policy == "strict":
                off = idxs[bad]
                raise MalformedAccessError(
                    name, f"{nbad} index(es) outside [0, {rows})",
                    f"e.g. {int(off[0])}")
            # drop == clamp here: a gather segment cannot be empty
            return {**ins, "idxs": np.clip(idxs, 0, rows - 1)}, nbad, 0
        # CSR stream (sls | spmm | fusedmm): ptrs (or lens) + idxs + vals
        ptrs, from_lens = self._harden_ptrs(m, ins, name)
        nnz = int(ptrs[-1])
        if nnz != len(idxs):
            raise MalformedAccessError(
                name, "ptrs[-1] != len(idxs)", f"{nnz} != {len(idxs)}")
        vals = ins.get("vals")
        if vals is not None and len(np.asarray(vals)) != nnz:
            raise MalformedAccessError(
                name, "vals length != nnz",
                f"{len(np.asarray(vals))} != {nnz}")
        if self.lattice.lookup_capacity(nnz) > _INT32_MAX:
            raise MalformedAccessError(
                name, "padded lookup capacity exceeds int32 address space",
                f"nnz={nnz}")
        bad = (idxs < 0) | (idxs >= rows)
        nbad = int(bad.sum())
        if nbad == 0:
            return ins, 0, 0
        if policy == "strict":
            off = idxs[bad]
            raise MalformedAccessError(
                name, f"{nbad} index(es) outside [0, {rows})",
                f"e.g. {int(off[0])}")
        if policy == "clamp":
            return {**ins, "idxs": np.clip(idxs, 0, rows - 1)}, nbad, 0
        # drop: excise the bad entries and rebuild the CSR offsets
        keep = ~bad
        seg = np.repeat(np.arange(m.num_segments), np.diff(ptrs))
        kept_per_seg = np.bincount(seg[keep], minlength=m.num_segments)
        new_ptrs = np.zeros(m.num_segments + 1, ptrs.dtype)
        np.cumsum(kept_per_seg, out=new_ptrs[1:])
        new = {**ins, "ptrs": new_ptrs, "idxs": idxs[keep]}
        new.pop("lens", None)         # superseded by the rebuilt ptrs
        if vals is not None:
            new["vals"] = np.asarray(vals)[keep]
        return new, 0, nbad

    def _harden_ptrs(self, m: MemberPlan, ins: dict, name) -> tuple:
        """Validate the CSR offset run (or derive it from ``lens``):
        zero-based, monotone non-decreasing, one entry past the segments."""
        if "ptrs" not in ins:
            if "lens" not in ins:
                raise MalformedAccessError(name, "missing ptrs/lens stream")
            lens = np.asarray(ins["lens"])
            if len(lens) != m.num_segments:
                raise MalformedAccessError(
                    name, "lens length != num_segments",
                    f"{len(lens)} != {m.num_segments}")
            if len(lens) and int(lens.min()) < 0:
                raise MalformedAccessError(
                    name, "negative segment length",
                    f"min={int(lens.min())}")
            ptrs = np.zeros(m.num_segments + 1, np.int64)
            np.cumsum(lens, out=ptrs[1:])
            return ptrs, True
        ptrs = np.asarray(ins["ptrs"], np.int64)
        if ptrs.shape != (m.num_segments + 1,):
            raise MalformedAccessError(
                name, "ptrs length != num_segments + 1",
                f"{ptrs.shape} != ({m.num_segments + 1},)")
        if int(ptrs[0]) != 0:
            raise MalformedAccessError(
                name, "ptrs must be zero-based", f"ptrs[0]={int(ptrs[0])}")
        if len(ptrs) > 1 and int(np.diff(ptrs).min()) < 0:
            raise MalformedAccessError(name, "ptrs must be non-decreasing")
        return ptrs, False

    # ------------------------------------------------------------------
    # Per-step stream interpretation (single-device path)
    # ------------------------------------------------------------------

    def member_ptrs(self, m: MemberPlan, ins: dict) -> np.ndarray:
        """CSR offsets of one member; kg members get their static degenerate
        one-per-segment CSR (cached — it never changes per signature)."""
        if m.kind == "kg":
            p = self._kg_ptrs.get(m.seg_offset)
            if p is None:
                p = self._kg_ptrs[m.seg_offset] = np.arange(
                    m.num_segments + 1, dtype=np.int64)
            return p
        return np.asarray(ins["ptrs"], np.int64)

    def csr_parts(self, inputs: dict) -> tuple:
        """Per-member CSR shape of one step: ``(parts, nnz, max_seg)`` with
        ``parts`` a list of ``(member, ptrs, member_nnz)`` — everything the
        capacity bucketing and the packing need."""
        parts: list = []
        nnz = 0
        max_seg = 0
        for m in self.members:
            p = self.member_ptrs(m, inputs[m.name])
            n = int(p[-1])
            max_seg = max(max_seg, int(np.diff(p).max(initial=0)))
            parts.append((m, p, n))
            nnz += n
        return parts, nnz, max_seg

    def pack_csr(self, buf: dict, parts: list, inputs: dict) -> int:
        """Write the offset-merged fused CSR into ``buf`` (the executor's
        bucketed scratch or a fresh exact-size dict): member ``ptrs`` run
        rebased by the running nnz, ``idxs`` concatenated, unweighted
        members of an upcast group emitting the constant ⊗-identity run."""
        pos = 0
        for m, p, n in parts:
            buf["ptrs"][m.seg_offset:m.seg_offset + m.num_segments] = \
                p[:-1] + pos
            buf["idxs"][pos:pos + n] = inputs[m.name]["idxs"]
            if "vals" in buf:
                v = inputs[m.name].get("vals")
                if v is None:             # unit-weight upcast member
                    buf["vals"][pos:pos + n] = self.unit_weight
                else:
                    buf["vals"][pos:pos + n] = v
            pos += n
        buf["ptrs"][self.num_segments] = pos
        return pos

    def pack_gather(self, buf: dict, inputs: dict) -> None:
        for m in self.members:
            buf["idxs"][m.seg_offset:m.seg_offset + m.num_segments] = \
                inputs[m.name]["idxs"]

    def fused_index_inputs(self, inputs: dict) -> dict:
        """The one-shot per-step marshaling (exact-size fresh arrays):
        offset-merged ``ptrs``, concatenated ``idxs``/``vals`` and the
        ``roff`` stream — everything except the stacked table."""
        out: dict = {"roff": self.roff}
        if self.kind == "gather":
            out["idxs"] = np.concatenate(
                [np.asarray(inputs[m.name]["idxs"]) for m in self.members])
            return out
        parts, nnz, _ = self.csr_parts(inputs)
        buf = {"ptrs": np.zeros(self.num_segments + 1, np.int32),
               "idxs": np.zeros(nnz, np.int32)}
        if self.need_vals:
            buf["vals"] = np.zeros(nnz, np.dtype(self.op.dtype))
        self.pack_csr(buf, parts, inputs)
        out.update(buf)
        return out

    # ------------------------------------------------------------------
    # Table stacking (layout interpretation)
    # ------------------------------------------------------------------

    def phys_rows(self, ids: np.ndarray) -> np.ndarray:
        """Index-unit row ids -> physical table rows (gather blocks)."""
        ids = np.asarray(ids, np.int64)
        if self.blk == 1:
            return ids
        return (ids[:, None] * self.blk +
                np.arange(self.blk, dtype=np.int64)[None, :]).reshape(-1)

    def stack_np(self, parts: list) -> np.ndarray:
        """Numpy oracle of the stacked table this plan lays out: the
        single-device row-stack on 1 shard, or the ``(S*L*blk, E)`` global
        array whose row block ``s`` is shard ``s``'s local table (cold
        slices + replicated hot slabs)."""
        emb = parts[0].shape[1]
        dt = parts[0].dtype
        if self.shards == 1:
            out = np.empty((self.local_rows * self.blk, emb), dt)
            for slot, p in zip(self.slots, parts):
                p = np.asarray(p)
                assert p.shape[0] == slot.rows * self.blk, \
                    (p.shape, slot.rows, self.blk)
                out[slot.base * self.blk:
                    slot.base * self.blk + p.shape[0]] = p
            return out
        s, blk, L = self.shards, self.blk, self.local_rows
        out = np.zeros((s * L * blk, emb), dt)
        for slot, p in zip(self.slots, parts):
            p = np.asarray(p)
            cold = p[self.phys_rows(slot.cold_ids)]
            hot = p[self.phys_rows(slot.hot_ids)]
            for sh in range(s):
                lo = sh * slot.cap
                hi = min((sh + 1) * slot.cap, slot.cold_rows)
                if lo < hi:
                    dst = (sh * L + slot.cold_base) * blk
                    out[dst:dst + (hi - lo) * blk] = \
                        cold[lo * blk:hi * blk]
                if slot.hot_rows:
                    dst = (sh * L + slot.hot_base) * blk
                    out[dst:dst + slot.hot_rows * blk] = hot
        return out

    # ------------------------------------------------------------------
    # Sharded routing (the offset-stream exchange, step 1)
    # ------------------------------------------------------------------

    def _resolve(self, idxs: np.ndarray, slot: SlotPlan, rr: int,
                 hot_owner: Optional[np.ndarray] = None) -> tuple:
        """Per-lookup (owner shard, fully-rebased local index, #hot) of one
        member's index stream.  Hot rows are local everywhere, so their
        owner is a load-balancing choice — round-robin in stream order
        (``rr`` threads the counter across members), or, on the collective
        path, the per-lookup ``hot_owner`` (the *source* shard: a hot
        lookup is then served where it arrives and never hits the wire) —
        and they contribute no exchange; cold rows route to
        ``cold_rank // C_t``."""
        idxs = np.asarray(idxs, np.int64)
        if slot.remap is None or not slot.hot_rows:
            owner = idxs // slot.cap
            return owner, slot.cold_base + idxs - owner * slot.cap, 0, rr
        r = slot.remap[idxs].astype(np.int64)
        hot = slot.is_hot[idxs]
        nh = int(hot.sum())
        owner = np.empty(len(idxs), np.int64)
        cold = ~hot
        owner[cold] = r[cold] // slot.cap
        if hot_owner is not None:
            owner[hot] = np.asarray(hot_owner, np.int64)[hot]
        else:
            owner[hot] = (rr + np.arange(nh, dtype=np.int64)) % self.shards
            rr += nh
        local = np.where(hot, slot.hot_base + r,
                         slot.cold_base + r - owner * slot.cap)
        return owner, local, nh, rr

    def route_csr(self, inputs: dict) -> dict:
        """Bucket one step's fused CSR stream by owning shard: merge the
        member streams, resolve every lookup's (owner, local address),
        stable-sort by owner (the source stream is segment-ordered, so each
        shard's re-emitted CSR is already valid) and pad to the joint
        exchange capacity bucket.  ``cold_nnz`` is the routed (exchanged)
        volume; ``hot_nnz`` lookups were absorbed by the replicated slab."""
        s = self.shards
        parts, nnz, _ = self.csr_parts(inputs)
        segs, owners, locals_, vals = [], [], [], []
        hot_nnz, rr = 0, int(self.rr_start) % s
        for m, p, n in parts:
            ins = inputs[m.name]
            segs.append(np.repeat(
                np.arange(m.num_segments, dtype=np.int64) + m.seg_offset,
                np.diff(p)))
            owner, local, nh, rr = self._resolve(
                ins["idxs"], self.slots[m.slot], rr)
            owners.append(owner)
            locals_.append(local)
            hot_nnz += nh
            if self.need_vals:
                v = ins.get("vals")
                vals.append(np.full(n, self.unit_weight,
                                    np.dtype(self.op.dtype))
                            if v is None else np.asarray(v))
        seg = np.concatenate(segs) if segs else np.zeros(0, np.int64)
        owner = np.concatenate(owners) if owners else np.zeros(0, np.int64)
        local = np.concatenate(locals_) if locals_ else np.zeros(0, np.int64)
        counts = np.zeros((s, self.num_segments), np.int64)
        if len(seg):
            np.add.at(counts, (owner, seg), 1)
        per_nnz = counts.sum(axis=1)
        ptrs = np.zeros((s, self.num_segments + 1), np.int32)
        np.cumsum(counts, axis=1, out=ptrs[:, 1:])
        perm = np.argsort(owner, kind="stable")
        bounds = np.zeros(s + 1, np.int64)
        np.cumsum(per_nnz, out=bounds[1:])
        cap, ml = self.lattice.exchange_capacity(
            per_nnz, counts.max(axis=1, initial=0))
        return {
            "ptrs": ptrs,
            "nnz": per_nnz,
            "idxs": local[perm].astype(np.int32),
            "vals": (np.concatenate(vals)[perm]
                     if self.need_vals else None),
            "bounds": bounds,
            "cap": cap,
            "max_lookups": ml,
            "hot_nnz": hot_nnz,
            "cold_nnz": nnz - hot_nnz,
        }

    def route_gather(self, inputs: dict) -> dict:
        """Bucket a fused gather's one-index-per-segment stream: every shard
        gets the full (B,) local-index vector with non-owned slots masked
        out (a gather's 'pool' is the row itself, so the mask IS the partial
        pool).  Hot segments are served round-robin — no exchange."""
        s, B = self.shards, self.num_segments
        idxs_out = np.zeros((s, B), np.int32)
        mask = np.zeros((s, B), np.float32)
        shard_ids = np.arange(s)[:, None]
        hot_segments, rr = 0, int(self.rr_start) % s
        for m in self.members:
            owner, local, nh, rr = self._resolve(
                inputs[m.name]["idxs"], self.slots[m.slot], rr)
            hot_segments += nh
            sl = slice(m.seg_offset, m.seg_offset + m.num_segments)
            owned = owner[None, :] == shard_ids
            idxs_out[:, sl] = np.where(owned, local[None, :], 0)
            mask[:, sl] = owned
        return {"idxs": idxs_out, "mask": mask,
                "hot_segments": hot_segments,
                "cold_segments": B - hot_segments}

    # ------------------------------------------------------------------
    # Collective routing (the offset-stream exchange as all_to_all send
    # buffers — see docs/executor.md §Collective exchange)
    # ------------------------------------------------------------------

    def fill_lattice(self, routed: dict, ints: np.ndarray,
                     vals: Optional[np.ndarray] = None) -> None:
        """Scatter a collective routing's per-lookup streams into the
        ``(S_src, S_dst, 2, cap)`` send lattice IN PLACE (the executor's
        rotating scratch — the steady-state path allocates nothing per
        step).  Pad slots get the segment sentinel; packing is stable
        within each pair, so per-pair runs stay segment-ordered."""
        s = self.shards
        cap = ints.shape[-1]
        ints[:, :, 0, :] = self.num_segments      # pad sentinel
        ints[:, :, 1, :] = 0                      # pad rows stay in bounds
        if vals is not None:
            vals[:] = 0
        seg = routed["seg"]
        n = len(seg)
        if not n:
            return
        flat = routed["src"] * s + routed["owner"]
        perm = np.argsort(flat, kind="stable")
        sflat = flat[perm]
        bounds = np.zeros(s * s + 1, np.int64)
        np.cumsum(np.bincount(sflat, minlength=s * s), out=bounds[1:])
        within = np.arange(n, dtype=np.int64) - bounds[sflat]
        i3 = ints.reshape(s * s, 2, cap)
        i3[sflat, 0, within] = seg[perm].astype(np.int32)
        i3[sflat, 1, within] = routed["local"][perm].astype(np.int32)
        if vals is not None:
            vals.reshape(s * s, cap)[sflat, within] = routed["val"][perm]

    def packed_lattice(self, routed: dict) -> dict:
        """Fresh-array packing of a collective routing (tests and one-shot
        callers; the executor fills its scratch via :meth:`fill_lattice`)."""
        s, cap = self.shards, routed["cap"]
        ints = np.empty((s, s, 2, cap), np.int32)
        vals = (np.empty((s, s, cap), np.dtype(self.op.dtype))
                if routed.get("val") is not None else None)
        self.fill_lattice(routed, ints, vals)
        return {"ints": ints, "vals": vals}

    def route_csr_collective(self, inputs: dict) -> dict:
        """Bucket one step's fused CSR stream into the ``(src, dst)`` send
        lattice of the device-collective exchange (``jax.lax.all_to_all``
        inside the shard_map body — see :mod:`repro.core.shard_plan`).

        The *source* shard of a lookup is the contiguous segment slice its
        fused segment falls in (``seg // seg_cap``) — the shard that, in a
        multi-host deployment, generates that slice of the batch and (with
        reduce-scattered outputs) owns its pooled rows.  Hot lookups are
        served **at the source** (the slab is local on every shard), so
        they occupy the diagonal of the send lattice and never hit the
        wire; cold lookups route to ``cold_rank // C_t`` as always.  Every
        pair bucket pads to ONE capacity (the lattice bucket of the max
        pair count) so the ``all_to_all`` is retrace-free across ragged
        steps; pad slots carry the segment sentinel ``num_segments``
        (masked on device), and the per-lookup *segment id* travels with
        the index, so the receiving shard can rebuild a canonical CSR
        without any cross-pair host merge.  ``wire_nnz`` counts the
        off-diagonal (actually exchanged) lookups.

        Returns the resolved streams + capacities; pack them into a send
        buffer with :meth:`fill_lattice` (in-place, the executor's scratch)
        or :meth:`packed_lattice` (fresh arrays)."""
        s = self.shards
        sc = self.seg_cap
        parts, nnz, _ = self.csr_parts(inputs)
        segs_l, srcs_l, owners_l, locals_l, hots_l, vals_l = \
            [], [], [], [], [], []
        hot_nnz = 0
        for m, p, n in parts:
            ins = inputs[m.name]
            seg = np.repeat(
                np.arange(m.num_segments, dtype=np.int64) + m.seg_offset,
                np.diff(p))
            src = np.minimum(seg // sc, s - 1)
            slot = self.slots[m.slot]
            owner, local, nh, _ = self._resolve(
                ins["idxs"], slot, 0, hot_owner=src)
            hot_nnz += nh
            segs_l.append(seg)
            srcs_l.append(src)
            owners_l.append(owner)
            locals_l.append(local)
            if self.spill:
                hots_l.append(
                    np.zeros(n, bool)
                    if slot.remap is None or not slot.hot_rows
                    else slot.is_hot[np.asarray(ins["idxs"], np.int64)])
            if self.need_vals:
                v = ins.get("vals")
                vals_l.append(np.full(n, self.unit_weight,
                                      np.dtype(self.op.dtype))
                              if v is None else np.asarray(v))
        cat = (lambda xs, dt: np.concatenate(xs)
               if xs else np.zeros(0, dt))
        seg = cat(segs_l, np.int64)
        src = cat(srcs_l, np.int64)
        owner = cat(owners_l, np.int64)
        local = cat(locals_l, np.int64)
        # Hot-aware source spill: a hot lookup's owner is a free choice
        # (the slab is replicated), so shed a bounded, deterministic
        # prefix (stream order) of an overloaded source's hot lookups to
        # its least-loaded peer — trading a little wire volume for
        # diagonal balance.
        spilled = 0
        if self.spill and len(seg):
            hot = cat(hots_l, bool)
            for s0, (dst, frac) in self.spill.items():
                s0, dst = int(s0) % s, int(dst) % s
                if dst == s0:
                    continue
                sel = np.flatnonzero(hot & (src == s0))
                k = int(len(sel) * min(max(float(frac), 0.0), 1.0))
                if k:
                    owner[sel[:k]] = dst
                    spilled += k
        pair = np.zeros((s, s), np.int64)
        dst_seg = np.zeros((s, self.num_segments), np.int64)
        if len(seg):
            np.add.at(pair, (src, owner), 1)
            np.add.at(dst_seg, (owner, seg), 1)
        cap, ml = self.lattice.collective_exchange_capacity(
            pair, dst_seg.max(axis=1, initial=0))
        return {
            "seg": seg,
            "src": src,
            "owner": owner,
            "local": local,
            "val": (cat(vals_l, np.dtype(self.op.dtype))
                    if self.need_vals else None),
            "cap": cap,
            "max_lookups": ml,
            "pair_counts": pair,
            "nnz": pair.sum(axis=0),
            "hot_nnz": hot_nnz,
            "cold_nnz": nnz - hot_nnz,
            "spilled_nnz": spilled,
            "wire_nnz": int(pair.sum() - np.trace(pair)),
        }

    def route_gather_collective(self, inputs: dict) -> dict:
        """Collective routing of a fused gather's one-index-per-segment
        stream: same ``(src, dst)`` send lattice as the CSR path (segment
        id + local block index per lookup); the receiving shard gathers its
        owned blocks and scatters them to their segments — exactly one
        shard owns each segment, so the cross-shard combine is a plain sum
        (or its reduce-scatter).  Pack via :meth:`fill_lattice` /
        :meth:`packed_lattice`, like the CSR routing."""
        s, sc, B = self.shards, self.seg_cap, self.num_segments
        segs_l, srcs_l, owners_l, locals_l = [], [], [], []
        hot_segments = 0
        for m in self.members:
            seg = np.arange(m.num_segments, dtype=np.int64) + m.seg_offset
            src = np.minimum(seg // sc, s - 1)
            owner, local, nh, _ = self._resolve(
                inputs[m.name]["idxs"], self.slots[m.slot], 0,
                hot_owner=src)
            hot_segments += nh
            segs_l.append(seg)
            srcs_l.append(src)
            owners_l.append(owner)
            locals_l.append(local)
        seg = np.concatenate(segs_l)
        src = np.concatenate(srcs_l)
        owner = np.concatenate(owners_l)
        local = np.concatenate(locals_l)
        pair = np.zeros((s, s), np.int64)
        np.add.at(pair, (src, owner), 1)
        cap, _ = self.lattice.collective_exchange_capacity(pair, [0])
        return {"seg": seg, "src": src, "owner": owner, "local": local,
                "val": None, "cap": cap,
                "pair_counts": pair,
                "hot_segments": hot_segments,
                "cold_segments": B - hot_segments,
                "wire_segments": int(pair.sum() - np.trace(pair))}


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def _build_slots(rows_per_slot: list, bases: list, shards: int,
                 hot_per_slot: list) -> tuple:
    """Lay out the slots: single-device bases are given; the sharded layout
    packs cold slices first (cumulative ceil-split caps), then the
    replicated hot slabs."""
    hots = [np.asarray(sorted(set(int(i) for i in h if 0 <= int(i) < r)),
                       np.int64)
            for r, h in zip(rows_per_slot, hot_per_slot)]
    caps = [max(1, -(-(r - len(h)) // shards))
            for r, h in zip(rows_per_slot, hots)]
    total_cold = sum(caps)
    slots: list = []
    cold_base = 0
    hot_base = total_cold
    for rows, base, hot, cap in zip(rows_per_slot, bases, hots, caps):
        cold = np.setdiff1d(np.arange(rows, dtype=np.int64), hot)
        remap = is_hot = None
        if shards > 1:
            remap = np.zeros(rows, np.int32)
            is_hot = np.zeros(rows, bool)
            remap[cold] = np.arange(len(cold), dtype=np.int32)
            if len(hot):
                remap[hot] = np.arange(len(hot), dtype=np.int32)
                is_hot[hot] = True
        slots.append(SlotPlan(rows=rows, base=base, hot_ids=hot,
                              cold_ids=cold, cap=cap, cold_base=cold_base,
                              hot_base=hot_base, remap=remap,
                              is_hot=is_hot))
        cold_base += cap
        hot_base += len(hot)
    return tuple(slots)


def build_plan(op: EmbeddingOp, group=None, shards: int = 1,
               hot_rows=None, lattice: CapacityLattice = DEFAULT_LATTICE,
               epoch: int = 0) -> AccessPlan:
    """Build the AccessPlan of one compiled unit.

    ``group`` is the fusion pass's FusedGroup (duck-typed: ``members``,
    ``member_ops``, ``row_offsets``, ``seg_offsets``, ``op``,
    ``unit_weight``); ``None`` builds the trivial singleton plan.
    ``hot_rows`` maps member op names to replicated row ids — only
    meaningful on sharded plans (a 1-shard plan has no exchange to save,
    so the classification is dropped and the layout is exactly the
    single-device stack)."""
    shards = max(int(shards), 1)
    hot_rows = dict(hot_rows) if (hot_rows and shards > 1) else {}
    if group is None:
        member = MemberPlan(None, op.kind, op.num_segments, 0, 0)
        slots = _build_slots([op.num_embeddings], [0], shards, [()])
        return AccessPlan(
            op=op, group=None,
            kind="gather" if op.kind == "gather" else "csr",
            shards=shards, blk=op.block_rows if op.kind == "gather" else 1,
            num_segments=op.num_segments, members=(member,), slots=slots,
            roff=np.zeros(op.num_segments, np.int32), lattice=lattice,
            # kg included: a standalone kg op always consumes a vals stream
            # (fused groups instead fold kg into op.weighted via the upcast)
            need_vals=op.weighted or op.kind in ("spmm", "kg"),
            unit_weight=1.0 if op.semiring.mul == "mul" else 0.0,
            epoch=epoch)

    fop = group.op
    blk = fop.block_rows if fop.kind == "gather" else 1
    slot_of_base: dict = {}
    rows_per_slot: list = []
    bases: list = []
    members: list = []
    hot_per_slot: list = []
    for name, mop, base, seg_off in zip(group.members, group.member_ops,
                                        group.row_offsets,
                                        group.seg_offsets):
        if base not in slot_of_base:
            slot_of_base[base] = len(rows_per_slot)
            rows_per_slot.append(mop.num_embeddings)
            bases.append(base)
            hot_per_slot.append(set())
        t = slot_of_base[base]
        hot_per_slot[t].update(hot_rows.get(name, ()))
        members.append(MemberPlan(name, mop.kind, mop.num_segments,
                                  seg_off, t))
    slots = _build_slots(rows_per_slot, bases, shards,
                         [sorted(h) for h in hot_per_slot])
    roff = np.concatenate(
        [np.full(m.num_segments, slots[m.slot].base, np.int32)
         for m in members])
    return AccessPlan(
        op=fop, group=group,
        kind="gather" if fop.kind == "gather" else "csr",
        shards=shards, blk=blk, num_segments=fop.num_segments,
        members=tuple(members), slots=slots, roff=roff, lattice=lattice,
        need_vals=fop.weighted or fop.kind == "spmm",
        unit_weight=group.unit_weight,
        hot_spec=canonical_hot(hot_rows), epoch=epoch)


def plan_for_group(group, shards: int = 1, hot_rows=None) -> AccessPlan:
    """Convenience: the AccessPlan of a FusedGroup outside the pass
    pipeline (the one-shot ``fuse_inputs`` path and tests)."""
    return build_plan(group.op, group, shards=shards, hot_rows=hot_rows)


def plan_access_pass(dlc, frontend_op=None, group=None, shards: int = 1,
                     hot_rows=None, **_) -> AccessPlan:
    """The ``plan-access`` PassManager pass: consumes the DLC program (the
    plan is the host-side companion of the device DLC artifact) and emits
    the unit's AccessPlan from the compile options the driver forwards."""
    assert frontend_op is not None, "plan-access needs the frontend op"
    return build_plan(frontend_op, group, shards=shards, hot_rows=hot_rows)


def hot_rows_from_traces(program, traces: dict, budget) -> dict:
    """Classify each op's Zipf head from calibration index traces, sized to
    ``budget.hot_slab_bytes`` per table (0 disables).  Returns the
    ``{op name: tuple(row ids)}`` mapping ``executor_for`` /
    ``compile_program`` accept as ``hot_rows``."""
    from ..data.locality import classify_hot
    out: dict = {}
    if getattr(budget, "hot_slab_bytes", 0) <= 0:
        return out
    for name, op in program.ops:
        tr = traces.get(name)
        if tr is None or len(tr) == 0:
            continue
        blk = op.block_rows if op.kind == "gather" else 1
        row_bytes = blk * op.emb_len * np.dtype(op.dtype).itemsize
        max_hot = budget.hot_slab_bytes // max(row_bytes, 1)
        ids = classify_hot(np.asarray(tr), op.num_embeddings, max_hot)
        if len(ids):
            out[name] = tuple(int(i) for i in ids)
    return out
