"""ProgramExecutor -- the steady-state runtime of a compiled embedding program
on one device (counterpart of ``repro/core/executor.py``, single device).

Three mechanisms, as in the reference:

* **Marshaling cache** -- everything per signature is built once and kept on
  the device: the fused units' row-stacked tables (``torch.cat`` on the
  device; refreshed by ``copy_`` in place on :meth:`ProgramExecutor.update_tables`)
  and the per-segment ``roff`` table-offset streams.  A steady-state step
  stacks no table.
* **Capacity buckets** -- the ``idxs``/``vals`` streams of a CSR unit are
  padded to the capacity lattice its compiled AccessPlan carries, so a ragged
  step sequence reuses a few staging buffers.  (The Hopper SLS kernel loops
  over each segment's own lookups, so the reference's ``max_lookups`` grid
  bucket has no counterpart.)
* **Cross-step access/execute overlap** -- :meth:`ProgramExecutor.submit`
  packs a step's index streams into pinned host staging buffers, copies them
  to the card with ``non_blocking=True`` and launches the kernels on the
  current stream, then records one CUDA event.  Nothing blocks until
  :meth:`StepHandle.result`, which synchronises on that event only.  A
  staging slot is repacked only after the event of the step that last used
  it has completed (:class:`BufferPool`).

Tables are tensors on the executor's device; index streams are host (numpy)
arrays.  The executor runs on the CUDA device unless built with
``device="cpu"``, where the kernels' plain versions run instead; without a
card, asking for the default device raises.

``backend`` selects the execute unit: ``"cuda"`` (the hand-written Hopper
kernels, the reference's ``"pallas"``) or ``"torch"`` (stock PyTorch ops,
:mod:`.backend_torch`, the reference's ``"jax"``).  The marshaling and
overlap are the same for both.

**Pipeline groups** (:func:`pipeline_group`) join executors over one shared
staging pool (entries keyed by the buffer spec, so same-shaped staging of
different programs is one ring) with per-program in-flight accounting.
:meth:`PipelineGroup.submit_wave` submits one serving wave across its
members: ``torch``-backend gather units stage their index streams on one
:class:`TransferBatch` and defer their launch; the group's flush packs every
staged array into one pinned buffer from the shared pool, issues one
``non_blocking`` copy, launches the deferred runs in order on the current
stream and records ONE CUDA event after the last of them.  That event is
the event of every handle with deferred outputs, and only then do their
staging slots become reusable.  ``cuda``-backend units launch inside
``submit``, as ``pallas`` units do in the reference.  (The reference traces
the deferred runs into one jitted wave executable; a CUDA graph of the
pipeline wave is an open decision, ROADMAP.md follow-up F2.)

Not ported yet (ROADMAP.md): meshes and vocab sharding, the hot slab and its
adaptive swaps, the disaggregated service and its degrade policy, and
serving artifacts.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import deque
from typing import Optional

import numpy as np
import torch

from . import access_plan as ap
from . import backend_cuda as bc
from . import backend_torch as bt
from .cost_model import FusionBudget
from .ops import EmbeddingProgram
from .passes.fuse import FusedGroup
from .pipeline import (BoundedLru, ProgramCompileResult, compile_program,
                       entries_by_shards)

BACKENDS = ("cuda", "torch")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another.  Raises when the card is asked for and absent -- there is
    no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "kernels' plain versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass(eq=False)  # identity semantics: outputs hold tensors
class StepHandle:
    """One in-flight program step.  ``outputs`` are tensors whose kernels
    may still run; :meth:`result` is the consume point.

    A step submitted into a :class:`TransferBatch` whose units deferred
    their launch is ``deferred`` until the batch's flush: it has neither
    outputs nor an event before then, and is never ready."""

    outputs: dict                 # op name -> tensor
    index: int                    # step number within the executor
    event: Optional[torch.cuda.Event] = None   # recorded after the launches
    done: bool = False
    faults: object = None         # chaos injector (site "result"), if any
    deferred: bool = False        # outputs wait for a TransferBatch flush

    def ready(self) -> bool:
        """True once the step's copies and kernels have finished (never
        blocks)."""
        if self.done:
            return True
        if self.deferred:
            return False
        return self.event is None or self.event.query()

    def result(self) -> dict:
        if self.faults is not None:
            self.faults.fire("result", step=self.index)
        if self.deferred:
            raise RuntimeError(f"step {self.index}: result() before its "
                               "wave's TransferBatch was flushed")
        if self.event is not None:
            self.event.synchronize()
        self.done = True
        return self.outputs


class _TxnRef:
    """Placeholder for one host tensor riding a :class:`TransferBatch`."""
    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


#: byte alignment of each array inside a wave's packed staging buffer (so
#: every device view may be reinterpreted as its own dtype)
_PACK_ALIGN = 16


class TransferBatch:
    """One serving wave's coalesced host -> device transfer.

    :meth:`PipelineGroup.submit_wave` hands every member executor the same
    batch: ``torch``-backend gather units stage their per-step host streams
    on it instead of copying each, and defer their launch as a pure
    ``run(dev_inputs) -> {op name: output}`` function.  :meth:`flush` packs
    every staged array into ONE pinned buffer (from ``pool``, keyed by its
    size bucket), issues ONE ``non_blocking`` copy, launches the deferred
    runs in order on the current stream, and records one CUDA event after
    the last launch: the event of every step handle registered on the batch,
    which only then stops being ``deferred``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._host: list = []     # staged host tensors
        # (handle outputs dict, run fn, staged inputs with _TxnRefs)
        self.fills: list = []
        self.handles: list = []   # steps whose outputs come from the flush
        self.n_arrays = 0

    def put(self, t: torch.Tensor) -> _TxnRef:
        self._host.append(t)
        self.n_arrays += 1
        return _TxnRef(len(self._host) - 1)

    def defer(self, outs: dict, run, staged: dict) -> None:
        self.fills.append((outs, run, staged))

    def flush(self, pool: Optional["BufferPool"] = None
              ) -> Optional[torch.cuda.Event]:
        """Pack, copy once, launch the deferred runs; returns the wave's
        event (None on the CPU, where the runs are synchronous)."""
        host, self._host = self._host, []
        fills, self.fills = self.fills, []
        handles, self.handles = self.handles, []
        if not fills:
            return None
        cuda = self.device.type == "cuda"
        offs, n = [], 0
        for t in host:
            offs.append(n)
            n += -(-t.numel() * t.element_size() // _PACK_ALIGN) * _PACK_ALIGN
        cap = max(4096, 1 << max(0, n - 1).bit_length())   # size bucket
        spec = {"wave": ((cap,), np.uint8)}
        if pool is not None:
            entry, turn, _ = pool.acquire(pool.key_for("wave", (cap,), spec),
                                          spec)
            buf = entry["slots"][turn]["wave"]
        else:
            entry = None
            buf = torch.empty(cap, dtype=torch.uint8, pin_memory=cuda)
        for t, o in zip(host, offs):
            nb = t.numel() * t.element_size()
            buf[o:o + nb].view(t.dtype).copy_(t.reshape(-1))
        dev = (buf[:n].to(self.device, non_blocking=True) if cuda
               else buf[:n].clone())
        devs = [dev[o:o + t.numel() * t.element_size()].view(t.dtype)
                .view(t.shape) for t, o in zip(host, offs)]
        for outs, run, staged in fills:
            outs.update(run({k: devs[v.i] if isinstance(v, _TxnRef) else v
                             for k, v in staged.items()}))
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        for h in handles:
            h.event = event
            h.deferred = False
        if entry is not None:   # the packed buffer is busy until the event
            entry["owners"][turn] = StepHandle({}, -1, event=event)
        return event


class BufferPool:
    """Rotating host staging buffers behind the per-step marshaling.

    Each entry is a small ring of identically-shaped buffer sets (pinned
    host tensors when the executor runs on the card, so the copies are
    asynchronous); every slot remembers the :class:`StepHandle` that last
    packed it.  A slot is free once that step's event has completed.  When
    every slot is busy the ring grows (up to ``max_slots``) instead of
    stalling -- with a shared pool a forced drain would block one program's
    marshal on another's execute; only a full ring waits for the oldest
    owner's event (``forced_drains``).

    ``shared=False`` (each executor's private default) keys entries by
    ``(executor, unit, capacity bucket)``; ``shared=True``
    (:func:`pipeline_group`) keys by the buffer spec alone, so same-shaped
    staging of different programs draws from one ring.  Sharing is safe
    because every marshal path overwrites what its kernel reads."""

    def __init__(self, n_slots: int = 2, max_slots: Optional[int] = None,
                 pin: bool = False, shared: bool = False):
        self.n_slots = max(2, n_slots)
        self.max_slots = max(self.n_slots, max_slots or self.n_slots * 4)
        self.pin = pin
        self.shared = shared
        self._entries: dict = {}
        self.stats = {"entries": 0, "hits": 0, "misses": 0, "grown": 0,
                      "forced_drains": 0, "bytes": 0}

    @staticmethod
    def spec_sig(spec: dict) -> tuple:
        return tuple(sorted((k, tuple(shape), np.dtype(dt).str)
                            for k, (shape, dt) in spec.items()))

    def key_for(self, owner_tag, bucket, spec: dict):
        if self.shared:
            return self.spec_sig(spec)
        return (owner_tag, bucket)

    def _alloc(self, spec: dict) -> dict:
        return {k: torch.zeros(shape, dtype=_torch_dtype(dt),
                               pin_memory=self.pin)
                for k, (shape, dt) in spec.items()}

    def _count_bytes(self, spec: dict, n: int) -> None:
        self.stats["bytes"] += n * sum(
            int(np.prod(shape)) * np.dtype(dt).itemsize
            for shape, dt in spec.values())

    def acquire(self, key, spec: dict):
        """Returns ``(entry, turn, created)``; the caller packs
        ``entry["slots"][turn]`` and records the owning handle at submit."""
        entry = self._entries.get(key)
        created = entry is None
        if created:
            entry = {"slots": [self._alloc(spec)
                               for _ in range(self.n_slots)],
                     "owners": [None] * self.n_slots, "turn": 0, "uses": 0}
            self._entries[key] = entry
            self.stats["misses"] += 1
            self.stats["entries"] = len(self._entries)
            self._count_bytes(spec, self.n_slots)
        else:
            self.stats["hits"] += 1
        entry["uses"] += 1
        n = len(entry["slots"])
        turn = None
        for k in range(1, n + 1):
            t = (entry["turn"] + k) % n
            owner = entry["owners"][t]
            if owner is None or owner.ready():
                turn = t
                break
        if turn is None:
            if n < self.max_slots:    # every slot in flight: grow the ring
                entry["slots"].append(self._alloc(spec))
                entry["owners"].append(None)
                turn = n
                self.stats["grown"] += 1
                self._count_bytes(spec, 1)
            else:                     # full ring: wait for the oldest owner
                turn = (entry["turn"] + 1) % n
                entry["owners"][turn].result()
                self.stats["forced_drains"] += 1
        entry["turn"] = turn
        entry["owners"][turn] = None
        return entry, turn, created

    def release_all(self) -> None:
        """Forget every slot's owning handle (fault recovery: abandoned
        steps must not keep their slots busy)."""
        for entry in self._entries.values():
            entry["owners"] = [None] * len(entry["slots"])
        self.stats["releases"] = self.stats.get("releases", 0) + 1


def _torch_dtype(dt) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np.dtype(dt))).dtype


@dataclasses.dataclass
class _UnitState:
    """Device-resident state of one compiled unit (the marshaling cache)."""

    unit: object                  # CompiledUnit
    plan: Optional[ap.AccessPlan] = None
    table: Optional[torch.Tensor] = None
    roff: Optional[torch.Tensor] = None    # fused units only (device)
    # weakrefs to the bound source tables: identity that CPython id reuse
    # cannot fool, without pinning the caller's memory
    src_refs: tuple = ()
    owns_table: bool = False      # stacked tensor built here (updated in place)

    def sources_unchanged(self, srcs: list) -> bool:
        return (len(self.src_refs) == len(srcs) and
                all(r() is a for r, a in zip(self.src_refs, srcs)))

    @property
    def group(self) -> Optional[FusedGroup]:
        return self.unit.group

    @property
    def res(self):
        return self.unit.result


class ProgramExecutor:
    """Steady-state executor over one :class:`ProgramCompileResult`.

    ``inputs`` maps op name -> that op's inputs: tables (``"table"``) as
    tensors on the executor's device, index streams (``ptrs``/``lens``,
    ``idxs``, ``vals``) as host arrays.  Tables bind on the first step and
    are reused while the caller passes the *same tensor objects*; other
    objects are detected by identity and rebound.  :meth:`update_tables`
    refreshes in place when the same objects changed.

    ``backend`` is ``"cuda"`` (the hand-written kernels; their plain
    versions on a CPU executor) or ``"torch"`` (stock PyTorch ops,
    :mod:`.backend_torch`).  ``pool`` is a staging pool to draw from instead
    of a private one (:func:`pipeline_group` hands its shared pool in);
    ``faults`` is a chaos injector (sites ``dispatch``, ``marshal``,
    ``transfer`` and ``result``; None in production)."""

    def __init__(self, compiled: ProgramCompileResult, device=None,
                 depth: int = 2, index_policy: str = "strict",
                 backend: str = "cuda", pool: Optional[BufferPool] = None,
                 faults=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if index_policy not in ap.INDEX_POLICIES:
            raise ValueError(f"index_policy {index_policy!r} not in "
                             f"{ap.INDEX_POLICIES}")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        self.compiled = compiled
        self.device = resolve_device(device)
        self.depth = depth
        self.backend = backend
        self._units = [_UnitState(u) for u in compiled.units]
        for u in self._units:
            u.plan = u.res.access_plan or ap.build_plan(u.res.op, u.group)
        self.pool = pool or BufferPool(n_slots=max(2, depth + 1),
                                       pin=self.device.type == "cuda")
        self._pool_tag = object()         # private-pool key namespace
        self._slots_packed: list = []     # slots the current dispatch used
        self._txn: Optional[TransferBatch] = None   # the wave being staged
        self._deferred = False            # this dispatch deferred a unit
        self._inflight: deque = deque()
        self._steps = 0
        # "strict" raises a typed MalformedAccessError on a bad stream;
        # "clamp"/"drop" repair per lookup and count
        self.index_policy = index_policy
        self.faults = faults
        self.stats = {"steps": 0, "table_stacks": 0, "table_restacks": 0,
                      "table_rebinds": 0, "marshal_hits": 0,
                      "marshal_misses": 0, "max_inflight": 0,
                      "host_syncs": 0, "oob_lookups": 0,
                      "dropped_lookups": 0, "resets": 0}

    def _fire(self, site: str) -> None:
        if self.faults is not None:
            self.faults.fire(site, program=self.compiled.program.name)

    # ------------------------------------------------------------------
    # Marshaling cache: device-resident tables + roff
    # ------------------------------------------------------------------

    def _src_tables(self, u: _UnitState, inputs: dict) -> list:
        """The unit's source tables, one per stacked slot (the plan's slot
        order -- shared slots read once)."""
        if u.group is None:
            key = "x" if u.res.op.kind == "fusedmm" else "table"
            srcs = [inputs[u.unit.names[0]][key]]
        else:
            srcs = [inputs[name]["table"]
                    for name in u.plan.slot_first_member]
        for t in srcs:
            if not isinstance(t, torch.Tensor) or t.device != self.device:
                raise TypeError(
                    f"tables must be tensors on {self.device}, got "
                    f"{type(t).__name__} on {getattr(t, 'device', 'host')} "
                    "(see repro_torch.convert.program_inputs_to_torch)")
        return srcs

    def _bind_unit(self, u: _UnitState, inputs: dict) -> None:
        srcs = self._src_tables(u, inputs)
        u.src_refs = tuple(weakref.ref(a) for a in srcs)
        u.table = None    # a rebind frees the old stack before the new cat
        # a single-slot stack aliases the caller's tensor -- only a tensor
        # built here (cat) may later be updated in place
        u.owns_table = len(srcs) > 1
        u.table = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=0)
        if u.group is not None and u.roff is None:
            u.roff = torch.from_numpy(u.plan.roff).to(self.device)

    def update_tables(self, inputs: dict) -> None:
        """Refresh the stacked tables after the member tables changed (e.g.
        a train step updated the embeddings): ``copy_`` into the owned
        stacked tensor, in place.

        ``inputs`` may be partial: units with any member absent are left
        untouched, and units already bound to these exact tensors are
        skipped.  An owned multi-slot stack is refreshed in place
        (``table_restacks``); an aliased single table just rebinds the
        reference (``table_rebinds``)."""
        todo = []
        for u in self._units:
            if not all(n in inputs for n in u.unit.names):
                continue
            if u.table is not None and \
                    u.sources_unchanged(self._src_tables(u, inputs)):
                continue
            todo.append(u)
        if not todo:
            return
        self.drain()   # in-flight steps must not see a half-updated table
        for u in todo:
            if u.table is None:
                self._bind_unit(u, inputs)
                self.stats["table_stacks"] += 1
                continue
            srcs = self._src_tables(u, inputs)
            u.src_refs = tuple(weakref.ref(a) for a in srcs)
            if u.group is not None and u.owns_table:
                blk = u.plan.blk
                for slot, part in zip(u.plan.slots, srcs):
                    lo = slot.base * blk
                    u.table[lo:lo + part.shape[0]].copy_(part)
                self.stats["table_restacks"] += 1
            else:   # the bound tensor aliases caller data: never write it
                u.table = srcs[0]
                self.stats["table_rebinds"] += 1

    # ------------------------------------------------------------------
    # Per-step access-stream marshaling (bucketed, pinned, rotating)
    # ------------------------------------------------------------------

    def _scratch_for(self, unit_idx: int, bucket: tuple, spec: dict):
        """Rotating host scratch per (unit, capacity bucket), or per buffer
        spec in a shared pool: the slot's tensors and their numpy views
        (for packing)."""
        self._fire("marshal")
        key = self.pool.key_for((self._pool_tag, unit_idx), bucket, spec)
        entry, turn, created = self.pool.acquire(key, spec)
        self.stats["marshal_misses" if created else "marshal_hits"] += 1
        self._slots_packed.append((entry, turn))
        slot = entry["slots"][turn]
        return slot, {k: t.numpy() for k, t in slot.items()}

    def _put(self, t: torch.Tensor) -> torch.Tensor:
        """Host -> device copy of one per-step operand (counted in
        ``host_syncs``).  Asynchronous from pinned staging on the card; a
        copy on the CPU, so a reused staging slot never aliases an output."""
        self._fire("transfer")
        self.stats["host_syncs"] += 1
        if self.device.type == "cpu":
            return t.clone()
        return t.to(self.device, non_blocking=True)

    @staticmethod
    def _host(arr, dtype) -> torch.Tensor:
        """A caller-owned host array as a tensor (no staging)."""
        return torch.from_numpy(np.ascontiguousarray(arr, dtype))

    def _trim(self, host: dict, nnz: int) -> dict:
        """The stock-op backend reads exactly ``nnz`` lookups: drop the
        capacity padding on the host, so it is never copied either."""
        if self.backend == "torch":
            for k in ("idxs", "vals"):
                if k in host:
                    host[k] = host[k][:nnz]
        return host

    def _marshal_csr(self, idx: int, u: _UnitState, inputs: dict):
        """Fused CSR unit: the AccessPlan gives the per-member CSR shapes,
        the capacity bucket and the offset-merged pack; this method manages
        the rotating scratch.  Returns (device constants, host operands)."""
        plan = u.plan
        op = plan.op
        parts, nnz, _ = plan.csr_parts(inputs)
        cap = plan.lattice.lookup_capacity(nnz)
        spec = {"ptrs": ((op.num_segments + 1,), np.int32),
                "idxs": ((cap,), np.int32)}
        if plan.need_vals:
            spec["vals"] = ((cap,), np.dtype(op.dtype))
        slot, buf = self._scratch_for(idx, (cap,), spec)
        plan.pack_csr(buf, parts, inputs)
        buf["idxs"][nnz:cap] = 0          # pad rows stay in bounds
        if plan.need_vals:
            buf["vals"][nnz:cap] = 0
        return ({"table": u.table, "roff": u.roff},
                self._trim(dict(slot), nnz))

    def _marshal_gather(self, idx: int, u: _UnitState, inputs: dict):
        plan = u.plan
        slot, buf = self._scratch_for(
            idx, (), {"idxs": ((plan.num_segments,), np.int32)})
        plan.pack_gather(buf, inputs)
        return {"table": u.table, "roff": u.roff}, {"idxs": slot["idxs"]}

    def _marshal_single(self, idx: int, u: _UnitState, inputs: dict):
        """Singleton unit: the per-step operands, bucketing the ragged CSR
        streams to the plan's capacity lattice."""
        op = u.res.op
        ins = inputs[u.unit.names[0]]
        if op.kind == "gather":
            return ({"table": u.table},
                    {"idxs": self._host(ins["idxs"], np.int32)})
        if op.kind == "kg":
            return ({"table": u.table},
                    {"idxs": self._host(ins["idxs"], np.int32),
                     "vals": self._host(ins["vals"], np.dtype(op.dtype))})
        if op.index_format == "lengths" and "ptrs" not in ins:
            ptrs = np.zeros(op.num_segments + 1, np.int64)
            np.cumsum(ins["lens"], out=ptrs[1:])
        else:
            ptrs = np.asarray(ins["ptrs"], np.int64)
        nnz = int(ptrs[-1])
        cap = u.plan.lattice.lookup_capacity(nnz)
        need_vals = u.plan.need_vals and "vals" in ins
        spec = {"ptrs": ((op.num_segments + 1,), np.int32),
                "idxs": ((cap,), np.int32)}
        if need_vals:
            spec["vals"] = ((cap,), np.dtype(op.dtype))
        slot, buf = self._scratch_for(idx, (cap,), spec)
        buf["ptrs"][:] = ptrs
        buf["idxs"][:nnz] = ins["idxs"]
        buf["idxs"][nnz:cap] = 0
        if need_vals:
            buf["vals"][:nnz] = ins["vals"]
            buf["vals"][nnz:cap] = 0
        # fusedmm's dense operand x: per-step data, bound by identity
        return ({"x" if op.kind == "fusedmm" else "table": u.table},
                self._trim(dict(slot), nnz))

    # ------------------------------------------------------------------
    # Step loop
    # ------------------------------------------------------------------

    def _harden_unit(self, u: _UnitState, inputs: dict) -> dict:
        """Validate the unit's offset streams against its AccessPlan under
        this executor's ``index_policy`` before any marshaling reads them
        (the kernels do not bounds-check).  Clean streams return the same
        dict object."""
        fallback = u.unit.names[0] if u.group is None else None
        hardened, oob, dropped = u.plan.harden_step(
            inputs, self.index_policy, fallback_name=fallback)
        self.stats["oob_lookups"] += oob
        self.stats["dropped_lookups"] += dropped
        return hardened

    def _execute(self, u: _UnitState, dev: dict) -> torch.Tensor:
        if self.backend == "torch":
            return bt.execute(u.res.op, dev)
        return bc.execute(u.res, dev)

    def _unit_run(self, u: _UnitState):
        """The unit's deferred launch, ``run(dev_inputs) -> {op name:
        output}`` (memoized on the unit)."""
        run = getattr(u, "txn_run", None)
        if run is not None:
            return run
        if u.group is None:
            name = u.unit.names[0]

            def run(d, u=u, name=name):
                return {name: self._execute(u, d)}
        else:
            members = tuple(zip(u.group.members, u.group.member_ops,
                                u.group.seg_offsets))

            def run(d, u=u, members=members):
                fused = self._execute(u, d)
                return {name: fused[off:off + mop.num_segments]
                        for name, mop, off in members}
        u.txn_run = run
        return run

    def _defers(self, u: _UnitState) -> bool:
        """As in the reference, only stock-op gather units ride a wave's
        TransferBatch; kernel units launch inside ``submit``."""
        kind = u.res.op.kind
        return (self._txn is not None and self.backend == "torch" and
                (kind == "gather" or (u.group is None and kind == "kg")))

    def _dispatch(self, inputs: dict) -> dict:
        outs: dict = {}
        for idx, u in enumerate(self._units):
            uin = self._harden_unit(u, inputs)
            if u.table is None:
                self._bind_unit(u, uin)
                self.stats["table_stacks"] += 1
            elif not u.sources_unchanged(self._src_tables(u, uin)):
                # different table objects (fresh tensors, another model's
                # params): rebind rather than serve stale tables
                self._bind_unit(u, uin)
                self.stats["table_rebinds"] += 1
            if u.group is None:
                consts, host = self._marshal_single(idx, u, uin)
            elif u.group.op.kind == "gather":
                consts, host = self._marshal_gather(idx, u, uin)
            else:
                consts, host = self._marshal_csr(idx, u, uin)
            if self._defers(u):
                # stage the host streams on the wave's batch; the launch
                # runs at its flush
                staged = {**consts,
                          **{k: self._txn.put(t) for k, t in host.items()}}
                self._txn.defer(outs, self._unit_run(u), staged)
                self._deferred = True
                continue
            dev = {**consts, **{k: self._put(t) for k, t in host.items()}}
            outs.update(self._unit_run(u)(dev))
        return outs

    def submit(self, inputs: dict, txn: Optional[TransferBatch] = None
               ) -> StepHandle:
        """Dispatch one step asynchronously: marshal + copy + launch now,
        block never.  At ``depth`` steps in flight the oldest is drained
        first (backpressure), so step N+1's host packing overlaps step N's
        kernels.

        With ``txn`` (:meth:`PipelineGroup.submit_wave`), stock-op gather
        units stage their streams on the shared :class:`TransferBatch` and
        their launch is deferred to its flush: the handle is ``deferred``
        until then, and its event is the one the flush records after the
        wave's last launch.  Otherwise the event is recorded here, after
        this step's launches."""
        self._fire("dispatch")
        while len(self._inflight) >= self.depth:
            self._inflight.popleft().result()
        self._slots_packed = []
        self._txn, self._deferred = txn, False
        try:
            outs = self._dispatch(inputs)
        finally:
            self._txn = None
        h = StepHandle(outs, self._steps, faults=self.faults)
        if self._deferred:
            h.deferred = True
            txn.handles.append(h)
        elif self.device.type == "cuda":
            h.event = torch.cuda.Event()
            h.event.record(torch.cuda.current_stream(self.device))
        for entry, turn in self._slots_packed:
            entry["owners"][turn] = h     # slot busy until h's event
        self._steps += 1
        self.stats["steps"] += 1
        self._inflight.append(h)
        self.stats["max_inflight"] = max(self.stats["max_inflight"],
                                         len(self._inflight))
        return h

    def step(self, inputs: dict) -> dict:
        """Synchronous convenience: submit + wait for this step's result."""
        h = self.submit(inputs)
        if h in self._inflight:
            self._inflight.remove(h)
        return h.result()

    def run_steps(self, steps) -> list:
        """Run a sequence of step inputs through the overlapped loop;
        returns each step's outputs, in order."""
        handles = [self.submit(ins) for ins in steps]
        return [h.result() for h in handles]

    def drain(self) -> None:
        while self._inflight:
            self._inflight.popleft().result()

    def reset(self) -> None:
        """Fault recovery: abandon every in-flight step and free its staging
        slots.  The abandoned handles are marked ``done`` (their outputs must
        not be consumed); device tables survive."""
        for h in self._inflight:
            h.done = True
        self._inflight.clear()
        self._slots_packed = []
        self._txn = None
        self.pool.release_all()
        self.stats["resets"] += 1

    def use_pool(self, pool: BufferPool) -> None:
        """Re-home host staging onto ``pool`` (the pipeline-group join).
        Slots of the old pool still owned by in-flight handles stay alive
        through those handles; new marshals draw from the shared rings."""
        self.pool = pool


# ---------------------------------------------------------------------------
# Pipeline group: compiled programs overlapped through one shared staging
# pool -- cross-program access/execute overlap
# ---------------------------------------------------------------------------

class PipelineGroup:
    """Cross-program pipelining over a shared :class:`BufferPool`.

    A serving wave is programs back to back (the decode embed of wave W+1,
    the MoE un-dispatch of wave W); run through separate executors they
    serialize at each program's own backpressure.  The group re-homes every
    member onto one shared pool (entries keyed by buffer spec, so
    same-shaped staging is one ring) and accounts in-flight steps per
    program, so one program's marshal proceeds while another executes.

    ``depth`` is the group-level backpressure bound (default: the sum of
    the members' depths)."""

    def __init__(self, executors, names=None, depth: Optional[int] = None,
                 n_slots: Optional[int] = None,
                 max_slots: Optional[int] = None):
        if not executors:
            raise ValueError("pipeline_group needs at least one executor")
        self.executors = list(executors)
        self.names = list(names) if names is not None else [
            ex.compiled.program.name for ex in self.executors]
        if len(set(self.names)) != len(self.names):
            raise ValueError(f"ambiguous program names: {self.names}")
        devices = {ex.device for ex in self.executors}
        if len(devices) != 1:
            raise ValueError(f"members run on different devices: {devices}")
        self.device = devices.pop()
        self._by_name = dict(zip(self.names, self.executors))
        slots = n_slots or max(max(2, ex.depth + 1)
                               for ex in self.executors)
        self.pool = BufferPool(n_slots=slots, max_slots=max_slots,
                               pin=self.device.type == "cuda", shared=True)
        for ex in self.executors:
            ex.drain()                  # old-pool slots settle before rehome
            ex.use_pool(self.pool)
        self.depth = depth or sum(ex.depth for ex in self.executors)
        self._inflight: deque = deque()   # (name, StepHandle)
        # group-level chaos injector (sites: dispatch at submit_wave,
        # transfer at the wave flush, result on the wave's handles); set by
        # the server so cached member executors stay untouched
        self.faults = None
        self.stats = {
            "submitted": {n: 0 for n in self.names},
            "in_flight": {n: 0 for n in self.names},
            "max_in_flight": {n: 0 for n in self.names},
            "group_drains": 0,
            "waves": 0,
            "batched_arrays": 0,
            "batched_copies": 0,
            "resets": 0,
        }

    def _fire(self, site: str) -> None:
        if self.faults is not None:
            self.faults.fire(site, group=tuple(self.names))

    def executor(self, name: str) -> ProgramExecutor:
        return self._by_name[name]

    def _gc(self) -> None:
        """Drop handles resolved elsewhere (member backpressure, caller
        ``result()``) from the group ledger."""
        live: deque = deque()
        for n, h in self._inflight:
            if h.done:
                self.stats["in_flight"][n] -= 1
            else:
                live.append((n, h))
        self._inflight = live

    def _account(self, name: str, h: StepHandle) -> None:
        self._inflight.append((name, h))
        st = self.stats
        st["submitted"][name] += 1
        st["in_flight"][name] += 1
        st["max_in_flight"][name] = max(st["max_in_flight"][name],
                                        st["in_flight"][name])

    def _drain_to(self, bound: int) -> None:
        while len(self._inflight) > bound:
            n0, h0 = self._inflight.popleft()
            h0.result()
            self.stats["in_flight"][n0] -= 1
            self.stats["group_drains"] += 1

    def submit(self, name: str, inputs: dict) -> StepHandle:
        """Dispatch one step of member ``name`` asynchronously, under both
        the member's own depth bound and the group bound."""
        self._gc()
        self._drain_to(self.depth - 1)
        h = self._by_name[name].submit(inputs)
        self._account(name, h)
        return h

    def step(self, name: str, inputs: dict) -> dict:
        """Synchronous convenience: group submit + wait for the result."""
        return self.submit(name, inputs).result()

    def submit_wave(self, wave: dict) -> dict:
        """Submit one serving wave -- ``{program name: inputs}`` -- across
        members as one co-scheduled dispatch: every member marshals onto a
        shared :class:`TransferBatch`, and the flush ships the staged
        streams in one copy and launches the deferred runs.  Returns
        ``{name: StepHandle}``."""
        self._fire("dispatch")
        self._gc()
        self._drain_to(max(0, self.depth - len(wave)))
        txn = TransferBatch(self.device)
        handles = {name: self._by_name[name].submit(inputs, txn=txn)
                   for name, inputs in wave.items()}
        self._flush_wave(txn)
        if self.faults is not None:
            for h in handles.values():
                h.faults = self.faults
        self.stats["waves"] += 1
        self.stats["batched_arrays"] += txn.n_arrays
        for name, h in handles.items():
            self._account(name, h)
        return handles

    def _flush_wave(self, txn: TransferBatch) -> None:
        """Flush the wave's deferred launches: one packed pinned buffer from
        the shared pool, one copy, the runs in order, one event after the
        last of them (every deferred handle's event)."""
        self._fire("transfer")
        if txn.fills:
            self.stats["batched_copies"] += 1
        txn.flush(self.pool)

    def drain(self) -> None:
        for ex in self.executors:
            ex.drain()
        for _, h in self._inflight:
            h.result()
        self._gc()

    def reset(self) -> None:
        """Fault recovery across the whole group: abandon every member's
        in-flight steps (a faulted wave may have left staged transfers),
        clear the group ledger and release the shared pool's slot owners.
        The next :meth:`submit_wave` starts clean; bound tables survive."""
        for _, h in self._inflight:
            h.done = True
        self._inflight.clear()
        for n in self.names:
            self.stats["in_flight"][n] = 0
        for ex in self.executors:
            ex.reset()
        self.stats["resets"] += 1

    def group_stats(self) -> dict:
        """Per-program in-flight accounting + the shared pool's counters."""
        self._gc()
        return {
            "programs": list(self.names),
            "depth": self.depth,
            "submitted": dict(self.stats["submitted"]),
            "in_flight": dict(self.stats["in_flight"]),
            "max_in_flight": dict(self.stats["max_in_flight"]),
            "group_drains": self.stats["group_drains"],
            "waves": self.stats["waves"],
            "batched_arrays": self.stats["batched_arrays"],
            "batched_copies": self.stats["batched_copies"],
            "resets": self.stats["resets"],
            "pool": dict(self.pool.stats),
        }


def pipeline_group(executors, names=None, depth: Optional[int] = None,
                   n_slots: Optional[int] = None,
                   max_slots: Optional[int] = None) -> PipelineGroup:
    """Join ``executors`` into a :class:`PipelineGroup` sharing one staging
    pool.  ``names`` defaults to each executor's program name."""
    return PipelineGroup(executors, names=names, depth=depth,
                         n_slots=n_slots, max_slots=max_slots)


# ---------------------------------------------------------------------------
# Executor cache: one steady-state executor per program signature
# ---------------------------------------------------------------------------

_EXECUTOR_CACHE = BoundedLru(16)


def executor_for(program: EmbeddingProgram, opt_level: str = "O3",
                 vlen: int = 128, budget: Optional[FusionBudget] = None,
                 depth: int = 2, device=None,
                 index_policy: str = "strict",
                 backend: str = "cuda") -> ProgramExecutor:
    """The steady-state entry point: compile (compile-cache backed) and
    return the memoized executor for this signature on ``device`` (the CUDA
    card unless ``device="cpu"``; raises without a card) with ``backend``
    (``"cuda"``: the kernels, ``"torch"``: stock ops).

    The key is the program's structural signature: a hit can hand back an
    executor whose tables another caller bound, which the per-step identity
    check resolves (same tensors: warm fast path; other tensors: rebind)."""
    dev = resolve_device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    budget = budget or FusionBudget()
    key = (program.signature(), opt_level, vlen, budget, depth, str(dev),
           index_policy, backend)
    ex = _EXECUTOR_CACHE.get(key)
    if ex is not None:
        return ex
    compiled = compile_program(program, opt_level, vlen=vlen, budget=budget)
    ex = ProgramExecutor(compiled, device=dev, depth=depth,
                         index_policy=index_policy, backend=backend)
    _EXECUTOR_CACHE.put(key, ex)
    return ex


def executor_cache_stats() -> dict:
    s = _EXECUTOR_CACHE.stats()
    s["entries_by_shards"] = entries_by_shards(_EXECUTOR_CACHE)
    return s


def set_executor_cache_limit(limit: int) -> int:
    return _EXECUTOR_CACHE.set_limit(limit)


def clear_executor_cache() -> None:
    _EXECUTOR_CACHE.clear()
