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

Not ported yet (ROADMAP.md): meshes and vocab sharding, the hot slab and its
adaptive swaps, the disaggregated service, fault injection, serving
artifacts, ``PipelineGroup`` / ``TransferBatch``, and the stock-op
``backend="jax"`` counterpart.
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
from .cost_model import FusionBudget
from .ops import EmbeddingProgram
from .passes.fuse import FusedGroup
from .pipeline import BoundedLru, ProgramCompileResult, compile_program


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
    may still run; :meth:`result` is the consume point."""

    outputs: dict                 # op name -> tensor
    index: int                    # step number within the executor
    event: Optional[torch.cuda.Event] = None   # recorded after the launches
    done: bool = False

    def ready(self) -> bool:
        """True once the step's copies and kernels have finished (never
        blocks)."""
        return self.done or self.event is None or self.event.query()

    def result(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        self.done = True
        return self.outputs


class BufferPool:
    """Rotating host staging buffers behind the per-step marshaling.

    Each entry is a small ring of identically-shaped buffer sets (pinned
    host tensors when the executor runs on the card, so the copies are
    asynchronous); every slot remembers the :class:`StepHandle` that last
    packed it.  A slot is free once that step's event has completed.  When
    every slot is busy the ring grows (up to ``max_slots``); a full ring
    waits for the oldest owner's event (``forced_drains``)."""

    def __init__(self, n_slots: int = 2, max_slots: Optional[int] = None,
                 pin: bool = False):
        self.n_slots = max(2, n_slots)
        self.max_slots = max(self.n_slots, max_slots or self.n_slots * 4)
        self.pin = pin
        self._entries: dict = {}
        self.stats = {"entries": 0, "hits": 0, "misses": 0, "grown": 0,
                      "forced_drains": 0, "bytes": 0}

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
    refreshes in place when the same objects changed."""

    def __init__(self, compiled: ProgramCompileResult, device=None,
                 depth: int = 2, index_policy: str = "strict"):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if index_policy not in ap.INDEX_POLICIES:
            raise ValueError(f"index_policy {index_policy!r} not in "
                             f"{ap.INDEX_POLICIES}")
        self.compiled = compiled
        self.device = resolve_device(device)
        self.depth = depth
        self._units = [_UnitState(u) for u in compiled.units]
        for u in self._units:
            u.plan = u.res.access_plan or ap.build_plan(u.res.op, u.group)
        self.pool = BufferPool(n_slots=max(2, depth + 1),
                               pin=self.device.type == "cuda")
        self._slots_packed: list = []     # slots the current dispatch used
        self._inflight: deque = deque()
        self._steps = 0
        # "strict" raises a typed MalformedAccessError on a bad stream;
        # "clamp"/"drop" repair per lookup and count
        self.index_policy = index_policy
        self.stats = {"steps": 0, "table_stacks": 0, "table_restacks": 0,
                      "table_rebinds": 0, "marshal_hits": 0,
                      "marshal_misses": 0, "max_inflight": 0,
                      "host_syncs": 0, "oob_lookups": 0,
                      "dropped_lookups": 0, "resets": 0}

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
        """Rotating host scratch per (unit, capacity bucket): the slot's
        tensors and their numpy views (for packing)."""
        key = (unit_idx, bucket)
        entry, turn, created = self.pool.acquire(key, spec)
        self.stats["marshal_misses" if created else "marshal_hits"] += 1
        self._slots_packed.append((entry, turn))
        slot = entry["slots"][turn]
        return slot, {k: t.numpy() for k, t in slot.items()}

    def _put(self, t: torch.Tensor) -> torch.Tensor:
        """Host -> device copy of one per-step operand (counted in
        ``host_syncs``).  Asynchronous from pinned staging on the card; a
        copy on the CPU, so a reused staging slot never aliases an output."""
        self.stats["host_syncs"] += 1
        if self.device.type == "cpu":
            return t.clone()
        return t.to(self.device, non_blocking=True)

    def _put_host(self, arr, dtype) -> torch.Tensor:
        """A caller-owned host array straight to the device (no staging)."""
        return self._put(torch.from_numpy(np.ascontiguousarray(arr, dtype)))

    def _marshal_csr(self, idx: int, u: _UnitState, inputs: dict) -> dict:
        """Fused CSR unit: the AccessPlan gives the per-member CSR shapes,
        the capacity bucket and the offset-merged pack; this method manages
        the rotating scratch and the copy."""
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
        dev = {k: self._put(t) for k, t in slot.items()}
        dev["table"], dev["roff"] = u.table, u.roff
        return dev

    def _marshal_gather(self, idx: int, u: _UnitState, inputs: dict) -> dict:
        plan = u.plan
        slot, buf = self._scratch_for(
            idx, (), {"idxs": ((plan.num_segments,), np.int32)})
        plan.pack_gather(buf, inputs)
        return {"table": u.table, "roff": u.roff,
                "idxs": self._put(slot["idxs"])}

    def _marshal_single(self, idx: int, u: _UnitState, inputs: dict) -> dict:
        """Singleton unit: copy the per-step operands to the device,
        bucketing the ragged CSR streams to the plan's capacity lattice."""
        op = u.res.op
        ins = inputs[u.unit.names[0]]
        if op.kind == "gather":
            return {"table": u.table,
                    "idxs": self._put_host(ins["idxs"], np.int32)}
        if op.kind == "kg":
            return {"table": u.table,
                    "idxs": self._put_host(ins["idxs"], np.int32),
                    "vals": self._put_host(ins["vals"], np.dtype(op.dtype))}
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
        dev = {k: self._put(t) for k, t in slot.items()}
        # fusedmm's dense operand x: per-step data, bound by identity
        dev["x" if op.kind == "fusedmm" else "table"] = u.table
        return dev

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
                dev = self._marshal_single(idx, u, uin)
                outs[u.unit.names[0]] = bc.execute(u.res, dev)
                continue
            if u.group.op.kind == "gather":
                dev = self._marshal_gather(idx, u, uin)
            else:
                dev = self._marshal_csr(idx, u, uin)
            fused = bc.execute(u.res, dev)
            for name, mop, off in zip(u.group.members, u.group.member_ops,
                                      u.group.seg_offsets):
                outs[name] = fused[off:off + mop.num_segments]
        return outs

    def submit(self, inputs: dict) -> StepHandle:
        """Dispatch one step asynchronously: marshal + copy + launch now,
        block never.  At ``depth`` steps in flight the oldest is drained
        first (backpressure), so step N+1's host packing overlaps step N's
        kernels."""
        while len(self._inflight) >= self.depth:
            self._inflight.popleft().result()
        self._slots_packed = []
        outs = self._dispatch(inputs)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        h = StepHandle(outs, self._steps, event=event)
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
        self.pool.release_all()
        self.stats["resets"] += 1


# ---------------------------------------------------------------------------
# Executor cache: one steady-state executor per program signature
# ---------------------------------------------------------------------------

_EXECUTOR_CACHE = BoundedLru(16)


def executor_for(program: EmbeddingProgram, opt_level: str = "O3",
                 vlen: int = 128, budget: Optional[FusionBudget] = None,
                 depth: int = 2, device=None,
                 index_policy: str = "strict") -> ProgramExecutor:
    """The steady-state entry point: compile (compile-cache backed) and
    return the memoized executor for this signature on ``device`` (the CUDA
    card unless ``device="cpu"``; raises without a card).

    The key is the program's structural signature: a hit can hand back an
    executor whose tables another caller bound, which the per-step identity
    check resolves (same tensors: warm fast path; other tensors: rebind)."""
    dev = resolve_device(device)
    budget = budget or FusionBudget()
    key = (program.signature(), opt_level, vlen, budget, depth, str(dev),
           index_policy)
    ex = _EXECUTOR_CACHE.get(key)
    if ex is not None:
        return ex
    compiled = compile_program(program, opt_level, vlen=vlen, budget=budget)
    ex = ProgramExecutor(compiled, device=dev, depth=depth,
                         index_policy=index_policy)
    _EXECUTOR_CACHE.put(key, ex)
    return ex


def clear_executor_cache() -> None:
    _EXECUTOR_CACHE.clear()
