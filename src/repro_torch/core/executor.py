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

**Sharded programs** -- pass ``mesh`` (a ``DeviceMesh`` over an initialised
process group: :func:`repro_torch.launch.mesh.make_host_mesh`) and the
fused units' stacked tables are vocab-partitioned over its ``shard_axis``
per each unit's compiled AccessPlan: each rank is one process with one
executor and holds a 1/S stripe of every slot's cold tail plus the
replicated hot slab (the classified Zipf head: ``hot_rows``).  Every rank
is handed the same step inputs, routes the whole step on its host (the
plan's deterministic routing, so the ranks agree without talking) and
keeps its own part; the device bodies are in :mod:`.shard_plan`.
``exchange="host"`` ships the rank's routed bucket; ``"collective"`` (the
default on 2 or more shards) ships the rank's row of the send lattice and
runs the index exchange as an ``all_to_all``.  Pooled outputs are
all-reduced to every rank (``replicate_outputs=True``, the host
exchange's default) or reduce-scattered (the collective's default): rank r
then owns fused segments ``[r·seg_cap, (r+1)·seg_cap)`` and ``step``
returns each op's rows it owns, which may be none
(:meth:`ProgramExecutor.output_rows` gives their range,
:meth:`ProgramExecutor.full_outputs` all-gathers the whole view).  The
reference returns a global array instead (ROADMAP.md, deliberate
differences).  ``adaptive`` (a ``data.locality.AdaptiveHotConfig``) makes
the hot slab a live cache: windowed row counts re-rank it when the hot
hit-rate drifts, and :meth:`ProgramExecutor.swap_hot_slab` restacks the
local tables in place.  A 1-wide mesh is the single-device executor.

**The disaggregated tier** (``service="disagg"``, ``service_pool=`` a
:class:`repro_torch.runtime.embedding_service.ServicePool`, duck-typed so
``core`` never imports ``runtime``): a step's index streams go to a
replica process that holds the tables on its own device and runs the
program there; the request leaves at :meth:`ProgramExecutor.submit` and
the reply is consumed at :meth:`StepHandle.result`, so the submit/result
overlap hides the hop.  The reply's tensors are copied to the client's
device: the same bits, in the dtype the in-process path returns.  The
tables are shipped once, at the first step, and again only when other
table objects arrive (after a drain).  While every replica is dark
(``ServiceUnavailable``) the ``degrade_policy`` decides: a step whose
lookups all fall in the client's hot slab (``hot_rows``) runs here, and
so does every other step under ``"stale"`` (the local tables, on the
client's device, through the same kernels); under ``"fail"`` it raises
typed.

**Serving artifacts** (``executor_for(..., artifact_dir=)``,
:mod:`.artifact`): a boot loads the compile result instead of compiling
when the committed artifact's fingerprint and identity match, else
compiles fresh and saves it back.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import deque
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import access_plan as ap
from . import backend_cuda as bc
from . import backend_torch as bt
from . import cost_model
from . import shard_plan as sp
from .cost_model import FusionBudget
from .ops import EmbeddingProgram
from .passes.fuse import FusedGroup
from .pipeline import (BoundedLru, ProgramCompileResult, compile_program,
                       entries_by_shards)

BACKENDS = ("cuda", "torch")
SERVICES = ("inproc", "disagg")
DEGRADE_POLICIES = ("fail", "stale")


def _check_service(service: str, service_pool, degrade_policy: str,
                   shards: int) -> None:
    """The disaggregated tier's arguments, validated as the reference
    asserts them."""
    if service not in SERVICES:
        raise ValueError(f"service {service!r} not in {SERVICES}")
    if degrade_policy not in DEGRADE_POLICIES:
        raise ValueError(f"degrade_policy {degrade_policy!r} not in "
                         f"{DEGRADE_POLICIES}")
    if service == "disagg":
        if service_pool is None:
            raise ValueError("service='disagg' requires a service_pool")
        if shards > 1:
            raise ValueError("the disaggregated service is a single-shard "
                             "client path")


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
    # a disaggregated step: a zero-argument resolver of the outputs still
    # on the wire (the RPC left at submit, the reply is consumed here)
    pending: object = None

    def ready(self) -> bool:
        """True once the step's copies and kernels have finished (never
        blocks)."""
        if self.done:
            return True
        if self.deferred or self.pending is not None:
            return False
        return self.event is None or self.event.query()

    def result(self) -> dict:
        if self.faults is not None:
            self.faults.fire("result", step=self.index)
        if self.deferred:
            raise RuntimeError(f"step {self.index}: result() before its "
                               "wave's TransferBatch was flushed")
        if self.pending is not None:
            fn, self.pending = self.pending, None
            self.outputs.update(fn())
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
    ``transfer`` and ``result``; None in production).

    ``mesh`` / ``shard_axis`` / ``hot_rows`` / ``exchange`` /
    ``replicate_outputs`` / ``adaptive`` select the vocab-sharded paths
    (module docstring); the mesh's device type must be the executor's.
    ``service`` / ``service_pool`` / ``degrade_policy`` select the
    disaggregated tier, a single-shard client path; there ``hot_rows`` is
    the slab a dark pool's step may still serve here."""

    def __init__(self, compiled: ProgramCompileResult, device=None,
                 depth: int = 2, index_policy: str = "strict",
                 backend: str = "cuda", pool: Optional[BufferPool] = None,
                 faults=None, mesh=None, shard_axis: str = "model",
                 hot_rows=None, exchange: Optional[str] = None,
                 replicate_outputs: Optional[bool] = None, adaptive=None,
                 service: str = "inproc", service_pool=None,
                 degrade_policy: str = "fail"):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if index_policy not in ap.INDEX_POLICIES:
            raise ValueError(f"index_policy {index_policy!r} not in "
                             f"{ap.INDEX_POLICIES}")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        if exchange not in (None, "host", "collective"):
            raise ValueError(f"exchange {exchange!r} not in (None, 'host', "
                             "'collective')")
        _check_service(service, service_pool, degrade_policy,
                       sp.shard_count(mesh, shard_axis))
        self.compiled = compiled
        self.device = resolve_device(device)
        self.depth = depth
        self.backend = backend
        self.shards = sp.shard_count(mesh, shard_axis)
        # a 1-wide mesh IS the single-device executor (bit-identical path)
        self.mesh = mesh if self.shards > 1 else None
        self.shard_axis = shard_axis
        # the index exchange of the sharded streams: "collective" (the
        # default on >= 2 shards) sends each rank's row of the send lattice
        # through all_to_all; "host" routes each rank its bucket
        self.exchange = ("host" if self.shards == 1
                         else (exchange or "collective"))
        # pooled outputs all-reduced to every rank, or reduce-scattered to
        # the owner of each segment slice (the collective's default)
        if replicate_outputs is None:
            replicate_outputs = self.exchange == "host"
        self.replicate_outputs = bool(replicate_outputs) \
            if self.shards > 1 else True
        # the disaggregated tier: steps go to the replica pool instead of
        # running here; the degrade policy decides what a step does while
        # every replica is dark (module docstring)
        self.service = service
        self.service_pool = service_pool
        self.degrade_policy = degrade_policy
        # the client's hot slab: what a dark pool's step may serve here
        self._svc_hot = (
            {n: np.unique(np.asarray(list(ids), dtype=np.int64))
             for n, ids in dict(hot_rows).items()}
            if (service == "disagg" and hot_rows) else {})
        self._svc_srcs: Optional[tuple] = None  # weakrefs: tables shipped
        # hot/cold vocab classification ({op name: replicated row ids});
        # only meaningful on sharded executors
        self.hot_rows = dict(hot_rows) if (hot_rows and self.shards > 1) \
            else {}
        self._hot_spec = ap.canonical_hot(self.hot_rows)
        # adaptive hot-slab re-classification: a sliding window of per-row
        # counts drives live slab swaps (swap_hot_slab) and hot-aware spill
        # routing.  The windowed hot/cold counters are always kept: they
        # are the drift observable window_stats() shows on every executor.
        from ..data.locality import AdaptiveHotConfig, WindowedCounts
        if adaptive is not None and not isinstance(adaptive,
                                                   AdaptiveHotConfig):
            raise TypeError("adaptive must be an AdaptiveHotConfig or None")
        self.adaptive = adaptive
        _w = adaptive or AdaptiveHotConfig()
        self._win_stride = max(1, _w.window_steps // _w.num_windows)
        self._win_ring = np.zeros((_w.num_windows, 2), np.int64)  # hot, cold
        self._win_slot = 0
        self._win_steps = 0
        self._win_full = False
        self.slab_epoch = 0
        self._adapt_counts = {}           # op name -> WindowedCounts
        self._adapt_ref: Optional[float] = None  # post-swap reference rate
        self._adapt_last_swap = 0
        self._adapt_refine = 0            # settling passes still owed
        if adaptive is not None:
            for name, op in compiled.program.ops:
                if (self.shards > 1 and name in self.hot_rows) or \
                        name in self._svc_hot:
                    self._adapt_counts[name] = WindowedCounts(
                        op.num_embeddings, adaptive.window_steps,
                        adaptive.num_windows)
        self._units = [_UnitState(u) for u in compiled.units]
        for u in self._units:
            u.plan = self._plan_for(u)
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
                      "exchange_index_bytes": 0, "exchange_row_bytes": 0,
                      "hot_lookups": 0, "cold_lookups": 0,
                      "host_syncs": 0, "oob_lookups": 0,
                      "dropped_lookups": 0, "resets": 0,
                      "hot_swaps": 0, "hot_swaps_rejected": 0,
                      "spilled_lookups": 0, "collectives": 0,
                      "staged_bytes": 0, "collective_ms": 0.0,
                      "result_bytes": 0, "rpc_steps": 0, "hot_local_steps": 0,
                      "stale_steps": 0, "degraded_failed_steps": 0}
        self.rank = 0
        self._coll: Optional[sp.Collectives] = None
        if self.mesh is not None:
            if self.mesh.device_type != self.device.type:
                raise ValueError(f"the mesh is on {self.mesh.device_type}, "
                                 f"the executor on {self.device}")
            self.rank = self.mesh.get_local_rank(shard_axis)
            self._coll = sp.Collectives(self.mesh.get_group(shard_axis),
                                        self.device, self.stats)
        # per op: (rows, fused row offset, seg_cap) where this rank's
        # output is an owned slice of a reduce-scattered unit, else None
        self._owned: dict = {}
        for u in self._units:
            for name, n, off in self._members(u):
                self._owned[name] = ((n, off, u.plan.seg_cap)
                                     if self._owns_slices(u) else None)
        # serving artifact (attach_artifact): where this executor's
        # compile came from, and where save_artifact publishes it
        self.compile_source = "fresh"     # fresh | artifact
        self._artifact_dir: Optional[Path] = None
        self._artifact_meta: Optional[dict] = None

    def _fire(self, site: str) -> None:
        if self.faults is not None:
            self.faults.fire(site, program=self.compiled.program.name)

    # ------------------------------------------------------------------
    # Serving artifact (core/artifact.py)
    # ------------------------------------------------------------------

    def attach_artifact(self, artifact_dir, meta: dict,
                        source: str = "fresh") -> None:
        """Tie this executor to a serving artifact: ``source`` says where
        its compile came from, :meth:`save_artifact` publishes there."""
        self._artifact_dir = Path(artifact_dir)
        self._artifact_meta = dict(meta)
        self.compile_source = source

    def save_artifact(self) -> Optional[Path]:
        """Publish the compile result (atomic re-publish; idempotent).
        None when no artifact is attached."""
        if self._artifact_dir is None or self._artifact_meta is None:
            return None
        from . import artifact as art
        return art.save_artifact(self._artifact_dir, self.compiled,
                                 meta=self._artifact_meta)

    @staticmethod
    def _members(u: _UnitState):
        """(op name, rows, fused row offset) of each op of a unit."""
        if u.group is None:
            return [(u.unit.names[0], u.res.op.num_segments, 0)]
        return [(name, mop.num_segments, off) for name, mop, off in
                zip(u.group.members, u.group.member_ops,
                    u.group.seg_offsets)]

    def _plan_for(self, u: _UnitState) -> ap.AccessPlan:
        """The unit's AccessPlan: the compiled artifact when it matches
        this executor's shard count and hot classification, else
        respecialized (an executor built directly over a compile without
        shard information still interprets exactly one plan)."""
        plan = u.res.access_plan
        shards = self.shards if u.group is not None else 1
        hot = self.hot_rows if u.group is not None else None
        hot_spec = self._hot_spec if u.group is not None else ()
        if plan is None or plan.shards != shards or \
                plan.hot_spec != hot_spec:
            plan = ap.build_plan(u.res.op, u.group, shards=shards,
                                 hot_rows=hot, epoch=self.slab_epoch)
        elif self.adaptive is not None:
            # adaptive executors mutate plan.spill / plan.rr_start as
            # per-step feedback -- never on the shared compiled artifact
            plan = dataclasses.replace(plan, spill={}, rr_start=0,
                                       epoch=self.slab_epoch)
        return plan

    @property
    def signature(self) -> tuple:
        return (self.compiled.program.signature(), self.compiled.opt_level,
                self.compiled.vlen)

    def _sharded(self, u: _UnitState) -> bool:
        return u.group is not None and self.shards > 1

    def _owns_slices(self, u: _UnitState) -> bool:
        """Whether the unit's outputs are reduce-scattered: this rank then
        holds fused segments ``[rank·seg_cap, (rank+1)·seg_cap)``."""
        return self._sharded(u) and not self.replicate_outputs

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
            self._check_table(t)
        return srcs

    def _check_table(self, t) -> None:
        if not isinstance(t, torch.Tensor) or t.device != self.device:
            raise TypeError(
                f"tables must be tensors on {self.device}, got "
                f"{type(t).__name__} on {getattr(t, 'device', 'host')} "
                "(see repro_torch.convert.program_inputs_to_torch)")

    def _bind_unit(self, u: _UnitState, inputs: dict) -> None:
        srcs = self._src_tables(u, inputs)
        u.src_refs = tuple(weakref.ref(a) for a in srcs)
        u.table = None    # a rebind frees the old stack before the new one
        if self._sharded(u):
            # this rank's local table: its stripe of each cold tail + the
            # replicated hot slabs (routed indices arrive fully rebased, so
            # the kernel's seg_base stream is all zero)
            u.table = sp.local_stack_table(srcs, u.plan, self.rank)
            u.owns_table = True
            if u.roff is None:
                u.roff = torch.zeros(u.plan.num_segments, dtype=torch.int32,
                                     device=self.device)
            return
        # a single-slot stack aliases the caller's tensor -- only a tensor
        # built here (cat) may later be updated in place
        u.owns_table = len(srcs) > 1
        u.table = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=0)
        if u.group is not None and u.roff is None:
            u.roff = torch.from_numpy(u.plan.roff).to(self.device)

    def update_tables(self, inputs: dict) -> None:
        """Refresh the stacked tables after the member tables changed (e.g.
        a train step updated the embeddings): ``copy_`` into the owned
        stacked tensor, in place (a sharded unit rewrites its local
        table).

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
            if self._sharded(u):
                sp.local_stack_table(srcs, u.plan, self.rank, out=u.table)
                self.stats["table_restacks"] += 1
            elif u.group is not None and u.owns_table:
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
    # Sharded fused units: the routed index exchange + the device bodies
    # ------------------------------------------------------------------

    def _count_row_bytes(self, op, blk: int, plan: ap.AccessPlan) -> None:
        """Pooled-rows-back volume of one sharded step: the all-reduce
        ships every shard's partials everywhere ((S-1)·B·E·4); the
        reduce-scatter leaves each shard only its own segment slice -- 1/S
        of that, plus the padding rows of the scatter grid."""
        s = self.shards
        width = blk * op.emb_len * 4
        if self.replicate_outputs:
            self.stats["exchange_row_bytes"] += \
                op.num_segments * width * (s - 1)
        else:
            self.stats["exchange_row_bytes"] += \
                plan.padded_segments * width * (s - 1) // s

    def _body_kw(self, plan: ap.AccessPlan) -> dict:
        return dict(coll=self._coll, backend=self.backend,
                    replicate=self.replicate_outputs, shards=self.shards,
                    seg_cap=plan.seg_cap)

    def _run_csr_sharded(self, idx: int, u: _UnitState, inputs: dict):
        """Fused CSR unit over S vocab shards, host exchange: the
        AccessPlan merges the member streams and routes every lookup to its
        owning shard (hot rows resolve to the replicated slab and pay no
        exchange); this rank packs its own bucket, pools it locally and the
        partial pools combine."""
        if self.exchange == "collective":
            return self._run_csr_collective(idx, u, inputs)
        plan = u.plan
        op = plan.op
        need_vals = plan.need_vals
        routed = plan.route_csr(inputs)
        cap, r = routed["cap"], self.rank
        spec = {"ptrs": ((op.num_segments + 1,), np.int32),
                "idxs": ((cap,), np.int32)}
        if need_vals:
            spec["vals"] = ((cap,), np.dtype(op.dtype))
        slot, buf = self._scratch_for(idx, ("shard", cap), spec)
        buf["ptrs"][:] = routed["ptrs"][r]
        lo, hi = routed["bounds"][r], routed["bounds"][r + 1]
        buf["idxs"][:hi - lo] = routed["idxs"][lo:hi]
        buf["idxs"][hi - lo:] = 0         # pad rows must stay in bounds
        if need_vals:
            buf["vals"][:hi - lo] = routed["vals"][lo:hi]
            buf["vals"][hi - lo:] = 0
        # only the cold tail is exchanged; hot lookups were absorbed by the
        # replicated slab (a local lookup on a round-robin shard)
        self.stats["exchange_index_bytes"] += \
            routed["cold_nnz"] * (8 if need_vals else 4)
        self._note_hot_cold(routed["hot_nnz"], routed["cold_nnz"])
        # next step's round-robin hot assignment starts at the shard whose
        # routed bucket was lightest this step
        if self.adaptive is not None:
            plan.rr_start = int(np.argmin(routed["nnz"]))
        self._count_row_bytes(op, 1, plan)
        ptrs, idxs = self._put(slot["ptrs"]), self._put(slot["idxs"])
        vals = self._put(slot["vals"]) if need_vals else None
        return sp.csr_host_body(
            u.table, u.roff, ptrs, idxs, vals, add_op=op.semiring.add,
            mul_op=op.semiring.mul, nseg=op.num_segments,
            **self._body_kw(plan))

    def _run_csr_collective(self, idx: int, u: _UnitState, inputs: dict):
        """Fused CSR unit over S vocab shards, collective exchange: the
        AccessPlan packs the step into the (src, dst) send lattice, this
        rank ships its own row of it, and the index exchange runs as an
        ``all_to_all`` on the device side (hot lookups sit on the
        diagonal: no wire traffic)."""
        plan = u.plan
        op = plan.op
        need_vals = plan.need_vals
        routed = plan.route_csr_collective(inputs)
        s, cap = self.shards, routed["cap"]
        spec = {"ints": ((s, s, 2, cap), np.int32)}
        if need_vals:
            spec["vals"] = ((s, s, cap), np.dtype(op.dtype))
        slot, buf = self._scratch_for(idx, ("coll", cap), spec)
        plan.fill_lattice(routed, buf["ints"],
                          buf["vals"] if need_vals else None)
        # wire volume: only off-diagonal (src != owner) lookups cross a
        # link; each carries its segment id + local index (+ val)
        self.stats["exchange_index_bytes"] += \
            routed["wire_nnz"] * (12 if need_vals else 8)
        self._note_hot_cold(routed["hot_nnz"], routed["cold_nnz"])
        self.stats["spilled_lookups"] += routed.get("spilled_nnz", 0)
        # feedback for the NEXT step: an overloaded source diagonal spills
        # a bounded fraction of its hot lookups to the least-loaded peer
        if self.adaptive is not None:
            plan.spill = sp.compute_spill(routed["pair_counts"],
                                          self.adaptive.spill_fraction,
                                          self.adaptive.spill_overload)
        self._count_row_bytes(op, 1, plan)
        ints = self._put(slot["ints"][self.rank])
        vals = self._put(slot["vals"][self.rank]) if need_vals else None
        return sp.csr_collective_body(
            u.table, u.roff, ints, vals, add_op=op.semiring.add,
            mul_op=op.semiring.mul, nseg=op.num_segments,
            **self._body_kw(plan))

    def _run_gather_sharded(self, idx: int, u: _UnitState, inputs: dict):
        plan = u.plan
        n = plan.num_segments
        blk = plan.op.block_rows
        s = self.shards
        if self.exchange == "collective":
            routed = plan.route_gather_collective(inputs)
            cap = routed["cap"]
            slot, buf = self._scratch_for(
                idx, ("gather-coll", cap),
                {"ints": ((s, s, 2, cap), np.int32)})
            plan.fill_lattice(routed, buf["ints"])
            self.stats["exchange_index_bytes"] += \
                routed["wire_segments"] * 8   # seg + idx word
            fused = sp.gather_collective_body(
                u.table, self._put(slot["ints"][self.rank]), blk=blk,
                nseg=n, **self._body_kw(plan))
        else:
            routed = plan.route_gather(inputs)
            slot, buf = self._scratch_for(
                idx, ("gather",), {"idxs": ((n,), np.int32),
                                   "mask": ((n,), np.float32)})
            buf["idxs"][:] = routed["idxs"][self.rank]
            buf["mask"][:] = routed["mask"][self.rank]
            self.stats["exchange_index_bytes"] += \
                routed["cold_segments"] * 8   # idx + mask word
            fused = sp.gather_host_body(
                u.table, u.roff, self._put(slot["idxs"]),
                self._put(slot["mask"]), blk=blk, **self._body_kw(plan))
        self._note_hot_cold(routed["hot_segments"], routed["cold_segments"])
        self._count_row_bytes(plan.op, blk, plan)
        return fused

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

    def _split(self, u: _UnitState, fused: torch.Tensor) -> dict:
        """A fused unit's output split per member op: each op's rows, or,
        with owned (reduce-scattered) outputs, the rows of each op this
        rank owns (``fused`` holds the rank's segment slice)."""
        base = self.rank * u.plan.seg_cap if self._owns_slices(u) else 0
        out = {}
        for name, _, off in self._members(u):
            lo, hi = self.output_rows(name)
            out[name] = fused[off + lo - base:off + hi - base]
        return out

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
            def run(d, u=u):
                return self._split(u, self._execute(u, d))
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
            if self._sharded(u):
                # epoch-checked marshaling: the plan interpreted here must
                # be the one the local table was stacked under -- a
                # mismatch means a half-applied slab swap
                if u.plan.epoch != self.slab_epoch:
                    raise RuntimeError(
                        f"stale access plan (epoch {u.plan.epoch} != slab "
                        f"epoch {self.slab_epoch}) -- swap_hot_slab left a "
                        f"unit behind")
                fused = (self._run_gather_sharded(idx, u, uin)
                         if u.group.op.kind == "gather"
                         else self._run_csr_sharded(idx, u, uin))
                outs.update(self._split(u, fused))
                continue
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
        block never (a sharded step's collectives wait for their peers).
        At ``depth`` steps in flight the oldest is drained first
        (backpressure), so step N+1's host packing overlaps step N's
        kernels.

        With ``txn`` (:meth:`PipelineGroup.submit_wave`), stock-op gather
        units stage their streams on the shared :class:`TransferBatch` and
        their launch is deferred to its flush: the handle is ``deferred``
        until then, and its event is the one the flush records after the
        wave's last launch.  Otherwise the event is recorded here, after
        this step's launches.  Sharded executors ignore ``txn``."""
        self._fire("dispatch")
        while len(self._inflight) >= self.depth:
            self._inflight.popleft().result()
        self._slots_packed = []
        if self._adapt_counts:
            self._adapt_observe(inputs)
            if self.service == "disagg":
                self._note_svc_traffic(inputs)
        self._deferred = False
        pending = None
        if self.service == "disagg":
            outs, pending = self._submit_disagg(inputs)
        else:
            self._txn = txn if self.shards == 1 else None
            try:
                outs = self._dispatch(inputs)
            finally:
                self._txn = None
        h = StepHandle(outs, self._steps, faults=self.faults,
                       pending=pending)
        if self._deferred:
            h.deferred = True
            txn.handles.append(h)
        elif pending is None and self.device.type == "cuda":
            h.event = torch.cuda.Event()
            h.event.record(torch.cuda.current_stream(self.device))
        for entry, turn in self._slots_packed:
            entry["owners"][turn] = h     # slot busy until h's event
        self._steps += 1
        self.stats["steps"] += 1
        self._inflight.append(h)
        self.stats["max_inflight"] = max(self.stats["max_inflight"],
                                         len(self._inflight))
        self._win_tick()
        if self.adaptive is not None:
            self._adapt_tick()
        return h

    def step(self, inputs: dict) -> dict:
        """Synchronous convenience: submit + wait for this step's result."""
        h = self.submit(inputs)
        if h in self._inflight:     # an end-of-submit slab swap drains the
            self._inflight.remove(h)    # queue before we get here
        return h.result()

    # ------------------------------------------------------------------
    # Disaggregated service path (service="disagg")
    # ------------------------------------------------------------------

    def _svc_tables(self, inputs: dict) -> dict:
        tables = {}
        for name, op in self.compiled.program.ops:
            t = inputs[name]["x" if op.kind == "fusedmm" else "table"]
            self._check_table(t)
            tables[name] = t
        return tables

    def _svc_sync(self, inputs: dict) -> None:
        """Ship the tables to the pool on the first step, or when other
        table objects arrive: the identity discipline of
        :meth:`_bind_unit`.  Stable tables never re-ship; a change drains
        the in-flight remote steps first, so they land on the tables they
        were submitted against.  A table two ops share is shipped once."""
        tables = self._svc_tables(inputs)
        srcs = tuple(tables.values())
        if self._svc_srcs is not None and \
                len(self._svc_srcs) == len(srcs) and \
                all(r() is a for r, a in zip(self._svc_srcs, srcs)):
            return
        host, seen = {}, {}
        for n, t in tables.items():
            if id(t) not in seen:
                seen[id(t)] = t.detach().to("cpu")
            host[n] = seen[id(t)]
        if self._svc_srcs is None:
            self.service_pool.bind(
                self.compiled.program, host,
                opt_level=self.compiled.opt_level, vlen=self.compiled.vlen,
                backend=self.backend, index_policy=self.index_policy,
                hot_spec={n: tuple(int(i) for i in v)
                          for n, v in self._svc_hot.items()} or None)
            self.stats["table_stacks"] += 1
        else:
            self.drain()
            self.service_pool.update_tables(host)
            self.stats["table_rebinds"] += 1
        self._svc_srcs = tuple(weakref.ref(a) for a in srcs)

    def _submit_disagg(self, inputs: dict):
        """Send the step's index streams to the pool; the reply is
        consumed at :meth:`StepHandle.result` through the handle's
        ``pending`` resolver.  ``ServiceUnavailable`` (the pool's bounded
        retry found every replica dark) resolves by the degrade policy;
        every other fault propagates typed."""
        self._svc_sync(inputs)
        streams: dict = {}
        for name, op in self.compiled.program.ops:
            tkey = "x" if op.kind == "fusedmm" else "table"
            for k, v in inputs[name].items():
                if k != tkey:
                    streams[f"{name}/{k}"] = np.asarray(v)
        self.stats["rpc_steps"] += 1
        try:
            fut = self.service_pool.submit_step(streams)
        except ap.ServiceUnavailable as e:
            return self._degrade_outputs(inputs, e), None

        def pending() -> dict:
            try:
                outs = fut.wait()
            except ap.ServiceUnavailable as e:
                return self._degrade_outputs(inputs, e)
            return {n: torch.as_tensor(t).to(self.device)
                    for n, t in outs.items()}

        return {}, pending

    def _step_all_hot(self, inputs: dict) -> bool:
        """True when every lookup of this step stays inside the client's
        hot slab."""
        if not self._svc_hot:
            return False
        for name, op in self.compiled.program.ops:
            hot = self._svc_hot.get(name)
            if hot is None:
                return False
            idxs = np.asarray(inputs[name].get("idxs", ()))
            if idxs.size and not np.isin(idxs, hot).all():
                return False
        return True

    def _degrade_outputs(self, inputs: dict, cause) -> dict:
        """Resolve a step while the service tier is dark: a hot-slab step
        always runs here; another runs here on the local tables under
        ``degrade_policy="stale"`` or re-raises typed under ``"fail"`` --
        each path counted."""
        if self._step_all_hot(inputs):
            self.stats["hot_local_steps"] += 1
        elif self.degrade_policy == "stale":
            self.stats["stale_steps"] += 1
        else:
            self.stats["degraded_failed_steps"] += 1
            raise cause
        # the local run binds the local tables on the first dark step; its
        # staging slots are owned by no handle, so the copies and kernels
        # finish before they can be repacked
        outs = self._dispatch(inputs)
        self._slots_packed = []
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return outs

    def _note_svc_traffic(self, inputs: dict) -> None:
        """Disagg steps route nothing here, so an adaptive client feeds the
        hot/cold window itself: each index stream split against its hot
        slab."""
        for name, hot in self._svc_hot.items():
            ins = inputs.get(name)
            if ins is None or "idxs" not in ins:
                continue
            idxs = np.asarray(ins["idxs"]).ravel()
            if idxs.size:
                nh = int(np.isin(idxs, hot).sum())
                self._note_hot_cold(nh, idxs.size - nh)

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

    # ------------------------------------------------------------------
    # Sharded outputs
    # ------------------------------------------------------------------

    def output_rows(self, name: str) -> tuple:
        """The rows ``[lo, hi)`` of op ``name``'s output that this rank's
        step returns: all of them, or with owned (reduce-scattered)
        outputs the ones in its segment slice (``lo == hi``: none)."""
        owned = self._owned[name]
        if owned is None:
            return 0, dict(self.compiled.program.ops)[name].num_segments
        n, off, seg_cap = owned
        return sp.owned_range(n, off, self.rank, seg_cap)

    def full_outputs(self, outs: dict) -> dict:
        """Every op's whole output from a step's ``outs`` on this rank:
        owned slices all-gathered from every rank (one ``all_gather`` an
        op, so every rank of the mesh axis must call it), the rest as they
        are."""
        full = {}
        for name, t in outs.items():
            owned = self._owned[name]
            if owned is None:
                full[name] = t
                continue
            n, off, seg_cap = owned
            sizes = [b - a for a, b in (sp.owned_range(n, off, r, seg_cap)
                                        for r in range(self.shards))]
            full[name] = sp.all_gather_rows(self._coll, t, sizes, seg_cap)
        return full

    # ------------------------------------------------------------------
    # Adaptive locality: windowed counters, drift detection, slab swap
    # ------------------------------------------------------------------

    def _note_hot_cold(self, hot: int, cold: int) -> None:
        """Count one routing's hot/cold split: cumulative stats AND the
        sliding-window ring drift detection reads."""
        self.stats["hot_lookups"] += hot
        self.stats["cold_lookups"] += cold
        self._win_ring[self._win_slot, 0] += hot
        self._win_ring[self._win_slot, 1] += cold

    def _win_tick(self) -> None:
        """Advance the hot/cold window ring by one step (rotating out the
        oldest stripe each ``window_steps / num_windows`` steps)."""
        self._win_steps += 1
        if self._win_steps % self._win_stride == 0:
            self._win_slot = (self._win_slot + 1) % len(self._win_ring)
            if self._win_slot == 0:
                self._win_full = True
            self._win_ring[self._win_slot] = 0

    def window_stats(self) -> dict:
        """Hot/cold traffic over the last window -- the drift observable.
        Unlike the lifetime-cumulative ``stats["hot_lookups"]``, these age
        out: a head rotation shows within one window.  The re-classifier
        and operators read the same snapshot."""
        hot = int(self._win_ring[:, 0].sum())
        cold = int(self._win_ring[:, 1].sum())
        total = hot + cold
        span = self._win_stride * len(self._win_ring)
        return {
            "window_steps": span,
            "steps_in_window": min(self._win_steps, span),
            "window_full": self._win_full,
            "hot_lookups": hot,
            "cold_lookups": cold,
            "hot_traffic_fraction": round(hot / total, 4) if total else 0.0,
            "adaptive": self.adaptive is not None,
            "slab_epoch": self.slab_epoch,
            "hot_swaps": self.stats["hot_swaps"],
            "hot_swaps_rejected": self.stats["hot_swaps_rejected"],
            "spilled_lookups": self.stats["spilled_lookups"],
            "reference_hot_fraction": self._adapt_ref,
        }

    def _adapt_observe(self, inputs: dict) -> None:
        """Feed the step's index streams into the per-op windowed row
        counters (the re-classifier's ranking signal)."""
        for name, wc in self._adapt_counts.items():
            ins = inputs.get(name)
            if ins is not None and "idxs" in ins:
                wc.add(np.asarray(ins["idxs"]))

    def _adapt_tick(self) -> None:
        """Drift detection, once per step: compare the windowed hot
        hit-rate with the reference captured over the first full window
        after the last (re)classification; a collapse below
        ``drift_threshold × reference`` re-ranks and swaps the slab."""
        cfg = self.adaptive
        if cfg is None or not self._adapt_counts or not self._win_full:
            return
        span = self._win_stride * len(self._win_ring)
        if self._adapt_refine > 0:
            # settling pass: the window has refilled since the reactive
            # swap flushed it, so the ranking sees post-swap traffic only;
            # drift detection stays paused while the slab settles
            if self._win_steps % span == 0:
                self._adapt_refine -= 1
                self._reclassify()
            return
        hot = int(self._win_ring[:, 0].sum())
        cold = int(self._win_ring[:, 1].sum())
        if not hot + cold:
            return
        frac = hot / (hot + cold)
        if self._adapt_ref is None:
            self._adapt_ref = float(frac)
            return
        if frac >= cfg.drift_threshold * self._adapt_ref:
            # healthy window: let a better-than-reference rate raise the bar
            self._adapt_ref = max(self._adapt_ref, float(frac))
            return
        if self._steps - self._adapt_last_swap < cfg.min_swap_interval:
            return
        self._adapt_last_swap = self._steps
        if self._reclassify():
            # the reactive ranking saw pre-drift history: flush the window
            # and counters so the settling passes rank on clean data
            self._reset_windows()
            self._adapt_refine = cfg.refine_passes

    def _reset_windows(self) -> None:
        """Flush the hot/cold ring and every per-op count sketch (after a
        reactive swap, so settling passes rank on post-swap traffic)."""
        self._win_ring[:] = 0
        self._win_slot = 0
        self._win_steps = 0
        self._win_full = False
        for wc in self._adapt_counts.values():
            wc.reset()

    def _reclassify(self) -> bool:
        """Re-rank each tracked op's hot set from its windowed counts and
        swap the slab (size-preserving -- see ``classify_hot_from_counts``).
        Returns True when a swap happened."""
        from ..data.locality import classify_hot_from_counts
        prev = self.hot_rows if self.shards > 1 else self._svc_hot
        new: dict = {}
        for name, wc in self._adapt_counts.items():
            prev_ids = np.asarray(sorted(int(i) for i in
                                         prev.get(name, ())),
                                  np.int64)
            if not len(prev_ids):
                continue
            ids = classify_hot_from_counts(wc.totals(), len(prev_ids),
                                           prev_hot=prev_ids)
            new[name] = tuple(int(i) for i in ids)
        return bool(new) and self.swap_hot_slab(new)

    def swap_hot_slab(self, hot_rows) -> bool:
        """Swap the replicated hot slab in place: same shapes, new
        membership.  Per-slot hot counts (and so the local table's shape,
        the capacity lattice and every staging bucket) are unchanged, so
        the swap re-ranks the plans and rewrites the local tables in place.
        A candidate set that WOULD change a slot's geometry (shared-table
        slot unions can) is rejected and counted, never half-applied.
        Returns True when a swap happened."""
        new_hot = {n: tuple(int(i) for i in ids)
                   for n, ids in dict(hot_rows).items()}
        new_spec = ap.canonical_hot(new_hot)
        if self.service == "disagg":
            cur = ap.canonical_hot({n: tuple(int(i) for i in v)
                                    for n, v in self._svc_hot.items()})
            if new_spec == cur:
                return False
            self.drain()
            self._svc_hot = {n: np.unique(np.asarray(list(ids), np.int64))
                             for n, ids in new_hot.items()}
            self.slab_epoch += 1
            self.stats["hot_swaps"] += 1
            self._adapt_ref = None
            self._adapt_last_swap = self._steps
            # republished through the pool's warm artifact, so a replica
            # respawned from now on re-warms with the current slab
            publish = getattr(self.service_pool, "publish_hot_spec", None)
            if publish is not None:
                publish(new_hot)
            return True
        if self.shards == 1 or new_spec == self._hot_spec:
            return False
        epoch = self.slab_epoch + 1
        rebuilt: list = []
        for u in self._units:
            if u.group is None:
                continue
            plan = ap.build_plan(u.res.op, u.group, shards=self.shards,
                                 hot_rows=new_hot, epoch=epoch)
            old = u.plan
            if plan.local_rows != old.local_rows or any(
                    a.hot_rows != b.hot_rows or a.cap != b.cap
                    for a, b in zip(plan.slots, old.slots)):
                self.stats["hot_swaps_rejected"] += 1
                return False
            plan.rr_start, plan.spill = old.rr_start, dict(old.spill)
            rebuilt.append((u, plan))
        self.drain()    # restacked tables must not be read by old steps
        self.hot_rows, self._hot_spec = new_hot, new_spec
        for u, plan in rebuilt:
            u.plan = plan
            if u.table is None:
                continue
            srcs = [r() for r in (u.src_refs or ())]
            if not srcs or any(s is None for s in srcs):
                u.table = None          # sources gone: rebind next step
                continue
            sp.local_stack_table(srcs, plan, self.rank, out=u.table)
            self.stats["table_restacks"] += 1
        self.slab_epoch = epoch
        self.stats["hot_swaps"] += 1
        self._adapt_ref = None
        self._adapt_last_swap = self._steps
        return True

    def access_plan_stats(self) -> dict:
        """The compiled access side, observable: per-plan hot/cold layout,
        the cost model's exchange estimate against the measured counters,
        and the plan-build time the ``plan-access`` pass recorded."""
        fused = [u for u in self._units if u.group is not None]
        steps = self.stats["steps"]
        est = [cost_model.exchange_bytes(
                   u.group.member_ops, self.shards,
                   replicate_outputs=self.replicate_outputs,
                   collective=self.exchange == "collective")
               for u in fused]
        est_idx = sum(e["index_bytes"] for e in est) * steps
        hot = self.stats["hot_lookups"]
        cold = self.stats["cold_lookups"]
        total = hot + cold
        return {
            "shards": self.shards,
            "exchange": self.exchange,
            "replicate_outputs": self.replicate_outputs,
            "host_syncs": self.stats["host_syncs"],
            "host_syncs_per_step": round(
                self.stats["host_syncs"] / steps, 2) if steps else 0.0,
            "exchange_row_bytes": self.stats["exchange_row_bytes"],
            "exchange_row_bytes_est": sum(e["row_bytes"]
                                          for e in est) * steps,
            "units": len(self._units),
            "fused_units": len(fused),
            "hot_rows": sum(u.plan.hot_rows_total for u in fused),
            "hot_slab_bytes": sum(u.plan.hot_slab_bytes for u in fused),
            "hot_lookups": hot,
            "cold_lookups": cold,
            "hot_traffic_fraction": round(hot / total, 4) if total else 0.0,
            "exchange_index_bytes": self.stats["exchange_index_bytes"],
            # the interleaved (no hot slab) cost-model estimate -- actual
            # below it means the hot slab absorbed that much routed volume
            "exchange_index_bytes_est": est_idx,
            "exchange_savings_bytes": max(
                0, est_idx - self.stats["exchange_index_bytes"]),
            "hot_swaps": self.stats["hot_swaps"],
            "spilled_lookups": self.stats["spilled_lookups"],
            "window": self.window_stats(),
            "plan_build_s": round(sum(
                r.duration_s for r in self.compiled.pass_records()
                if r.name == "plan-access" and r.ran), 6),
        }


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
                 backend: str = "cuda", mesh=None,
                 shard_axis: str = "model", hot_rows=None,
                 exchange: Optional[str] = None,
                 replicate_outputs: Optional[bool] = None,
                 adaptive=None, service: str = "inproc",
                 service_pool=None, degrade_policy: str = "fail",
                 artifact_dir=None) -> ProgramExecutor:
    """The steady-state entry point: compile (compile-cache backed) and
    return the memoized executor for this signature on ``device`` (the CUDA
    card unless ``device="cpu"``; raises without a card) with ``backend``
    (``"cuda"``: the kernels, ``"torch"``: stock ops).

    The key is the program's structural signature: a hit can hand back an
    executor whose tables another caller bound, which the per-step identity
    check resolves (same tensors: warm fast path; other tensors: rebind).

    ``mesh`` / ``shard_axis`` select vocab-sharded execution over the
    mesh's ``shard_axis`` (a 1-wide axis, or no mesh, is the single-device
    path, and its ``hot_rows``, ``exchange`` and ``replicate_outputs`` are
    dropped); the budget is rewritten to the shard count
    (``FusionBudget.shards``, part of the compile-cache key), and
    ``hot_rows`` (``{op name: row ids}``, e.g. from
    :func:`~repro_torch.core.access_plan.hot_rows_from_traces`),
    ``exchange``, ``replicate_outputs`` and ``adaptive`` key the cache as
    in the reference.

    ``service="disagg"`` with a ``service_pool`` (and ``degrade_policy``)
    is the disaggregated client (:class:`ProgramExecutor`); it keeps its
    ``hot_rows`` on one shard (the slab a dark pool's step may serve
    here), and the pool's identity keys the cache, so two pools never
    share a client.  ``artifact_dir`` points at a serving artifact
    (:mod:`.artifact`): on a cache miss the compile result loads from it
    when its fingerprint and identity match, else it is compiled and
    saved there.  It is not part of the key: it changes where a compile
    comes from, never what it computes."""
    dev = resolve_device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    shards = sp.shard_count(mesh, shard_axis)
    _check_service(service, service_pool, degrade_policy, shards)
    service_hot = hot_rows if service == "disagg" else None
    if shards == 1:
        mesh = None
        hot_rows = None
        exchange = "host"
        replicate_outputs = True
    else:
        exchange = exchange or "collective"
        if replicate_outputs is None:
            replicate_outputs = exchange == "host"
    budget = budget or FusionBudget()
    if budget.shards != shards:
        budget = dataclasses.replace(budget, shards=shards)
    key = (program.signature(), opt_level, vlen, budget, depth, str(dev),
           index_policy, backend, mesh,
           shard_axis if mesh is not None else None,
           ap.canonical_hot(hot_rows), exchange, bool(replicate_outputs),
           adaptive, service,
           degrade_policy if service == "disagg" else None,
           service_pool.pool_id if service == "disagg" else None,
           ap.canonical_hot(service_hot))
    ex = _EXECUTOR_CACHE.get(key)
    if ex is not None:
        return ex
    compiled = None
    source = "fresh"
    ameta = None
    if artifact_dir is not None:
        from . import artifact as art
        from .pipeline import seed_compile_cache
        ameta = art.artifact_meta(program, opt_level=opt_level, vlen=vlen,
                                  budget=budget, hot_rows=hot_rows,
                                  backend=backend, device=dev)
        compiled = art.load_artifact(artifact_dir, ameta)
        if compiled is not None:
            source = "artifact"
            # later compile_program calls with this identity hit too
            seed_compile_cache(
                art.compile_key_of(program, ameta, budget=budget,
                                   hot_rows=hot_rows), compiled)
        else:
            art.note_fresh_compile()
    if compiled is None:
        compiled = compile_program(program, opt_level, vlen=vlen,
                                   budget=budget, hot_rows=hot_rows)
    ex = ProgramExecutor(compiled, device=dev, depth=depth,
                         index_policy=index_policy, backend=backend,
                         mesh=mesh, shard_axis=shard_axis,
                         hot_rows=hot_rows if shards > 1 else service_hot,
                         exchange=exchange,
                         replicate_outputs=replicate_outputs,
                         adaptive=adaptive, service=service,
                         service_pool=service_pool,
                         degrade_policy=degrade_policy)
    if artifact_dir is not None:
        ex.attach_artifact(artifact_dir, ameta, source)
        if source == "fresh":
            ex.save_artifact()    # so the next boot loads
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
