"""Disaggregated embedding tier: the replica process and its fault-tolerant
client pool (counterpart of ``repro/runtime/embedding_service.py``).

The stacked embedding tables live in their own process pool, scalable
apart from the dense tier and restartable without killing the server; the
:class:`~repro_torch.core.executor.ProgramExecutor` reaches them over
:mod:`repro_torch.runtime.rpc`, its submit/result overlap hiding the hop
(the request leaves at ``submit``, the reply is consumed at ``result``).

**Service side** (:class:`EmbeddingService`, ``python -m
repro_torch.runtime.embedding_service --device cuda``): one process owns
the compiled program and the tables on its device (the card unless
``--device cpu``; a replica asked for the card that cannot reach it exits
at startup, it never runs on the CPU) and serves step requests: the
per-step index streams arrive over the wire, the tables never do after
bind.  Its executor is :func:`~repro_torch.core.executor.executor_for`'s
on that device, so on the card its gather and SLS units launch the
hand-written kernels in the replica's process (``ping`` reports those
launches by variant, the device's name, its peak memory, and whether
``jax`` or ``repro`` was ever imported there).  Steps replay
idempotently: each request carries a monotone per-client sequence number
and the service caches the last reply per client, so a retried request
never executes twice.  A replica that boots next to a complete *warm
artifact* (``program.json`` + a table checkpoint, written by the pool at
bind) **re-warms from it** instead of waiting for a bind RPC, and loads
its compile result from the serving artifact (:mod:`repro_torch.core
.artifact`) under ``<warm dir>/aot`` that its first life saved.  A table
two ops share (an LM's embed, read by the token embed and the label
gather) is shipped, checkpointed and held on the device once.

**Client side** (:class:`ServicePool`): N replicas serving the same
tables, round-robin dispatch with

* bounded exponential-backoff retry (:func:`repro_torch.runtime.rpc
  .backoff_delays`),
* failover: a transport failure reroutes the step (and every other step
  pending on that connection) to a live peer; the computation is
  deterministic, so a step the dead replica ran before its reply was lost
  runs again with the same result on the peer.  A rerouted step is marked
  ``failover``: with steps in flight on both replicas the peer may have
  served a later sequence number already, and runs it instead of
  refusing it as stale (the reference's replica refuses it, and the
  server's wave then fails and retries),
* a heartbeat monitor with a circuit breaker: ``breaker_misses``
  consecutive missed probes (or ``breaker_failures`` consecutive data
  failures) open the circuit; the replica is marked dark, respawned
  (bounded retry, the same backoff) and rejoins rotation only after a
  probe of its re-warmed process succeeds,
* recovery observability: each revival's seconds and the revived
  replica's ``warm_source`` / ``compile_source`` in :meth:`ServicePool
  .stats`.

What a step does while every replica is dark is the executor's
``degrade_policy``; the pool raises a typed :class:`ServiceUnavailable`
only after its bounded retry is spent.  A pool binds one program: its
replicas serve the program of the last :meth:`ServicePool.bind`, as in
the reference.

Chaos sites (``runtime/faults.py``): ``rpc_send`` / ``rpc_recv`` in the
transport, ``heartbeat`` per liveness probe, ``service_crash`` in the
service's step loop (the replica exits with ``os._exit``: the ``kill -9``
shape the failover path must absorb).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.ops import EmbeddingOp, EmbeddingProgram, Semiring
from .faults import (FAULT_TYPES, EmberFault, FaultInjector, FaultSpec,
                     InjectedFailure, RpcError, ServiceUnavailable)
from .rpc import RpcClient, backoff_delays, recv_msg, send_msg

__all__ = ["EmbeddingService", "ServicePool", "StepFuture",
           "program_to_spec", "spec_to_program", "write_warm_artifact",
           "read_warm_artifact", "TRANSPORT_FAULTS"]

#: exception classes the retry/failover loop treats as "this replica (or
#: this wire) is gone"; everything else is an application error that must
#: reach the caller typed, never trigger a reroute
TRANSPORT_FAULTS = (OSError, RpcError, InjectedFailure)

_HOST = "127.0.0.1"
#: a replica's torch CPU threads: its host work is one step at a time, and
#: test runs start several replicas beside their workers
REPLICA_THREADS = 1


# ---------------------------------------------------------------------------
# Program spec: the JSON identity of an EmbeddingProgram (bind frames and
# the warm artifact both carry it; EmbeddingOp is a flat dataclass)
# ---------------------------------------------------------------------------

def program_to_spec(program: EmbeddingProgram) -> dict:
    return {"name": program.name,
            "ops": [[n, dataclasses.asdict(op)] for n, op in program.ops],
            "shared_tables": [list(g) for g in program.shared_tables]}


def spec_to_program(spec: dict) -> EmbeddingProgram:
    ops = []
    for name, d in spec["ops"]:
        d = dict(d)
        d["semiring"] = Semiring(**d["semiring"])
        ops.append((name, EmbeddingOp(**d)))
    return EmbeddingProgram(spec["name"], tuple(ops),
                            tuple(tuple(g) for g in spec["shared_tables"]))


def _table_key(op: EmbeddingOp) -> str:
    return "x" if op.kind == "fusedmm" else "table"


def _aliases(tables: dict) -> dict:
    """``{op: the first op holding the same table object}`` for every op
    whose table another op already holds."""
    first: dict = {}
    alias: dict = {}
    for op, t in tables.items():
        if id(t) in first:
            alias[op] = first[id(t)]
        else:
            first[id(t)] = op
    return alias


def _write_program_meta(warm_dir, meta: dict) -> None:
    """Durable atomic publish of ``program.json`` through the checkpoint
    tier's fsync-before-rename helper."""
    from ..checkpoint import atomic_write_text
    atomic_write_text(Path(warm_dir) / "program.json", json.dumps(meta))


def _prune_table_steps(tables_dir: Path, keep: int = 2) -> None:
    """Keep-N retention over the warm tables.  ``keep >= 2`` so the step a
    just-superseded ``program.json`` still references survives one more
    publish."""
    from ..checkpoint import committed_steps
    for s in committed_steps(tables_dir)[:-keep]:
        (tables_dir / f"step_{s:09d}.COMMITTED").unlink(missing_ok=True)
        shutil.rmtree(tables_dir / f"step_{s:09d}", ignore_errors=True)


def write_warm_artifact(warm_dir, bind_meta: dict, tables: dict,
                        version: int) -> None:
    """Publish the re-warm artifact.  The order is the crash-safety
    contract: the table checkpoint commits FIRST, then ``program.json`` --
    stamped with the committed ``table_step`` -- publishes atomically, so a
    crash between the two leaves the previous meta with its own
    still-committed step.  A table shared by several ops is written once
    (``table_alias`` names the others)."""
    from ..checkpoint import save_checkpoint
    warm_dir = Path(warm_dir)
    warm_dir.mkdir(parents=True, exist_ok=True)
    alias = _aliases(tables)
    save_checkpoint(warm_dir / "tables", version,
                    {op: a for op, a in tables.items() if op not in alias})
    meta = dict(bind_meta)
    meta["table_alias"] = alias
    meta["table_step"] = int(version)
    _write_program_meta(warm_dir, meta)
    _prune_table_steps(warm_dir / "tables")


def read_warm_artifact(warm_dir) -> Optional[tuple]:
    """``(bind_meta, tables)`` (CPU tensors, shared tables one object) when
    a complete *consistent* artifact exists, else None.  The meta's
    ``table_step`` stamp is checked against the committed checkpoint
    steps: a meta naming a torn or pruned step is rejected rather than
    re-warming a replica with tables of another version."""
    from ..checkpoint import committed_steps, restore_checkpoint
    warm_dir = Path(warm_dir)
    pj = warm_dir / "program.json"
    if not pj.exists():
        return None
    meta = json.loads(pj.read_text())
    steps = committed_steps(warm_dir / "tables")
    step = meta.get("table_step")
    if step is None:
        # a meta without the stamp: best effort, the latest committed step
        step = steps[-1] if steps else None
    if step is None or step not in steps:
        return None
    alias = meta.get("table_alias", {})
    like = {name: np.zeros((), np.float32)
            for name, _ in meta["program"]["ops"]
            if name in meta["table_ops"] and name not in alias}
    tables, _ = restore_checkpoint(warm_dir / "tables", like, step=step)
    for op, first in alias.items():
        tables[op] = tables[first]
    return meta, tables


# ---------------------------------------------------------------------------
# Service side
# ---------------------------------------------------------------------------

def _imported_foreign() -> list:
    """The reference's packages this process has imported (none, ever)."""
    return sorted(m for m in ("jax", "repro")
                  if sys.modules.get(m) is not None)


class EmbeddingService:
    """One replica process: owns the compiled program and the tables on
    ``device``, serves step requests.  Thread per connection (the pool
    opens a data and a control connection); all program state changes
    under one lock."""

    def __init__(self, warm_dir=None, faults: Optional[FaultInjector] = None,
                 device="cpu"):
        self.warm_dir = Path(warm_dir) if warm_dir else None
        self.faults = faults
        self.device = torch.device(device)
        self.executor = None
        self.tables: dict = {}           # op name -> {"table"/"x": tensor}
        self.table_keys: dict = {}
        self.steps = 0
        self.replays = 0
        self.warm_source = "none"        # none | bind | artifact
        self.compile_source = "none"     # none | fresh | artifact
        self.hot_epoch = 0               # adaptive slab generation bound
        self._replay: dict = {}          # client id -> (seq, meta, arrays)
        self._lock = threading.Lock()
        self._stop = threading.Event()

    # -- binding -----------------------------------------------------------

    def _on_device(self, arrays: dict) -> dict:
        """``{op: {table key: tensor on the device}}``, one device copy of
        a table several ops share."""
        seen: dict = {}
        out = {}
        for op, a in arrays.items():
            if id(a) not in seen:
                seen[id(a)] = torch.as_tensor(a).to(self.device)
            out[op] = {self.table_keys[op]: seen[id(a)]}
        return out

    def _bind_from(self, meta: dict, tables: dict, source: str) -> None:
        from ..core.executor import executor_for
        program = spec_to_program(meta["program"])
        # the serving artifact beside the warm artifact: a respawned
        # replica loads its compile result instead of compiling when what
        # its previous life saved still matches
        aot_dir = self.warm_dir / "aot" if self.warm_dir is not None \
            else None
        self.executor = executor_for(
            program, meta["opt_level"], vlen=meta["vlen"], depth=2,
            device=self.device, index_policy=meta["index_policy"],
            backend=meta["backend"], artifact_dir=aot_dir)
        self.compile_source = self.executor.compile_source
        self.table_keys = {name: _table_key(op) for name, op in program.ops}
        self.tables = self._on_device(tables)
        self.warm_source = source
        # the artifact carries the CURRENT hot spec: a respawned replica
        # re-warms already knowing the post-swap slab generation
        self.hot_epoch = int(meta.get("hot_epoch", 0))

    def try_warm(self) -> bool:
        """Boot-time re-warm: a complete artifact beside this replica
        replaces the bind RPC (the respawn path never re-ships tables)."""
        if self.warm_dir is None:
            return False
        art = read_warm_artifact(self.warm_dir)
        if art is None:
            return False
        meta, tables = art
        self._bind_from(meta, tables, source="artifact")
        return True

    # -- request handlers --------------------------------------------------

    def _ping(self) -> dict:
        from ..kernels import ops as kops
        cuda = self.device.type == "cuda"
        return {"ok": True, "steps": self.steps, "pid": os.getpid(),
                "bound": self.executor is not None,
                "replays": self.replays,
                "warm_source": self.warm_source,
                "compile_source": self.compile_source,
                "hot_epoch": self.hot_epoch,
                "device": (torch.cuda.get_device_name(self.device) if cuda
                           else "cpu"),
                "launches": kops.launch_counts(),
                "variant_launches": kops.variant_launch_counts(),
                "peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                               if cuda else 0),
                "foreign_modules": _imported_foreign()}

    def _handle(self, kind: str, meta: dict, arrays: dict) -> tuple:
        if kind == "ping":
            return self._ping(), {}
        if kind == "bind":
            self._bind_from(meta, arrays, source="bind")
            return {"ok": True, "warm_source": self.warm_source}, {}
        if kind == "hot":
            # adaptive slab swap: live replicas learn the new spec epoch
            # without a table re-ship (the artifact was rewritten first)
            self.hot_epoch = int(meta.get("hot_epoch", 0))
            return {"ok": True, "hot_epoch": self.hot_epoch}, {}
        if kind == "update":
            if self.executor is None:
                raise RpcError("update before bind")
            self.tables = self._on_device(arrays)
            return {"ok": True}, {}
        if kind == "step":
            return self._step(meta, arrays)
        if kind == "shutdown":
            self._stop.set()
            return {"ok": True}, {}
        raise RpcError(f"unknown request kind {kind!r}")

    def _step(self, meta: dict, arrays: dict) -> tuple:
        client, seq = meta["client"], int(meta["seq"])
        last = self._replay.get(client)
        # a step a dead peer held, resent here: it may be older than what
        # this replica has served, and it runs (deterministic: the same
        # reply the peer would have sent) without moving the replay cache
        rerouted = bool(meta.get("failover")) and last is not None \
            and seq < last[0]
        if last is not None and not rerouted:
            if seq == last[0]:          # idempotent replay: cached reply,
                self.replays += 1       # the step does NOT run again
                return last[1], last[2]
            if seq < last[0]:
                raise RpcError(f"stale step seq {seq} < {last[0]}")
        if self.faults is not None:
            try:
                self.faults.fire("service_crash", step=self.steps)
            except InjectedFailure:
                # abrupt, not graceful: the kill -9 shape -- no reply, no
                # connection teardown, no atexit
                os._exit(137)
        if self.executor is None:
            raise RpcError("step before bind (no warm artifact either)")
        inputs: dict = {op: dict(t) for op, t in self.tables.items()}
        for key, arr in arrays.items():
            op, _, stream = key.partition("/")
            inputs.setdefault(op, {})[stream] = arr
        outs = self.executor.step(inputs)
        rmeta = {"ok": True, "seq": seq, "steps": self.steps}
        rarrays = {op: v.detach().to("cpu") for op, v in outs.items()}
        if not rerouted:
            self._replay[client] = (seq, rmeta, rarrays)
        self.steps += 1
        return rmeta, rarrays

    # -- serve loop --------------------------------------------------------

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    kind, meta, arrays = recv_msg(conn)
                except (RpcError, OSError):
                    return                    # peer gone: this conn is done
                seq = meta.get("seq")
                try:
                    try:
                        with self._lock:
                            rmeta, rarrays = self._handle(kind, meta,
                                                          arrays)
                        send_msg(conn, "ok", rmeta, rarrays)
                    except EmberFault as e:
                        err = {"error": type(e).__name__, "msg": str(e)}
                        if seq is not None:
                            err["seq"] = seq
                        send_msg(conn, "err", err)
                except OSError:
                    return               # client gone mid-reply: done
        finally:
            conn.close()

    def serve(self, portfile=None, port: int = 0) -> None:
        self.try_warm()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((_HOST, port))
        srv.listen(16)
        if portfile is not None:
            portfile = Path(portfile)
            tmp = portfile.with_suffix(".tmp")
            tmp.write_text(f"{srv.getsockname()[1]} {os.getpid()}")
            tmp.rename(portfile)     # atomic: the pool never reads a torn
        srv.settimeout(0.2)          # port file
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True).start()
        finally:
            srv.close()


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--portfile", required=True,
                    help="written atomically as '<port> <pid>' once "
                         "listening (the pool's readiness signal)")
    ap.add_argument("--warm-dir", default=None,
                    help="warm-artifact directory (program.json + table "
                         "checkpoint); a complete artifact re-warms this "
                         "replica at boot instead of a bind RPC")
    ap.add_argument("--device", default="cuda",
                    help="where the tables live and the program runs: the "
                         "CUDA card (the default; without one the replica "
                         "exits) or 'cpu' (the kernels' plain versions)")
    ap.add_argument("--crash-at", type=int, nargs="*", default=[],
                    help="1-based step ordinals where the service_crash "
                         "site fires (os._exit: the kill -9 shape)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    args = ap.parse_args(argv)
    from ..core.executor import resolve_device
    device = resolve_device(args.device)     # no card: exits here
    torch.set_num_threads(REPLICA_THREADS)
    faults = None
    if args.crash_at:
        faults = FaultInjector(
            [FaultSpec("service_crash", at=tuple(args.crash_at),
                       times=len(args.crash_at))],
            seed=args.chaos_seed)
    EmbeddingService(warm_dir=args.warm_dir, faults=faults,
                     device=device).serve(portfile=args.portfile)


# ---------------------------------------------------------------------------
# Client side: replica pool with heartbeats, breaker, failover, respawn
# ---------------------------------------------------------------------------

class StepFuture:
    """One in-flight step request.  Holds its own payload so a transport
    failure can resend it verbatim (same seq, so idempotent) to a peer."""

    __slots__ = ("pool", "seq", "meta", "arrays", "replica", "value",
                 "error", "done")

    def __init__(self, pool, seq: int, meta: dict, arrays: dict):
        self.pool = pool
        self.seq = seq
        self.meta = meta
        self.arrays = arrays
        self.replica = None
        self.value = None
        self.error: Optional[BaseException] = None
        self.done = False

    def wait(self) -> dict:
        while not self.done:
            self.pool._pump(self.replica)
        if self.error is not None:
            raise self.error
        return self.value


class _Replica:
    def __init__(self, idx: int, portfile: Path):
        self.idx = idx
        self.portfile = portfile
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.state = "starting"          # starting | live | dead
        self.client: Optional[RpcClient] = None    # data plane
        self.hb: Optional[RpcClient] = None        # control plane
        self.failures = 0                # consecutive data-plane failures
        self.misses = 0                  # consecutive missed heartbeats
        self.spawns = 0
        self.t_dead: Optional[float] = None
        self.pending: OrderedDict = OrderedDict()  # seq -> StepFuture

    def close_clients(self) -> None:
        for c in (self.client, self.hb):
            if c is not None:
                c.close()
        self.client = self.hb = None


_POOL_IDS = itertools.count(1)


class ServicePool:
    """N embedding-service replicas behind one fault-tolerant dispatch.

    The executor talks to three methods -- :meth:`bind`,
    :meth:`update_tables`, :meth:`submit_step` (and
    :meth:`publish_hot_spec` after an adaptive swap); everything else is
    the robustness machinery of the module docstring.  One serving thread
    owns the data plane; the optional heartbeat monitor owns the control
    plane and the respawn path (state flips under one lock).

    ``device`` is where every replica keeps its tables and runs the
    program: the CUDA card unless ``"cpu"`` (it is passed to each replica
    as ``--device``; a replica that cannot reach it dies at startup and
    the pool raises :class:`ServiceUnavailable`).  Use it in a ``with``
    block, or call :meth:`close`: it stops every replica it started."""

    def __init__(self, replicas: int = 2, *, device=None, warm_dir=None,
                 rpc_timeout_s: float = 30.0, retries: int = 3,
                 backoff_s: float = 0.05, breaker_failures: int = 2,
                 breaker_misses: int = 2, spawn_attempts: int = 3,
                 spawn_timeout_s: float = 120.0,
                 heartbeat_interval_s: Optional[float] = None,
                 auto_respawn: bool = True, faults=None,
                 crash_at: Optional[dict] = None, chaos_seed: int = 0):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.pool_id = next(_POOL_IDS)
        self.device = str(torch.device("cuda" if device is None else device))
        self._own_dir = warm_dir is None
        self.warm_dir = Path(warm_dir) if warm_dir else \
            Path(tempfile.mkdtemp(prefix="embsvc_"))
        self.rpc_timeout_s = rpc_timeout_s
        self.retries = max(1, int(retries))
        self.backoff_s = backoff_s
        self.breaker_failures = max(1, int(breaker_failures))
        self.breaker_misses = max(1, int(breaker_misses))
        self.spawn_attempts = max(1, int(spawn_attempts))
        self.spawn_timeout_s = spawn_timeout_s
        self.heartbeat_interval_s = heartbeat_interval_s
        self.auto_respawn = auto_respawn
        self.faults = faults             # chaos injector (client sites)
        self.crash_at = dict(crash_at or {})   # replica idx -> ordinals
        self.chaos_seed = chaos_seed
        self.client_id = f"{os.getpid()}-{self.pool_id}"
        self._seq = itertools.count(1)
        self._rr = 0
        self._lock = threading.RLock()
        self._closing = threading.Event()
        self._closed = False
        self._monitor_thread: Optional[threading.Thread] = None
        self._bind_call: Optional[tuple] = None    # (meta, arrays)
        self._table_version = 0
        self.replicas = [
            _Replica(i, self.warm_dir / f"replica_{i}.port")
            for i in range(replicas)]
        self.pool_stats = {
            "replicas": replicas, "rpc_steps": 0, "retries": 0,
            "failovers": 0, "respawns": 0, "breaker_open": 0,
            "heartbeats": 0, "hb_misses": 0, "replays": 0,
            "hot_publishes": 0,
            "recoveries_s": [], "warm_sources": [], "compile_sources": []}
        try:
            for r in self.replicas:
                self._spawn(r)
            self.wait_ready()
        except BaseException:
            self.close()                 # no replica outlives a failed boot
            raise
        if heartbeat_interval_s is not None:
            self._monitor_thread = threading.Thread(
                target=self._monitor, daemon=True)
            self._monitor_thread.start()

    # -- lifecycle ---------------------------------------------------------

    def _spawn(self, r: _Replica) -> None:
        """(Re)spawn one replica with bounded OSError retry: infra failures
        retry with exponential backoff, nothing else does."""
        r.portfile.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.runtime.embedding_service",
               "--portfile", str(r.portfile),
               "--warm-dir", str(self.warm_dir),
               "--device", self.device]
        if r.spawns == 0 and r.idx in self.crash_at:
            # chaos schedules apply to the FIRST life of a replica only;
            # its respawn must come back clean (or recovery never ends)
            ords = self.crash_at[r.idx]
            cmd += ["--crash-at", *[str(a) for a in ords],
                    "--chaos-seed", str(self.chaos_seed)]
        env = dict(os.environ)
        src = str(Path(__file__).resolve().parents[2])
        pp = env.get("PYTHONPATH", "")
        if src not in pp.split(os.pathsep):
            env["PYTHONPATH"] = f"{src}{os.pathsep}{pp}" if pp else src
        last: Optional[OSError] = None
        for delay in backoff_delays(self.spawn_attempts, self.backoff_s):
            if delay:
                time.sleep(delay)
            try:
                r.proc = subprocess.Popen(cmd, env=env)
                break
            except OSError as e:
                last = e
        else:
            raise last
        r.spawns += 1
        r.state = "starting"
        r.failures = r.misses = 0

    def _ready_port(self, r: _Replica) -> Optional[int]:
        try:
            txt = r.portfile.read_text().split()
            return int(txt[0])
        except (OSError, ValueError, IndexError):
            return None

    def wait_ready(self, timeout_s: Optional[float] = None) -> None:
        """Block until every starting replica is live (port published and
        ping answered).  A child that dies during startup respawns, up to
        ``spawn_attempts`` lives."""
        deadline = time.perf_counter() + (timeout_s or self.spawn_timeout_s)
        while time.perf_counter() < deadline:
            starting = [r for r in self.replicas if r.state == "starting"]
            if not starting:
                return
            for r in starting:
                if r.proc is not None and r.proc.poll() is not None:
                    if r.spawns >= self.spawn_attempts:
                        raise ServiceUnavailable(
                            f"replica {r.idx} died {r.spawns}x at startup "
                            f"(rc={r.proc.returncode}, device "
                            f"{self.device})")
                    self._spawn(r)
                    continue
                port = self._ready_port(r)
                if port is not None and self._probe(r, port):
                    continue
            time.sleep(0.02)
        raise ServiceUnavailable(
            f"{sum(r.state != 'live' for r in self.replicas)} replica(s) "
            f"not ready within {timeout_s or self.spawn_timeout_s}s")

    def _probe(self, r: _Replica, port: int) -> bool:
        """Ping a (re)started replica; on success it (re)joins rotation."""
        try:
            hb = RpcClient(_HOST, port, timeout_s=self.rpc_timeout_s)
            meta, _ = hb.call("ping")
        except TRANSPORT_FAULTS:
            return False
        with self._lock:
            r.port = port
            if r.hb is not None:
                r.hb.close()
            r.hb = hb
            was_dead = r.state == "dead"
            r.state = "live"
            r.failures = r.misses = 0
            if was_dead and r.t_dead is not None:
                self.pool_stats["recoveries_s"].append(
                    time.perf_counter() - r.t_dead)
                r.t_dead = None
            self.pool_stats["warm_sources"].append(meta["warm_source"])
            self.pool_stats["compile_sources"].append(
                meta.get("compile_source", "none"))
        return True

    def close(self) -> None:
        """Stop the monitor and every replica (a shutdown call, then
        terminate, then kill), and remove the pool's own warm directory."""
        if self._closed:
            return
        self._closed = True
        self._closing.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5.0)
        for r in self.replicas:
            try:
                if r.hb is not None:
                    r.hb.call("shutdown", deadline_s=1.0)
            except TRANSPORT_FAULTS:
                pass
            r.close_clients()
            if r.proc is not None and r.proc.poll() is None:
                r.proc.terminate()
        for r in self.replicas:
            if r.proc is not None:
                try:
                    r.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    r.proc.kill()
                    r.proc.wait()
        if self._own_dir:
            shutil.rmtree(self.warm_dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def kill_replica(self, idx: int) -> None:
        """SIGKILL one replica: the chaos hook (no cleanup, no goodbye:
        exactly what the failover path must absorb)."""
        r = self.replicas[idx]
        if r.proc is not None and r.proc.poll() is None:
            os.kill(r.proc.pid, signal.SIGKILL)

    # -- heartbeat monitor + circuit breaker -------------------------------

    def _monitor(self) -> None:
        while not self._closing.wait(self.heartbeat_interval_s):
            try:
                self.heartbeat_once()
            except Exception:            # noqa: BLE001 -- the monitor must
                pass                     # survive anything transient

    def heartbeat_once(self) -> None:
        """One liveness pass over the pool: probe live replicas, revive
        dark ones.  Callable directly (tests drive it without the
        thread)."""
        for r in self.replicas:
            if self._closing.is_set():
                return
            if r.state != "live":
                self._try_revive(r)
                continue
            try:
                if self.faults is not None:
                    self.faults.fire("heartbeat", replica=r.idx)
                if r.hb is None:
                    r.hb = RpcClient(_HOST, r.port,
                                     timeout_s=self.rpc_timeout_s)
                r.hb.call("ping")
                r.misses = 0
                self.pool_stats["heartbeats"] += 1
            except TRANSPORT_FAULTS:
                r.misses += 1
                self.pool_stats["hb_misses"] += 1
                if r.hb is not None:
                    r.hb.close()
                    r.hb = None
                if r.misses >= self.breaker_misses:
                    self._open_circuit(r, reason="heartbeat loss")

    def _open_circuit(self, r: _Replica, reason: str) -> None:
        """Mark a replica dark and (optionally) start its respawn.  Pending
        futures are NOT touched here: only the serving thread reroutes,
        when it observes the failure itself."""
        with self._lock:
            if r.state == "dead":
                return
            r.state = "dead"
            r.t_dead = time.perf_counter()
            self.pool_stats["breaker_open"] += 1
        if self.auto_respawn:
            self.respawn(r.idx)

    def respawn(self, idx: int) -> None:
        """Respawn a dark replica's process; it rejoins rotation when a
        later :meth:`heartbeat_once` probe of its re-warmed process
        succeeds."""
        r = self.replicas[idx]
        if r.proc is not None and r.proc.poll() is None:
            r.proc.kill()
            r.proc.wait()
        self._spawn(r)
        r.state = "dead"                 # dark until a probe passes
        self.pool_stats["respawns"] += 1

    def _try_revive(self, r: _Replica) -> None:
        if r.proc is None or r.proc.poll() is not None:
            if self.auto_respawn:
                self.respawn(r.idx)
            return
        port = self._ready_port(r)
        if port is not None:
            self._probe(r, port)

    # -- data plane: bind / update / steps ---------------------------------

    def _bind_meta(self, program, tables, *, opt_level, vlen, backend,
                   index_policy, hot_spec=None) -> dict:
        return {"program": program_to_spec(program), "opt_level": opt_level,
                "vlen": vlen, "backend": backend,
                "index_policy": index_policy, "device": self.device,
                "table_ops": sorted(tables),
                "hot_spec": ({n: sorted(int(i) for i in ids)
                              for n, ids in dict(hot_spec).items()}
                             if hot_spec else None),
                "hot_epoch": 0}

    def bind(self, program, tables: dict, **bind_kw) -> None:
        """Ship the program and its tables (CPU tensors or numpy arrays) to
        every live replica -- but FIRST publish the warm artifact, so a
        replica that dies from this moment on re-warms from it instead of
        needing a re-bind."""
        meta = self._bind_meta(program, tables, **bind_kw)
        arrays = dict(tables)
        self._table_version += 1
        write_warm_artifact(self.warm_dir, meta, arrays,
                            self._table_version)
        self._bind_call = (meta, arrays)
        self._broadcast("bind", meta, arrays)

    def update_tables(self, tables: dict) -> None:
        """Refresh the replicas' tables (artifact first, for the same
        reason).  Dark replicas pick the new version up from the artifact
        when they re-warm."""
        if self._bind_call is None:
            raise RpcError("update_tables before bind")
        meta, _ = self._bind_call
        arrays = dict(tables)
        self._table_version += 1
        write_warm_artifact(self.warm_dir, meta, arrays,
                            self._table_version)
        self._bind_call = (meta, arrays)
        self._broadcast("update", {}, arrays)

    def publish_hot_spec(self, hot_rows: dict) -> None:
        """Propagate an adaptive hot-slab swap: rewrite the warm artifact's
        ``program.json`` with the new spec and a bumped epoch (atomic; the
        table checkpoint is untouched: a swap re-ranks, it never re-ships
        rows), then notify live replicas, best effort.  An all-dark pool is
        tolerated: the artifact alone makes any replica respawned from now
        on re-warm with the current slab."""
        if self._bind_call is None:
            raise RpcError("publish_hot_spec before bind")
        meta, arrays = self._bind_call
        meta = dict(meta)
        meta["hot_spec"] = {n: sorted(int(i) for i in ids)
                            for n, ids in dict(hot_rows).items()}
        meta["hot_epoch"] = int(meta.get("hot_epoch", 0)) + 1
        warm_dir = Path(self.warm_dir)
        warm_dir.mkdir(parents=True, exist_ok=True)
        # the republished meta keeps naming the committed table step it
        # was bound with, and which ops share a table
        meta["table_step"] = int(self._table_version)
        meta["table_alias"] = _aliases(arrays)
        _write_program_meta(warm_dir, meta)
        self._bind_call = (meta, arrays)
        self.pool_stats["hot_publishes"] += 1
        try:
            self._broadcast("hot", {"hot_epoch": meta["hot_epoch"]}, {})
        except ServiceUnavailable:
            pass    # dark pool: replicas pick the spec up on re-warm

    def _broadcast(self, kind: str, meta: dict, arrays: dict) -> None:
        sent = 0
        for r in self.replicas:
            if r.state != "live":
                continue
            try:
                if r.hb is None:
                    r.hb = RpcClient(_HOST, r.port,
                                     timeout_s=self.rpc_timeout_s)
                if self.faults is not None:
                    self.faults.fire("rpc_send", kind=kind)
                r.hb.call(kind, meta, arrays,
                          deadline_s=max(self.rpc_timeout_s, 60.0))
                sent += 1
            except TRANSPORT_FAULTS:
                # a replica that missed the broadcast re-warms from the
                # artifact after its circuit opens
                self._mark_failure(r)
        if not sent:
            raise ServiceUnavailable(f"no live replica accepted {kind!r}")

    def _next_live(self, avoid: Optional[_Replica] = None
                   ) -> Optional[_Replica]:
        """The next live replica in round-robin order, ``avoid`` only where
        no other is live."""
        n = len(self.replicas)
        for skip in ((avoid,), ()):
            for k in range(n):
                r = self.replicas[(self._rr + k) % n]
                if r.state == "live" and r not in skip:
                    self._rr = (self._rr + k + 1) % n
                    return r
        return None

    def _ensure_client(self, r: _Replica) -> RpcClient:
        if r.client is None:
            r.client = RpcClient(_HOST, r.port,
                                 timeout_s=self.rpc_timeout_s)
        return r.client

    def _mark_failure(self, r: _Replica) -> None:
        """A data-plane failure on ``r`` (serving thread only): its
        connection is closed, the breaker counts it, and every step
        pending on that connection -- which can no longer answer -- is
        rerouted."""
        r.failures += 1
        if r.client is not None:
            r.client.close()
            r.client = None
        if r.failures >= self.breaker_failures or (
                r.proc is not None and r.proc.poll() is not None):
            self._open_circuit(r, reason="data-plane failure")
        self._reroute(r)

    def _reroute(self, r: _Replica) -> None:
        """Resend every step pending on ``r``'s closed connection to a live
        peer, under its own seq and marked ``failover``: the peer may have
        served a later seq already (two steps in flight round-robin), and
        must run it, not refuse it as stale.  The peer is another replica
        wherever one is live: a replica whose process is exiting can close
        its sockets before the pool sees the exit (its circuit still
        closed), and a step resent to it would fail over a second time."""
        pendings = list(r.pending.values())
        r.pending.clear()
        for fut in pendings:
            fut.replica = None
            fut.meta["failover"] = True
            try:
                self._send_future(fut, avoid=r)
                self.pool_stats["failovers"] += 1
            except ServiceUnavailable as e:
                fut.error = e
                fut.done = True

    def submit_step(self, streams: dict) -> StepFuture:
        """Send one step request (monotone seq) to the next live replica;
        returns a :class:`StepFuture` resolved at :meth:`StepFuture.wait`.
        Raises :class:`ServiceUnavailable` only after the bounded
        exponential-backoff retry found no replica to take the send."""
        seq = next(self._seq)
        fut = StepFuture(self, seq,
                         {"client": self.client_id, "seq": seq}, streams)
        self._send_future(fut)
        self.pool_stats["rpc_steps"] += 1
        return fut

    def _send_future(self, fut: StepFuture,
                     avoid: Optional[_Replica] = None) -> None:
        """Send ``fut`` to the next live replica (another than ``avoid``
        where one is live), with the bounded backoff retry."""
        last: Optional[BaseException] = None
        for k, delay in enumerate(
                backoff_delays(self.retries, self.backoff_s)):
            if delay:
                time.sleep(delay)
                self.pool_stats["retries"] += 1
            r = self._next_live(avoid)
            if r is None:
                break
            try:
                client = self._ensure_client(r)
                send_msg(client.sock, "step", fut.meta, fut.arrays,
                         faults=self.faults)
                fut.replica = r
                r.pending[fut.seq] = fut
                r.failures = 0
                return
            except TRANSPORT_FAULTS as e:
                last = e
                self._mark_failure(r)
        raise ServiceUnavailable(
            f"no live embedding-service replica accepted step "
            f"{fut.seq} after {self.retries} attempt(s)"
            + (f" (last: {type(last).__name__}: {last})" if last else ""))

    def _pump(self, r: _Replica) -> None:
        """Receive ONE frame on a replica's data connection and resolve the
        matching pending future.  A transport failure here (or a
        connection already closed) fails the replica over: every pending
        step (payloads kept) resends to a live peer under the same seq."""
        if r is None:
            raise ServiceUnavailable("step future lost its replica")
        try:
            if r.client is None:
                raise RpcError("the replica's connection is closed")
            kind, meta, arrays = recv_msg(
                r.client.sock, deadline_s=self.rpc_timeout_s,
                faults=self.faults)
        except TRANSPORT_FAULTS:
            self._mark_failure(r)        # reroutes what was pending on r
            return
        fut = r.pending.pop(meta.get("seq"), None)
        if fut is None:
            return                       # stale frame (already rerouted)
        if kind == "err":
            name = meta.get("error", "RpcError")
            cls = FAULT_TYPES.get(name, RpcError)
            try:
                fut.error = cls(meta.get("msg", ""))
            except TypeError:
                fut.error = EmberFault(
                    f"{name}: {meta.get('msg', '')}")
        else:
            fut.value = arrays
        fut.done = True

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        s = dict(self.pool_stats)
        s["recoveries_s"] = list(self.pool_stats["recoveries_s"])
        s["warm_sources"] = list(self.pool_stats["warm_sources"])
        s["compile_sources"] = list(self.pool_stats["compile_sources"])
        s["states"] = [r.state for r in self.replicas]
        s["spawns"] = [r.spawns for r in self.replicas]
        return s


if __name__ == "__main__":
    main()
