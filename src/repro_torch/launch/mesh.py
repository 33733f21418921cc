"""Meshes of the port on ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with dims
``("data", "model")`` over the process group the caller has initialised
(``torch.distributed.init_process_group`` with its own address, world size
and rank: nothing here discovers a cluster).  The sharded executor reads
the ``model`` axis: its size is the vocab-shard count, a process's index
along it the shard it holds.

Several ranks may share one card over a gloo group (NCCL takes one rank a
device); the executor's collectives then go through pinned host buffers
(:class:`repro_torch.core.shard_plan.Collectives`).

The reference is single-controller; the port runs one process a rank.
:func:`run_ranks` starts such ranks on one host (spawned processes in one
process group over a file store), as the tests and ``chip_smoke.py`` do.

:func:`make_production_mesh` is the reference's production mesh as the
dry run sees it: an abstract mesh (:class:`repro_torch.core.shard_plan
.DryMesh`) of (16, 16) over ``("data", "model")``, or (2, 16, 16) with
``pod`` in front, on which one rank's step is built on the meta device
(``repro_torch.launch.dryrun``); no process group, no device.
``axis_types_kw`` and ``mesh_context`` are JAX API shims with nothing to
stand for here.
"""
from __future__ import annotations

import datetime
import gc
import os
import queue
import tempfile
import time
import traceback


def make_host_mesh(model_parallel: int = 1, device=None):
    """The mesh of every rank of the initialised default process group,
    ``(world // model_parallel, model_parallel)`` over ``("data",
    "model")``, on the CUDA card unless ``device="cpu"`` (raises without a
    card: no CPU fallback).  On the card the rank's current device is made
    the process's device first, so the mesh never picks one itself."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ..core.executor import resolve_device
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("initialise the process group first "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide "
                         f"the world size {n}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return DeviceMesh(dev.type,
                      torch.arange(n).reshape(n // model_parallel,
                                              model_parallel),
                      mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh, abstract: 16 x 16 = 256 ranks a
    pod over ``("data", "model")``, or 2 pods = 512 over ``("pod",
    "data", "model")`` (``pod`` pure data parallel), as a
    :class:`~repro_torch.core.shard_plan.DryMesh` standing for rank 0
    (the head plan gives it the most heads of any rank for the repo's
    configs; every other leaf splits evenly)."""
    from ..core.shard_plan import DryMesh
    sizes = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    return DryMesh(sizes)


def data_axes_of(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_shard_count(mesh, axis: str = "model") -> int:
    """Vocab-shard count the steady-state executor will use on ``mesh`` --
    the launch-layer alias of :func:`repro_torch.core.shard_plan
    .shard_count`."""
    from ..core.shard_plan import shard_count
    return shard_count(mesh, axis)


def _rank_main(fn, rank: int, world: int, store: str, backend: str,
               timeout_s: float, results, inbox) -> None:
    import torch.distributed as dist
    # the arguments come through a queue, not the process's own arguments,
    # so they are freed before the rank exits: a CUDA tensor received by
    # IPC stays allocated in its producer until every receiver lets go
    args = inbox.get()
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        value = fn(rank, world, *args)
        del args
        gc.collect()
        results.put((rank, True, value))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int = 2, args: tuple = (), *,
              backend: str = "gloo", timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    into one ``backend`` process group (a file store in a temporary
    directory: no network), and return each rank's result in rank order.

    ``fn`` must be importable by name; ``args`` and the results are
    pickled (CUDA tensors in ``args`` reach the ranks by CUDA IPC and must
    stay alive here until this returns; ``torch.cuda.ipc_collect()`` then
    frees what the ranks held).  A rank that raises, or exits without a
    result, fails the call with its traceback; every process is stopped
    before this returns, and a collective waiting on a lost peer times
    out after ``timeout_s``."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results, inbox = ctx.Queue(), ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, store, backend, timeout_s,
                                   results, inbox))
                 for r in range(world)]
        for p in procs:
            p.start()
            inbox.put(args)
        got: dict = {}
        failed = None
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world and failed is None:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        failed = (f"rank {dead[0]} exited with code "
                                  f"{procs[dead[0]].exitcode} and no result")
                    elif time.monotonic() > deadline:
                        failed = f"no result within {timeout_s} s"
                    continue
                if ok:
                    got[rank] = value
                else:
                    failed = f"rank {rank} raised:\n{value}"
            for p in procs:
                p.join(timeout=None if failed is None else 5.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        if failed is None:
            bad = [(r, p.exitcode) for r, p in enumerate(procs)
                   if p.exitcode != 0]
            if bad:
                failed = f"ranks exited with codes {bad}"
        if failed is not None:
            raise RuntimeError(f"run_ranks({fn.__name__}): {failed}")
    return [got[r] for r in range(world)]
