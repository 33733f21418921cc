"""The port's stock-op backend and pipelining on the CPU, against the JAX
package: ``backend_torch`` against ``repro.core.backend_jax.execute`` on
every kind; the ``torch``-backend executor against the reference's
``backend="jax"`` executor; the ``PipelineGroup`` contracts of
``tests/test_executor.py`` (a shared pool, per-program in-flight
accounting, ``submit_wave`` outputs equal to each member's own ``step``);
the deferred handles of a ``TransferBatch``; and executor fault recovery per
site.

Tolerances: the reference's (tests/test_kernels.py) -- f32 2e-5 for sls,
1e-4 for fusedmm; gathers are copies and held exactly."""
import numpy as np
import pytest
import torch

from repro.core import backend_jax as jbj
from repro.core import ops as jops
from repro.core.executor import ProgramExecutor as JProgramExecutor
from repro.core.pipeline import compile_program as jcompile
from repro_torch.core import backend_torch as bt
from repro_torch.core import ops as tops
from repro_torch.core.executor import (BufferPool, ProgramExecutor,
                                       TransferBatch, executor_cache_stats,
                                       executor_for, pipeline_group,
                                       set_executor_cache_limit)
from repro_torch.core.pipeline import compile_program
from repro_torch.runtime.faults import (FaultInjector, FaultSpec,
                                        InjectedFailure)

from test_torch_executor import _assert_outputs, _feed, _mixed, _to_port

SLS_TOL = dict(rtol=2e-5, atol=2e-5)
FMM_TOL = dict(rtol=1e-4, atol=1e-4)


def _kinds(m):
    """One op of every kind and semiring the backends run, from either
    package's ops module ``m``."""
    op, sr = m.EmbeddingOp, m.Semiring
    return {
        "gather": op("gather", 9, 20, 8),
        "gather_blocks": op("gather", 6, 10, 8, block_rows=3),
        "sls_sum": op("sls", 7, 30, 16, avg_lookups=3),
        "sls_weighted": op("sls", 7, 30, 16, avg_lookups=3, weighted=True),
        "sls_lengths": op("sls", 6, 25, 8, avg_lookups=2,
                          index_format="lengths"),
        "sls_max": op("sls", 8, 12, 5, avg_lookups=2, semiring=sr("max")),
        "sls_min_weighted": op("sls", 8, 12, 8, avg_lookups=2, weighted=True,
                               semiring=sr("min")),
        "sls_max_add": op("sls", 8, 12, 8, avg_lookups=2, weighted=True,
                          semiring=sr("max", "add")),
        "sls_add_add": op("sls", 8, 12, 8, avg_lookups=2, weighted=True,
                          semiring=sr("add", "add")),
        "spmm": op("spmm", 6, 14, 16, avg_lookups=3),
        "kg": op("kg", 7, 30, 8),
        "kg_max_add": op("kg", 7, 30, 8, semiring=sr("max", "add")),
        "fusedmm": op("fusedmm", 12, 12, 16, avg_lookups=3),
    }


@pytest.mark.parametrize("kind", sorted(_kinds(tops)))
def test_backend_torch_matches_backend_jax(kind):
    jop, top = _kinds(jops)[kind], _kinds(tops)[kind]
    ins = jops.make_inputs(jop, seed=3)
    want = np.asarray(jbj.execute(jop, ins))
    tins = {k: torch.from_numpy(np.array(v)) if k in ("table", "x") else v
            for k, v in ins.items()}
    got = bt.execute(top, tins)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = FMM_TOL if kind == "fusedmm" else SLS_TOL
    if kind.startswith("gather"):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **tol)
    np.testing.assert_allclose(got.numpy(), jops.reference(jop, ins), **tol)


def test_backend_torch_adds_roff_on_the_device():
    """A fused gather's and a fused CSR unit's per-segment table base."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    idxs = rng.integers(0, 20, 6).astype(np.int32)
    roff = np.array([0, 20, 0, 20, 20, 0], np.int32)
    got = bt.execute(tops.EmbeddingOp("gather", 6, 40, 8),
                     {"table": table, "idxs": idxs, "roff": roff})
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  table.numpy()[idxs + roff])
    ptrs = np.array([0, 2, 2, 5], np.int32)
    cidx = np.array([1, 3, 0, 4, 2], np.int32)
    croff = np.array([0, 10, 20], np.int32)
    got = bt.execute(tops.EmbeddingOp("sls", 3, 40, 8),
                     {"table": table, "ptrs": ptrs, "idxs": cidx,
                      "roff": croff})
    t = table.numpy()
    want = np.stack([t[1] + t[3], np.zeros(8, np.float32),
                     t[20] + t[24] + t[22]])
    np.testing.assert_allclose(got.numpy(), want, **SLS_TOL)


@pytest.mark.parametrize("lvl", ["O0", "O3"])
def test_torch_backend_executor_matches_the_reference_jax_backend(lvl):
    """The mixed program (fused CSR, fused gather, spmm and max singletons)
    through both executors' stock-op backends, and through the port's
    ``cuda`` backend (the plain versions on the CPU)."""
    steps = _feed(_mixed(jops), seeds=(0, 1, 2))
    jex = JProgramExecutor(jcompile(_mixed(jops), lvl, use_cache=False),
                           backend="jax")
    pres = compile_program(_mixed(tops), lvl, use_cache=False)
    ex = ProgramExecutor(pres, device="cpu", backend="torch")
    kex = ProgramExecutor(pres, device="cpu", backend="cuda")
    for jins, tins in zip(steps, _to_port(steps)):
        want = jex.step(jins)
        got = ex.step(tins)
        _assert_outputs(got, want)
        _assert_outputs(kex.step(tins), {n: t.numpy()
                                         for n, t in got.items()})


def test_executor_for_keys_on_the_backend():
    prog = tops.EmbeddingProgram("bk", (("g", tops.EmbeddingOp("gather", 4,
                                                               9, 8)),))
    a = executor_for(prog, device="cpu")
    b = executor_for(prog, device="cpu", backend="torch")
    assert a is not b and (a.backend, b.backend) == ("cuda", "torch")
    assert executor_for(prog, device="cpu", backend="torch") is b
    assert executor_cache_stats()["entries_by_shards"][1] >= 2
    with pytest.raises(ValueError, match="backend"):
        executor_for(prog, device="cpu", backend="jax")
    old = set_executor_cache_limit(32)
    assert set_executor_cache_limit(old) == 32


# ---------------------------------------------------------------------------
# PipelineGroup (the contracts of tests/test_executor.py)
# ---------------------------------------------------------------------------

def _step_inputs(m, prog, seed, base):
    """Fresh index streams over ``base``'s tables (steady-state feed)."""
    fresh = m.make_program_inputs(prog, seed=seed)
    return {n: {**fresh[n], "table": base[n]["table"]} for n in fresh}


def test_pipeline_group_shares_pool_and_accounts_in_flight():
    """Two compiled programs joined by pipeline_group: one shared staging
    pool, per-program in-flight accounting, numerics equal to the numpy
    oracle."""
    def progs(m):
        op = m.EmbeddingOp
        return (m.EmbeddingProgram("pg-a", (
            ("a1", op("sls", 6, 12, 8, avg_lookups=2)),
            ("a2", op("sls", 5, 9, 8, avg_lookups=2)))),
                m.EmbeddingProgram("pg-b", (
                    ("b1", op("sls", 6, 12, 8, avg_lookups=2)),)))
    prog_a, prog_b = progs(tops)
    ex_a = ProgramExecutor(compile_program(prog_a, "O3", vlen=4,
                                           use_cache=False), device="cpu")
    ex_b = ProgramExecutor(compile_program(prog_b, "O3", vlen=4,
                                           use_cache=False), device="cpu")
    grp = pipeline_group([ex_a, ex_b])
    assert ex_a.pool is grp.pool and ex_b.pool is grp.pool
    assert grp.pool.shared
    base_a = _to_port([jops.make_program_inputs(progs(jops)[0], seed=0)])[0]
    base_b = _to_port([jops.make_program_inputs(progs(jops)[1], seed=1)])[0]
    handles, wants = [], []
    for seed in range(4):
        ins_a = _step_inputs(tops, prog_a, 200 + seed, base_a)
        ins_b = _step_inputs(tops, prog_b, 300 + seed, base_b)
        handles.append(grp.submit("pg-a", ins_a))
        handles.append(grp.submit("pg-b", ins_b))
        host = lambda ins: {n: {k: (v.numpy() if isinstance(v, torch.Tensor)
                                    else v) for k, v in d.items()}
                            for n, d in ins.items()}
        wants.append(tops.program_reference(prog_a, host(ins_a)))
        wants.append(tops.program_reference(prog_b, host(ins_b)))
    gs = grp.group_stats()
    assert gs["submitted"] == {"pg-a": 4, "pg-b": 4}
    assert max(gs["max_in_flight"].values()) >= 2  # overlap across programs
    for h, want in zip(handles, wants):
        _assert_outputs(h.result(), want, tol=dict(rtol=1e-4, atol=1e-4))
    grp.drain()
    assert grp.group_stats()["in_flight"] == {"pg-a": 0, "pg-b": 0}
    assert grp.pool.stats["hits"] > 0
    assert grp.pool.stats["forced_drains"] == 0


def _wave_programs():
    op = tops.EmbeddingOp
    return (tops.EmbeddingProgram("wv-a", (("g1", op("gather", 16, 64, 8)),
                                           ("g2", op("gather", 16, 64, 8)))),
            tops.EmbeddingProgram("wv-b", (("g3", op("gather", 24, 32, 8)),)))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_pipeline_group_submit_wave_equals_each_members_step(backend):
    """submit_wave co-schedules the wave's programs.  torch-backend gathers
    ride one packed copy per wave and launch at the flush; cuda-backend
    units launch inside submit.  Outputs equal the members' own step()
    exactly, wave after wave."""
    prog_a, prog_b = _wave_programs()
    pres_a = compile_program(prog_a, "O3", use_cache=False)
    pres_b = compile_program(prog_b, "O3", use_cache=False)
    grp = pipeline_group([
        ProgramExecutor(pres_a, device="cpu", backend=backend),
        ProgramExecutor(pres_b, device="cpu", backend=backend)])
    ref_a = ProgramExecutor(pres_a, device="cpu", backend=backend)
    ref_b = ProgramExecutor(pres_b, device="cpu", backend=backend)
    base_a = _to_port([jops.make_program_inputs(_wave_programs_j()[0], 0)])[0]
    base_b = _to_port([jops.make_program_inputs(_wave_programs_j()[1], 1)])[0]
    rng = np.random.default_rng(2)
    for _ in range(5):
        ins_a = {n: {"table": base_a[n]["table"],
                     "idxs": rng.integers(0, 64, 16).astype(np.int32)}
                 for n in ("g1", "g2")}
        ins_b = {"g3": {"table": base_b["g3"]["table"],
                        "idxs": rng.integers(0, 32, 24).astype(np.int32)}}
        handles = grp.submit_wave({"wv-a": ins_a, "wv-b": ins_b})
        want_a, want_b = ref_a.step(ins_a), ref_b.step(ins_b)
        _assert_outputs(handles["wv-a"].result(),
                        {n: t.numpy() for n, t in want_a.items()},
                        exact=True)
        _assert_outputs(handles["wv-b"].result(),
                        {n: t.numpy() for n, t in want_b.items()},
                        exact=True)
    gs = grp.group_stats()
    assert gs["waves"] == 5
    assert gs["submitted"] == {"wv-a": 5, "wv-b": 5}
    if backend == "torch":
        assert gs["batched_arrays"] == 10     # one stream a unit a wave
        assert gs["batched_copies"] == 5      # one packed copy a wave
    else:
        assert gs["batched_arrays"] == gs["batched_copies"] == 0
    grp.drain()
    assert grp.group_stats()["in_flight"] == {"wv-a": 0, "wv-b": 0}


def _wave_programs_j():
    op = jops.EmbeddingOp
    return (jops.EmbeddingProgram("wv-a", (("g1", op("gather", 16, 64, 8)),
                                           ("g2", op("gather", 16, 64, 8)))),
            jops.EmbeddingProgram("wv-b", (("g3", op("gather", 24, 32, 8)),)))


def test_submit_wave_matches_the_reference_group():
    """The same waves through the reference's jax-backend group (its jitted
    wave executable) and the port's torch-backend group."""
    from repro.core.executor import pipeline_group as jpipeline_group
    jprog_a, jprog_b = _wave_programs_j()
    prog_a, prog_b = _wave_programs()
    jgrp = jpipeline_group([
        JProgramExecutor(jcompile(jprog_a, "O3", use_cache=False),
                         backend="jax"),
        JProgramExecutor(jcompile(jprog_b, "O3", use_cache=False),
                         backend="jax")])
    grp = pipeline_group([
        ProgramExecutor(compile_program(prog_a, "O3", use_cache=False),
                        device="cpu", backend="torch"),
        ProgramExecutor(compile_program(prog_b, "O3", use_cache=False),
                        device="cpu", backend="torch")])
    base = {**jops.make_program_inputs(jprog_a, 0),
            **jops.make_program_inputs(jprog_b, 1)}
    tbl = {n: torch.from_numpy(np.array(base[n]["table"])) for n in base}
    rng = np.random.default_rng(4)
    for _ in range(3):
        idx = {n: rng.integers(0, 64 if n != "g3" else 32,
                               16 if n != "g3" else 24).astype(np.int32)
               for n in base}
        jwave = {"wv-a": {n: {"table": base[n]["table"], "idxs": idx[n]}
                          for n in ("g1", "g2")},
                 "wv-b": {"g3": {"table": base["g3"]["table"],
                                 "idxs": idx["g3"]}}}
        twave = {p: {n: {"table": tbl[n], "idxs": idx[n]} for n in d}
                 for p, d in jwave.items()}
        jh, th = jgrp.submit_wave(jwave), grp.submit_wave(twave)
        for p in jh:
            _assert_outputs(th[p].result(), jh[p].result(), exact=True)


def test_buffer_pool_grows_instead_of_draining_when_shared():
    """A shared pool does not serialize one program on another: exhausting
    every slot of a ring grows it (up to max_slots) rather than draining an
    in-flight owner."""

    class _FakeHandle:
        done = False
        drained = 0

        def ready(self):
            return self.done

        def result(self):
            self.done = True
            _FakeHandle.drained += 1

    pool = BufferPool(n_slots=2, max_slots=3, shared=True)
    spec = {"idxs": ((8,), np.int32)}
    key = pool.key_for(None, (), spec)
    assert key == pool.key_for("other executor", ("bucket",), spec)
    for _ in range(3):
        entry, turn, _ = pool.acquire(key, spec)
        entry["owners"][turn] = _FakeHandle()
    assert pool.stats["grown"] == 1           # 2 slots -> grew to 3
    assert _FakeHandle.drained == 0
    pool.acquire(key, spec)                   # full ring, all busy
    assert pool.stats["forced_drains"] == 1
    assert _FakeHandle.drained == 1


def test_deferred_handle_waits_for_the_flush():
    """A torch-backend fused gather submitted into a TransferBatch is
    deferred: no outputs, never ready, result() refuses, and its staging
    slot stays busy, until the batch's flush launches it."""
    prog = _wave_programs()[0]
    ex = ProgramExecutor(compile_program(prog, "O3", use_cache=False),
                         device="cpu", backend="torch")
    assert len(ex.compiled.units) == 1 and ex.compiled.units[0].fused
    t1, t2 = torch.randn(64, 8), torch.randn(64, 8)
    i1 = np.arange(16, dtype=np.int32) * 3
    i2 = np.arange(16, dtype=np.int32)[::-1].copy()
    txn = TransferBatch("cpu")
    h = ex.submit({"g1": {"table": t1, "idxs": i1},
                   "g2": {"table": t2, "idxs": i2}}, txn=txn)
    assert h.deferred and not h.ready() and h.outputs == {}
    with pytest.raises(RuntimeError, match="flushed"):
        h.result()
    owned = [(e, t) for e in ex.pool._entries.values()
             for t, o in enumerate(e["owners"]) if o is h]
    assert len(owned) == 1                    # the fused unit's idxs slot
    assert txn.n_arrays == 1 and len(txn.handles) == 1
    assert txn.flush() is None                # the CPU: no event
    assert not h.deferred and h.ready()
    out = h.result()
    np.testing.assert_array_equal(out["g1"][:, 0].numpy(), t1.numpy()[i1])
    np.testing.assert_array_equal(out["g2"][:, 0].numpy(), t2.numpy()[i2])


@pytest.mark.parametrize("site", ["dispatch", "marshal", "transfer",
                                  "result"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_executor_site_fault_then_reset_recovers(site, backend):
    """The reference's executor recovery per DAE site: a typed fault, then
    reset(), then steps bit-identical to a fault-free executor's."""
    prog = tops.EmbeddingProgram("chaos", (
        ("s", tops.EmbeddingOp("sls", 5, 9, 8, avg_lookups=3)),
        ("g", tops.EmbeddingOp("gather", 6, 20, 8))))
    pres = compile_program(prog, "O3", vlen=4, use_cache=False)
    ex = ProgramExecutor(pres, device="cpu", backend=backend,
                         faults=FaultInjector([FaultSpec(site, at=(1,))]))
    clean = ProgramExecutor(pres, device="cpu", backend=backend)
    jprog = jops.EmbeddingProgram("chaos", (
        ("s", jops.EmbeddingOp("sls", 5, 9, 8, avg_lookups=3)),
        ("g", jops.EmbeddingOp("gather", 6, 20, 8))))
    steps = _to_port(_feed(jprog, seeds=(0, 1, 2)))
    with pytest.raises(InjectedFailure, match=f"site={site}"):
        ex.step(steps[0])
    ex.reset()
    assert ex.stats["resets"] == 1
    assert all(o is None for e in ex.pool._entries.values()
               for o in e["owners"])
    for ins in steps[1:]:
        got, want = ex.step(ins), clean.step(ins)
        _assert_outputs(got, {n: t.numpy() for n, t in want.items()},
                        exact=True)


def test_group_fault_mid_wave_resets_and_recovers():
    """A fault at the wave flush (site "transfer") abandons the wave's
    deferred handles; reset() frees their slots and the next waves equal a
    clean group's bit for bit."""
    prog_a, prog_b = _wave_programs()

    def group():
        return pipeline_group([
            ProgramExecutor(compile_program(p, "O3", use_cache=False),
                            device="cpu", backend="torch")
            for p in (prog_a, prog_b)])
    grp, clean = group(), group()
    grp.faults = FaultInjector([FaultSpec("transfer", at=(2,))])
    t64, t32 = torch.randn(64, 8), torch.randn(32, 8)
    rng = np.random.default_rng(7)
    waves = [{"wv-a": {n: {"table": t64, "idxs": rng.integers(
                  0, 64, 16).astype(np.int32)} for n in ("g1", "g2")},
              "wv-b": {"g3": {"table": t32, "idxs": rng.integers(
                  0, 32, 24).astype(np.int32)}}} for _ in range(4)]
    grp.submit_wave(waves[0])
    with pytest.raises(InjectedFailure, match="site=transfer"):
        grp.submit_wave(waves[1])
    grp.reset()
    assert grp.stats["resets"] == 1
    for w in waves[1:]:
        got, want = grp.submit_wave(w), clean.submit_wave(w)
        for p in got:
            _assert_outputs(got[p].result(),
                            {n: t.numpy() for n, t in
                             want[p].result().items()}, exact=True)
