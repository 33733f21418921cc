"""The port's vocab-sharded executor against the JAX package's.

The reference runs its cases once on a forced 2-device CPU mesh (through
the ``run_on_mesh`` fixture, one subprocess writing an npz); the port runs
the same cases on two gloo ranks on the CPU (``launch.mesh.run_ranks``,
one spawn per backend).  Every case goes through both exchanges and both
output placements: the outputs (owned slices all-gathered) are held to the
reference's at the f32 bound for sums and exactly for max, min and the
gathers, and every exchange statistic equal to the reference's.  Then the
port alone: the local table against the plan's numpy oracle, a 1-wide mesh
against the single-device executor bit for bit, the owned output contract,
sharded ``update_tables`` and the executor-cache keys.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import access_plan as tap
from repro_torch.core import cost_model as tcm
from repro_torch.core import ops as tops
from repro_torch.core import shard_plan as sp
from repro_torch.launch.mesh import run_ranks

SUM_TOL = dict(rtol=2e-5, atol=2e-5)
CONFIGS = (("host", True), ("host", False), ("collective", True),
           ("collective", False))
#: the executor statistics both packages keep the same way
STAT_KEYS = ("steps", "table_stacks", "table_restacks", "table_rebinds",
             "exchange_index_bytes", "exchange_row_bytes", "hot_lookups",
             "cold_lookups", "host_syncs", "oob_lookups", "dropped_lookups",
             "hot_swaps", "hot_swaps_rejected", "spilled_lookups")


# ---------------------------------------------------------------------------
# The cases, built from either package's modules
# ---------------------------------------------------------------------------

def _empty(ins: dict) -> dict:
    out = {n: dict(v) for n, v in ins.items()}
    for v in out.values():
        if "ptrs" in v:
            v["ptrs"] = np.zeros_like(v["ptrs"])
            v["idxs"] = v["idxs"][:0]
            if "vals" in v:
                v["vals"] = v["vals"][:0]
    return out


def _with_tables(ins: dict, base: dict) -> dict:
    """``ins`` with ``base``'s table objects (steady tables, fresh ids)."""
    out = {n: dict(v) for n, v in ins.items()}
    for n, v in out.items():
        for k in ("table", "x"):
            if k in v:
                v[k] = base[n][k]
    return out


def cases(m, cost_model, access_plan) -> dict:
    """``{case: (program, step inputs, hot rows or None)}`` from the ops,
    cost-model and access-plan modules ``m``, ``cost_model`` and
    ``access_plan`` of either package (numpy inputs, equal in both)."""
    op, P, S = m.EmbeddingOp, m.EmbeddingProgram, m.Semiring
    out = {}
    mixed = P("mixed", (
        ("w", op("sls", 5, 9, 8, avg_lookups=3, weighted=True)),
        ("u", op("sls", 4, 7, 8, avg_lookups=2)),
        ("k", op("kg", 6, 11, 8)),
        ("g1", op("gather", 6, 20, 8)),
        ("g2", op("gather", 6, 20, 8)),
        ("solo", op("spmm", 3, 5, 16, avg_lookups=2)),
    ), shared_tables=(("g1", "g2"),))
    base = m.make_program_inputs(mixed, seed=0)
    out["mixed"] = (mixed, [base, _with_tables(
        m.make_program_inputs(mixed, seed=3), base)], None)
    for add in ("max", "min"):
        # a fused sls + kg group whose ids all live on shard 0: shard 1
        # pools nothing, and the merge must keep the identity exact
        prog = P(f"{add}mix", (
            ("a", op("sls", 4, 8, 8, avg_lookups=3, semiring=S(add))),
            ("m", op("kg", 4, 8, 8, semiring=S(add))),
        ))
        ins = m.make_program_inputs(prog, seed=1)
        for n in ("a", "m"):
            ins[n]["idxs"] = np.minimum(ins[n]["idxs"], 3)
        out[f"{add}_empty_shard"] = (prog, [ins], None)
    pm = P("maxempty", (
        ("a", op("sls", 4, 12, 8, avg_lookups=3, semiring=S("max"))),
        ("b", op("sls", 3, 9, 8, avg_lookups=2, semiring=S("max"))),
    ))
    full = m.make_program_inputs(pm, seed=0)
    out["max_empty_step"] = (pm, [_empty(full), full, _empty(full)], None)
    pw = P("wempty", (
        ("w", op("sls", 4, 10, 8, avg_lookups=3, weighted=True)),
        ("u", op("sls", 3, 7, 8, avg_lookups=2)),
    ))
    fullw = m.make_program_inputs(pw, seed=1)
    out["add_empty_step"] = (pw, [_empty(fullw), fullw], None)
    p1 = P("tiny", (
        ("one", op("sls", 4, 1, 8, avg_lookups=2)),
        ("big", op("sls", 3, 12, 8, avg_lookups=2)),
    ))
    out["single_row_slot"] = (p1, [m.make_program_inputs(p1, seed=2)], None)
    ph = P("allhot", (
        ("a", op("sls", 4, 8, 8, avg_lookups=3)),
        ("b", op("sls", 3, 10, 8, avg_lookups=2)),
    ))
    out["hot_covers_slot"] = (ph, [m.make_program_inputs(ph, seed=3)],
                              {"a": tuple(range(8))})
    # a classified Zipf head: a Zipf step, an all-hot batch, an empty step
    pz = P("hot", (
        ("a", op("sls", 6, 32, 8, avg_lookups=4)),
        ("b", op("sls", 5, 24, 8, avg_lookups=3)),
    ))
    zins = m.make_program_inputs(pz, seed=2, alpha=1.2)
    hot = access_plan.hot_rows_from_traces(
        pz, {n: np.asarray(zins[n]["idxs"]) for n in ("a", "b")},
        cost_model.FusionBudget(shards=2, hot_slab_bytes=8 * 8 * 4))
    all_hot = {n: dict(zins[n]) for n in zins}
    for n, ids in hot.items():
        take = all_hot[n]["idxs"]
        all_hot[n]["idxs"] = np.asarray(ids)[
            np.arange(len(take)) % len(ids)].astype(take.dtype)
    out["zipf_hot"] = (pz, [zins, all_hot, _empty(zins)], hot)
    pmc = P("maxcold", (
        ("a", op("sls", 4, 16, 8, avg_lookups=3, semiring=S("max"))),
        ("m", op("kg", 4, 16, 8, semiring=S("max"))),
    ))
    cins = m.make_program_inputs(pmc, seed=4)
    for n in ("a", "m"):   # the batch entirely cold: rows 4.. only
        cins[n]["idxs"] = 4 + (np.asarray(cins[n]["idxs"]) % 12)
    out["max_hot_all_cold"] = (pmc, [cins], {"a": (0, 1, 2, 3),
                                             "m": (0, 1)})
    pb = P("edge", (
        ("a", op("sls", 4, 16, 8, avg_lookups=4)),
        ("b", op("sls", 4, 10, 8, avg_lookups=4)),
    ))
    insb = m.make_program_inputs(pb, seed=4)
    rng = np.random.default_rng(5)
    for n, rows in (("a", 16), ("b", 10)):         # fused nnz = 16 = 2^4
        insb[n]["ptrs"] = np.array([0, 2, 4, 6, 8], np.int64)
        insb[n]["idxs"] = rng.integers(0, rows, 8).astype(np.int32)
    plus = {n: dict(insb[n]) for n in insb}        # nnz = 17: next bucket
    plus["a"]["ptrs"] = np.array([0, 3, 5, 7, 9], np.int64)
    plus["a"]["idxs"] = rng.integers(0, 16, 9).astype(np.int32)
    out["bucket_edge"] = (pb, [insb, plus], None)
    # a fused gather of 2-row blocks over a shared table, beside a third
    pg = P("blocks", (
        ("g1", op("gather", 5, 10, 8, block_rows=2)),
        ("g2", op("gather", 4, 10, 8, block_rows=2)),
        ("g3", op("gather", 3, 6, 8, block_rows=2)),
    ), shared_tables=(("g1", "g2"),))
    out["gather_blocks"] = (pg, [m.make_program_inputs(pg, seed=6)],
                            {"g1": (0, 3), "g3": (5,)})
    return out


def update_case(m):
    """A sharded ``update_tables``: step, new tables, step again."""
    prog = m.EmbeddingProgram("upd", (
        ("a", m.EmbeddingOp("sls", 4, 10, 8, avg_lookups=3)),
        ("b", m.EmbeddingOp("sls", 3, 7, 8, avg_lookups=2)),
    ))
    return prog, m.make_program_inputs(prog, seed=0), \
        m.make_program_inputs(prog, seed=7)


CASES = tuple(cases(tops, tcm, tap))
EXACT_CASES = ("max_empty_shard", "min_empty_shard", "max_empty_step",
               "max_hot_all_cold")


def _compile(m_pipeline, m_cost, prog, hot):
    return m_pipeline.compile_program(
        prog, "O3", vlen=4, use_cache=False, hot_rows=hot,
        budget=m_cost.FusionBudget(shards=2) if hot else None)


# ---------------------------------------------------------------------------
# The reference, once per module, on a forced 2-device CPU mesh
# ---------------------------------------------------------------------------

_REF_CODE = """
import sys
import jax
import numpy as np
sys.path.insert(0, "tests")
import test_torch_sharded_executor as T
from repro.core import access_plan, cost_model, ops, pipeline
from repro.core.executor import ProgramExecutor
from repro.launch.mesh import axis_types_kw

mesh = jax.make_mesh((1, 2), ("data", "model"), **axis_types_kw(2))
out = {{}}
for case, (prog, steps, hot) in T.cases(ops, cost_model, access_plan).items():
    pres = T._compile(pipeline, cost_model, prog, hot)
    for exchange, repl in T.CONFIGS:
        ex = ProgramExecutor(pres, backend="pallas", mesh=mesh,
                             exchange=exchange, replicate_outputs=repl,
                             hot_rows=hot)
        tag = f"{{case}}/{{exchange}}/{{int(repl)}}"
        for k, ins in enumerate(steps):
            for n, v in ex.step(ins).items():
                out[f"{{tag}}/{{k}}/{{n}}"] = np.asarray(v)
        out[f"{{tag}}/stats"] = np.array([ex.stats[s] for s in T.STAT_KEYS])
prog, ins, new = T.update_case(ops)
for exchange, repl in T.CONFIGS:
    ex = ProgramExecutor(pipeline.compile_program(prog, "O3", vlen=4,
                                                  use_cache=False),
                         backend="pallas", mesh=mesh, exchange=exchange,
                         replicate_outputs=repl)
    ex.step(ins)
    ex.update_tables(new)
    tag = f"update/{{exchange}}/{{int(repl)}}"
    for n, v in ex.step(new).items():
        out[f"{{tag}}/{{n}}"] = np.asarray(v)
    out[f"{{tag}}/stats"] = np.array([ex.stats[s] for s in T.STAT_KEYS])
np.savez({path!r}, **out)
print("REF_OK")
"""

_MEMO: dict = {}


@pytest.fixture
def reference(run_on_mesh, tmp_path_factory) -> dict:
    """The JAX package's outputs and stats of every case (run once)."""
    if "ref" not in _MEMO:
        path = tmp_path_factory.mktemp("sharded_ref") / "ref.npz"
        run_on_mesh(_REF_CODE.format(path=str(path)), devices=2,
                    sentinel="REF_OK")
        with np.load(path) as z:
            _MEMO["ref"] = dict(z)
    return _MEMO["ref"]


# ---------------------------------------------------------------------------
# The port, on two gloo ranks
# ---------------------------------------------------------------------------

def _port_cases(rank: int, world: int, backend: str) -> dict:
    """Every case under every config on this rank: the full outputs (owned
    slices all-gathered) and the stats, as numpy."""
    from repro_torch.convert import program_inputs_to_torch
    from repro_torch.core import pipeline
    from repro_torch.core.executor import ProgramExecutor
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(world, device="cpu")
    out = {}
    for case, (prog, steps, hot) in cases(tops, tcm, tap).items():
        pres = _compile(pipeline, tcm, prog, hot)
        flat = program_inputs_to_torch(
            {f"{k}/{n}": v for k, ins in enumerate(steps)
             for n, v in ins.items()}, "cpu")
        tsteps = [{n: flat[f"{k}/{n}"] for n in ins}
                  for k, ins in enumerate(steps)]
        for exchange, repl in CONFIGS:
            ex = ProgramExecutor(pres, device="cpu", backend=backend,
                                 mesh=mesh, exchange=exchange,
                                 replicate_outputs=repl, hot_rows=hot)
            tag = f"{case}/{exchange}/{int(repl)}"
            for k, ins in enumerate(tsteps):
                got = ex.step(ins)
                for n, v in got.items():
                    out[f"{tag}/{k}/{n}/rows"] = np.array(
                        ex.output_rows(n))
                    out[f"{tag}/{k}/{n}/local"] = v.numpy().copy()
                for n, v in ex.full_outputs(got).items():
                    out[f"{tag}/{k}/{n}"] = v.numpy().copy()
            out[f"{tag}/stats"] = np.array([ex.stats[s] for s in STAT_KEYS])
    prog, ins, new = update_case(tops)
    ins, new = (program_inputs_to_torch(x, "cpu") for x in (ins, new))
    for exchange, repl in CONFIGS:
        ex = ProgramExecutor(pipeline.compile_program(prog, "O3", vlen=4,
                                                      use_cache=False),
                             device="cpu", backend=backend, mesh=mesh,
                             exchange=exchange, replicate_outputs=repl)
        ex.step(ins)
        table = ex._units[0].table
        ex.update_tables(new)
        assert ex._units[0].table is table      # rewritten in place
        tag = f"update/{exchange}/{int(repl)}"
        for n, v in ex.full_outputs(ex.step(new)).items():
            out[f"{tag}/{n}"] = v.numpy().copy()
        out[f"{tag}/stats"] = np.array([ex.stats[s] for s in STAT_KEYS])
    return out


@pytest.fixture
def port():
    """``{backend: [rank 0's results, rank 1's]}`` (each run once)."""
    if "port" not in _MEMO:
        _MEMO["port"] = {b: run_ranks(_port_cases, 2, (b,))
                         for b in ("cuda", "torch")}
    return _MEMO["port"]


def _steps(case):
    return range(len(cases(tops, tcm, tap)[case][1]))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("exchange,repl", CONFIGS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_outputs_match_the_reference(reference, port, case,
                                             exchange, repl, backend):
    tag = f"{case}/{exchange}/{int(repl)}"
    kinds = {n: op.kind for n, op in cases(tops, tcm, tap)[case][0].ops}
    for rank, res in enumerate(port[backend]):
        for k in _steps(case):
            names = [key.split("/")[-1] for key in reference
                     if key.startswith(f"{tag}/{k}/")]
            assert names
            for n in names:
                want = reference[f"{tag}/{k}/{n}"]
                got = res[f"{tag}/{k}/{n}"]
                assert got.shape == want.shape, (n, got.shape, want.shape)
                if case in EXACT_CASES or kinds[n] == "gather":
                    np.testing.assert_array_equal(
                        got, want, err_msg=f"{tag} step {k} {n} rank {rank}")
                else:
                    np.testing.assert_allclose(
                        got, want, **SUM_TOL,
                        err_msg=f"{tag} step {k} {n} rank {rank}")


@pytest.mark.parametrize("exchange,repl", CONFIGS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_stats_match_the_reference(reference, port, case, exchange,
                                           repl):
    """The kernels' backend against the reference's Pallas one (the stock
    backends place singleton operands differently in both packages)."""
    tag = f"{case}/{exchange}/{int(repl)}"
    want = dict(zip(STAT_KEYS, reference[f"{tag}/stats"].tolist()))
    for res in port["cuda"]:
        assert dict(zip(STAT_KEYS, res[f"{tag}/stats"].tolist())) == want


@pytest.mark.parametrize("exchange,repl", CONFIGS)
def test_owned_outputs_are_the_ranks_segment_slices(port, exchange, repl):
    """Each rank's step returns, per op, the rows of its segment slice
    (all of them when replicated); the slices tile each op's rows."""
    tag = f"mixed/{exchange}/{int(repl)}"
    r0, r1 = port["cuda"]
    for n in ("w", "u", "k", "g1", "g2", "solo"):
        full = r0[f"{tag}/0/{n}"]
        (a0, b0), (a1, b1) = (r[f"{tag}/0/{n}/rows"] for r in (r0, r1))
        if repl or n == "solo":
            assert (a0, b0) == (a1, b1) == (0, len(full))
        else:
            assert a0 == 0 and b0 == a1 and b1 == len(full)
        for r, (a, b) in ((r0, (a0, b0)), (r1, (a1, b1))):
            np.testing.assert_array_equal(r[f"{tag}/0/{n}/local"],
                                          full[a:b])


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("exchange,repl", CONFIGS)
def test_sharded_update_tables_matches_the_reference(reference, port,
                                                     exchange, repl,
                                                     backend):
    """``update_tables`` rewrites each rank's local table in place; the
    next step reads the new tables, as the reference's restack does."""
    tag = f"update/{exchange}/{int(repl)}"
    for res in port[backend]:
        for n in ("a", "b"):
            np.testing.assert_allclose(res[f"{tag}/{n}"],
                                       reference[f"{tag}/{n}"], **SUM_TOL)
        if backend == "cuda":
            assert res[f"{tag}/stats"].tolist() == \
                reference[f"{tag}/stats"].tolist()


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------

def _plan_of(case: str):
    prog, steps, hot = cases(tops, tcm, tap)[case]
    pres = _compile_port(prog, None)
    unit = next(u for u in pres.units if u.group is not None)
    plan = tap.build_plan(unit.group.op, unit.group, shards=2, hot_rows=hot)
    parts = [steps[0][n]["table"] for n in plan.slot_first_member]
    return plan, parts


def _compile_port(prog, hot):
    from repro_torch.core import pipeline
    return _compile(pipeline, tcm, prog, hot)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("case", ["mixed", "zipf_hot", "hot_covers_slot",
                                  "single_row_slot", "gather_blocks"])
def test_local_stack_table_is_the_oracles_row_block(case, rank):
    plan, parts = _plan_of(case)
    want = plan.stack_np(parts)
    rows = plan.local_rows * plan.blk
    got = sp.local_stack_table([torch.from_numpy(p) for p in parts], plan,
                               rank)
    np.testing.assert_array_equal(got.numpy(),
                                  want[rank * rows:(rank + 1) * rows])
    # rewritten in place (update_tables, slab swaps): the same bits
    got.fill_(7.0)
    sp.local_stack_table([torch.from_numpy(p) for p in parts], plan, rank,
                         out=got)
    np.testing.assert_array_equal(got.numpy(),
                                  want[rank * rows:(rank + 1) * rows])


def _one_wide(rank: int, world: int) -> dict:
    """On a 1-wide mesh the executor is the single-device one: the same
    bits, the same stats, and ``executor_for`` keys it as no mesh."""
    from repro_torch.convert import program_inputs_to_torch
    from repro_torch.core.executor import (ProgramExecutor,
                                           clear_executor_cache,
                                           executor_for)
    from repro_torch.core.pipeline import compile_program
    from repro_torch.launch.mesh import make_host_mesh, model_shard_count
    mesh = make_host_mesh(1, device="cpu")
    prog, steps, _ = cases(tops, tcm, tap)["mixed"]
    pres = compile_program(prog, "O3", vlen=4, use_cache=False)
    plain = ProgramExecutor(pres, device="cpu")
    meshed = ProgramExecutor(pres, device="cpu", mesh=mesh,
                             hot_rows={"w": (0, 1)})
    ins = program_inputs_to_torch(steps[0], "cpu")
    a, b = plain.step(ins), meshed.step(ins)
    clear_executor_cache()
    e1 = executor_for(prog, "O3", vlen=4, device="cpu")
    e2 = executor_for(prog, "O3", vlen=4, device="cpu", mesh=mesh)
    e3 = executor_for(prog, "O3", vlen=4, device="cpu", mesh=mesh,
                      hot_rows={"w": (0, 1)}, exchange="collective")
    clear_executor_cache()
    return {"shards": meshed.shards, "mesh_none": meshed.mesh is None,
            "count": model_shard_count(mesh),
            "same": all(torch.equal(a[n], b[n]) for n in a),
            "stats": plain.stats == meshed.stats,
            "cached": e2 is e1 and e3 is e1}


def test_one_wide_mesh_is_the_single_device_executor():
    (res,) = run_ranks(_one_wide, 1)
    assert res == {"shards": 1, "mesh_none": True, "count": 1, "same": True,
                   "stats": True, "cached": True}


def _cache_keys(rank: int, world: int) -> dict:
    from repro_torch.core.executor import clear_executor_cache, executor_for
    from repro_torch.data.locality import AdaptiveHotConfig
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(world, device="cpu")
    prog, _, _ = update_case(tops)
    kw = dict(opt_level="O3", vlen=4, device="cpu")
    clear_executor_cache()
    e_repl = executor_for(prog, **kw)
    e_shrd = executor_for(prog, **kw, mesh=mesh)
    e_coll = executor_for(prog, **kw, mesh=mesh, exchange="collective")
    e_host = executor_for(prog, **kw, mesh=mesh, exchange="host")
    e_esc = executor_for(prog, **kw, mesh=mesh, exchange="collective",
                         replicate_outputs=True)
    e_hot = executor_for(prog, **kw, mesh=mesh, hot_rows={"a": (0, 1)})
    e_ad = executor_for(prog, **kw, mesh=mesh, hot_rows={"a": (0, 1)},
                        adaptive=AdaptiveHotConfig())
    res = {"repl_vs_shrd": e_repl is not e_shrd,
           "shards": e_shrd.shards,
           "hit": executor_for(prog, **kw, mesh=mesh) is e_shrd,
           "coll_default": e_coll is e_shrd,
           "host_esc_differ": e_host is not e_coll and e_esc is not e_coll,
           "coll_owned": e_coll.replicate_outputs is False,
           "host_repl": e_host.replicate_outputs is True,
           "hot_differs": e_hot is not e_shrd and e_ad is not e_hot,
           "budget_shards": e_shrd.compiled.units[0].result.op is not None,
           "hot_hit": executor_for(prog, **kw, mesh=mesh,
                                   hot_rows={"a": (1, 0)}) is e_hot}
    clear_executor_cache()
    return res


def test_executor_cache_keys_on_the_sharded_knobs():
    for res in run_ranks(_cache_keys, 2):
        assert res == {"repl_vs_shrd": True, "shards": 2, "hit": True,
                       "coll_default": True, "host_esc_differ": True,
                       "coll_owned": True, "host_repl": True,
                       "hot_differs": True, "budget_shards": True,
                       "hot_hit": True}


def test_shard_count_helpers():
    from repro_torch.launch.mesh import data_axes_of, model_shard_count

    class _Mesh:
        mesh_dim_names = ("data",)
        shape = (3,)
    assert sp.shard_count(None) == 1 and model_shard_count(None) == 1
    assert sp.shard_count(_Mesh(), "model") == 1     # axis absent
    assert data_axes_of(_Mesh()) == ("data",)


def test_make_host_mesh_needs_a_process_group_and_the_card():
    from repro_torch.launch.mesh import make_host_mesh
    with pytest.raises(RuntimeError):
        make_host_mesh(1, device="cpu")        # no process group here
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh(1)                  # the card by default


def test_executor_refuses_a_mesh_on_another_device():
    from repro_torch.core.executor import ProgramExecutor
    from repro_torch.core.pipeline import compile_program

    class _Mesh:
        mesh_dim_names = ("data", "model")
        shape = (1, 2)
        device_type = "cuda"
    prog, _, _ = update_case(tops)
    with pytest.raises(ValueError, match="mesh is on cuda"):
        ProgramExecutor(compile_program(prog, "O3", use_cache=False),
                        device="cpu", mesh=_Mesh())
