"""The port's adaptive hot slab against the JAX package's.

The windowed counters, the re-ranking and the spill table are verbatim
copies: their units are held to the reference's on the same inputs.  The
live swap runs the reference's drift drive (a reference window all hot,
then a disjoint head, swaps, ten direct swaps, a rejected one, a stale
plan) once on the reference's forced 2-device CPU mesh (``run_on_mesh``,
one npz) and once on two gloo ranks of the port (one spawn), with and
without spilling: the outputs are held to the reference's at the f32
bound, each swap's bits to a cold-built executor's, and every decision --
swaps, slab epochs, hot sets, window and access-plan statistics -- equal
to the reference's and equal on the two ranks.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.core.shard_plan import compute_spill as ref_compute_spill
from repro.data import locality as jloc
from repro_torch.core import cost_model as tcm
from repro_torch.core import ops as tops
from repro_torch.core.shard_plan import compute_spill
from repro_torch.data import locality as tloc
from repro_torch.launch.mesh import run_ranks

SUM_TOL = dict(rtol=2e-5, atol=2e-5)
ROWS, SEGS = 256, 8
#: the drives: (spill fraction, refine passes, exchange, replicate outputs)
DRIVES = {"no_spill": (0.0, 0, "collective", False),
          "spill": (0.25, 1, "collective", True),
          "host": (0.0, 0, "host", True)}
WINDOW_KEYS = ("window_steps", "steps_in_window", "window_full",
               "hot_lookups", "cold_lookups", "hot_traffic_fraction",
               "adaptive", "slab_epoch", "hot_swaps", "hot_swaps_rejected",
               "spilled_lookups")
PLAN_KEYS = ("shards", "exchange", "replicate_outputs", "host_syncs",
             "exchange_row_bytes", "exchange_row_bytes_est", "units",
             "fused_units", "hot_rows", "hot_slab_bytes", "hot_lookups",
             "cold_lookups", "hot_traffic_fraction", "exchange_index_bytes",
             "exchange_index_bytes_est", "exchange_savings_bytes",
             "hot_swaps", "spilled_lookups")


# ---------------------------------------------------------------------------
# The copied units against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_windowed_counts_and_reranking_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    a = tloc.WindowedCounts(32, window_steps=6, num_windows=3)
    b = jloc.WindowedCounts(32, window_steps=6, num_windows=3)
    prev = rng.choice(32, 5, replace=False)
    for _ in range(11):
        ids = rng.integers(-2, 34, rng.integers(0, 20))
        a.add(ids)
        b.add(ids)
        assert a.full == b.full and a.steps == b.steps
        np.testing.assert_array_equal(a.totals(), b.totals())
        for k in (1, 5, 9):
            np.testing.assert_array_equal(
                tloc.classify_hot_from_counts(a.totals(), k, prev_hot=prev),
                jloc.classify_hot_from_counts(b.totals(), k, prev_hot=prev))


@pytest.mark.parametrize("pair", [
    [[50, 5], [4, 52]], [[90, 2], [3, 10]], [[9]], [[0, 0], [0, 0]],
    [[90, 30, 0], [0, 10, 0], [0, 0, 10]], [[7, 1, 2], [3, 40, 1], [0, 2, 6]],
])
@pytest.mark.parametrize("frac,ratio", [(0.25, 1.5), (0.5, 1.1), (0.0, 1.5)])
def test_compute_spill_matches_the_reference(pair, frac, ratio):
    pair = np.array(pair)
    assert compute_spill(pair, frac, ratio) == \
        ref_compute_spill(pair, frac, ratio)


def test_adaptive_config_is_the_references():
    for bad in (dict(window_steps=2, num_windows=4),
                dict(drift_threshold=0.0), dict(spill_fraction=1.5),
                dict(refine_passes=-1)):
        with pytest.raises(ValueError):
            tloc.AdaptiveHotConfig(**bad)
    assert hash(tloc.AdaptiveHotConfig()) == hash(tloc.AdaptiveHotConfig())
    assert tloc.AdaptiveHotConfig().__dict__ == \
        jloc.AdaptiveHotConfig().__dict__


# ---------------------------------------------------------------------------
# The executor surface on one device
# ---------------------------------------------------------------------------

def _prog():
    return tops.EmbeddingProgram("adapt1", (
        ("t", tops.EmbeddingOp("sls", 4, 64, 8, avg_lookups=4)),))


def test_executor_for_keys_on_adaptive_config():
    from repro_torch.core.executor import clear_executor_cache, executor_for
    clear_executor_cache()
    prog, kw = _prog(), dict(device="cpu", backend="torch")
    a = executor_for(prog, **kw)
    b = executor_for(prog, **kw, adaptive=tloc.AdaptiveHotConfig())
    c = executor_for(prog, **kw,
                     adaptive=tloc.AdaptiveHotConfig(window_steps=8))
    assert a is not b and b is not c
    assert executor_for(prog, **kw, adaptive=tloc.AdaptiveHotConfig()) is b
    clear_executor_cache()


def test_adaptive_rejects_wrong_type():
    from repro_torch.core.executor import ProgramExecutor
    from repro_torch.core.pipeline import compile_program
    with pytest.raises(TypeError):
        ProgramExecutor(compile_program(_prog(), "O1", use_cache=False),
                        device="cpu", adaptive=object())


def test_single_shard_swap_is_a_noop():
    from repro_torch.core.executor import ProgramExecutor
    from repro_torch.core.pipeline import compile_program
    ex = ProgramExecutor(compile_program(_prog(), "O1", use_cache=False),
                         device="cpu", adaptive=tloc.AdaptiveHotConfig())
    assert ex.swap_hot_slab({"t": (1, 2, 3)}) is False
    assert ex.slab_epoch == 0 and ex.stats["hot_swaps"] == 0
    ws = ex.window_stats()
    assert ws["adaptive"] and ws["slab_epoch"] == 0
    assert ws["hot_lookups"] == 0 and ws["steps_in_window"] == 0


# ---------------------------------------------------------------------------
# The live swap on two shards: one drive, run by either package
# ---------------------------------------------------------------------------

def drift_program(m):
    return m.EmbeddingProgram("drift", (
        ("a", m.EmbeddingOp("sls", SEGS, ROWS, 8, avg_lookups=6)),
        ("b", m.EmbeddingOp("sls", SEGS, ROWS, 8, avg_lookups=6)),
    ))


def drift_inputs() -> list:
    """The drive's step inputs (numpy; tables shared by every step): six
    steps on the head [0, 32), fourteen on the disjoint [64, 96), then
    steps over every row."""
    rng = np.random.default_rng(0)
    tables = {n: rng.standard_normal((ROWS, 8)).astype(np.float32)
              for n in ("a", "b")}
    ptrs = np.arange(0, SEGS * 6 + 1, 6, dtype=np.int64)

    def step(lo, hi):
        return {n: {"table": tables[n], "ptrs": ptrs,
                    "idxs": rng.integers(lo, hi, SEGS * 6).astype(np.int32)}
                for n in ("a", "b")}
    return ([step(0, 32) for _ in range(6)] +
            [step(64, 96) for _ in range(14)] +
            [step(0, ROWS) for _ in range(14)])


def run_drift(make, outputs, drive: str) -> dict:
    """The drive on executors ``make(hot_rows, adaptive, exchange,
    replicate_outputs)`` builds in the caller's package (whose locality
    module is ``make.locality``); ``outputs(ex, got)`` gives a step's whole
    outputs as numpy.  Returns every output, decision and statistic by
    name."""
    spill, refine, exchange, repl = DRIVES[drive]
    cfg = make.locality.AdaptiveHotConfig(
        window_steps=4, num_windows=2, drift_threshold=0.6,
        min_swap_interval=4, spill_fraction=spill, refine_passes=refine)
    hot = {n: tuple(range(32)) for n in ("a", "b")}
    ex = make(hot, cfg, exchange, repl)
    ins = drift_inputs()
    out: dict = {}

    def note(tag):
        out[f"{tag}/epoch"] = np.array(ex.slab_epoch)
        out[f"{tag}/stats"] = np.array([ex.stats[k] for k in
                                        ("hot_swaps", "hot_swaps_rejected",
                                         "hot_lookups", "cold_lookups",
                                         "spilled_lookups",
                                         "exchange_index_bytes",
                                         "table_restacks")])
        ws = ex.window_stats()
        out[f"{tag}/window"] = np.array([float(ws[k]) for k in WINDOW_KEYS])
        out[f"{tag}/ref_frac"] = np.array(
            -1.0 if ws["reference_hot_fraction"] is None
            else ws["reference_hot_fraction"])
        for n in ("a", "b"):
            out[f"{tag}/hot/{n}"] = np.array(sorted(ex.hot_rows[n]))

    for k in range(20):
        for n, v in outputs(ex, ex.step(ins[k])).items():
            out[f"step{k}/{n}"] = v
        note(f"step{k}")
    aps = ex.access_plan_stats()
    out["plan_stats"] = np.array([float(aps[k]) if not isinstance(aps[k], str)
                                  else float(aps[k] == "collective")
                                  for k in PLAN_KEYS])
    # the swap path IS the cold path: a fresh executor with the swapped set
    cold = make(dict(ex.hot_rows), None, exchange, repl)
    got, want = (outputs(e, e.step(ins[20])) for e in (ex, cold))
    out["cold_equal"] = np.array(all(np.array_equal(got[n], want[n])
                                     for n in got))
    for n, v in got.items():
        out[f"step20/{n}"] = v
    # churn: ten direct swaps keep every staging entry
    hot_a = {n: tuple(range(32)) for n in ("a", "b")}
    hot_b = {n: tuple(range(100, 132)) for n in ("a", "b")}
    pool0 = ex.pool.stats["entries"]
    for i in range(10):
        out[f"swap{i}/ok"] = np.array(ex.swap_hot_slab(hot_a if i % 2
                                                       else hot_b))
        for n, v in outputs(ex, ex.step(ins[21 + i])).items():
            out[f"swap{i}/{n}"] = v
    note("churn")
    out["pool_grew"] = np.array(ex.pool.stats["entries"] != pool0)
    out["epochs_agree"] = np.array(all(u.plan.epoch == ex.slab_epoch
                                       for u in ex._units
                                       if u.group is not None))
    # a geometry-changing candidate is rejected whole
    before = ex.slab_epoch
    out["rejected"] = np.array(
        not ex.swap_hot_slab({n: (0, 1) for n in ("a", "b")}) and
        ex.slab_epoch == before)
    for n, v in outputs(ex, ex.step(ins[31])).items():
        out[f"reject/{n}"] = v
    # a stale plan fails loud
    u = next(u for u in ex._units if u.group is not None)
    u.plan.epoch -= 1
    try:
        ex.step(ins[32])
        out["stale_raised"] = np.array(False)
    except RuntimeError as e:
        out["stale_raised"] = np.array("stale access plan" in str(e))
    u.plan.epoch += 1
    for n, v in outputs(ex, ex.step(ins[33])).items():
        out[f"after/{n}"] = v
    note("end")
    return out


_REF_CODE = """
import sys
import jax
import numpy as np
sys.path.insert(0, "tests")
import test_torch_adaptive_locality as T
from repro.core import cost_model, ops, pipeline
from repro.core.executor import ProgramExecutor
from repro.data import locality
from repro.launch.mesh import axis_types_kw

mesh = jax.make_mesh((1, 2), ("data", "model"), **axis_types_kw(2))
prog = T.drift_program(ops)
hot0 = {{n: tuple(range(32)) for n in ("a", "b")}}
chot = pipeline.compile_program(prog, "O3", use_cache=False, hot_rows=hot0,
                                budget=cost_model.FusionBudget(shards=2))


def make(hot, cfg, exchange, repl):
    return ProgramExecutor(chot, backend="pallas", mesh=mesh, hot_rows=hot,
                           adaptive=cfg, exchange=exchange,
                           replicate_outputs=repl)


make.locality = locality
out = {{}}
for drive in T.DRIVES:
    res = T.run_drift(make, lambda ex, got: {{n: np.asarray(v)
                                             for n, v in got.items()}},
                      drive)
    out.update({{f"{{drive}}/{{k}}": v for k, v in res.items()}})
np.savez({path!r}, **out)
print("REF_OK")
"""

_MEMO: dict = {}


@pytest.fixture
def reference(run_on_mesh, tmp_path_factory) -> dict:
    if "ref" not in _MEMO:
        path = tmp_path_factory.mktemp("adaptive_ref") / "ref.npz"
        run_on_mesh(_REF_CODE.format(path=str(path)), devices=2,
                    sentinel="REF_OK")
        with np.load(path) as z:
            _MEMO["ref"] = dict(z)
    return _MEMO["ref"]


def _port_drives(rank: int, world: int) -> dict:
    from repro_torch.convert import program_inputs_to_torch
    from repro_torch.core import pipeline
    from repro_torch.core.executor import ProgramExecutor
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(world, device="cpu")
    prog = drift_program(tops)
    hot0 = {n: tuple(range(32)) for n in ("a", "b")}
    chot = pipeline.compile_program(prog, "O3", use_cache=False,
                                    hot_rows=hot0,
                                    budget=tcm.FusionBudget(shards=2))
    tables = {}     # id(numpy table) -> (the table, its tensor)

    def torch_inputs(ins):
        # one tensor per numpy table, so every step binds the same objects
        # (the tables are kept alive here: their ids stay unique)
        out = {}
        for n, v in ins.items():
            hit = tables.get(id(v["table"]))
            if hit is None:
                hit = tables[id(v["table"])] = (
                    v["table"], program_inputs_to_torch(
                        {n: {"table": v["table"]}}, "cpu")[n]["table"])
            out[n] = {**v, "table": hit[1]}
        return out

    class Make:
        locality = tloc

        def __call__(self, hot, cfg, exchange, repl):
            ex = ProgramExecutor(chot, device="cpu", mesh=mesh,
                                 hot_rows=hot, adaptive=cfg,
                                 exchange=exchange, replicate_outputs=repl)
            step = ex.step
            ex.step = lambda ins: step(torch_inputs(ins))
            return ex

    out = {}
    for drive in DRIVES:
        res = run_drift(Make(), lambda ex, got: {
            n: v.numpy().copy() for n, v in ex.full_outputs(got).items()},
            drive)
        out.update({f"{drive}/{k}": v for k, v in res.items()})
    return out


@pytest.fixture
def port() -> list:
    if "port" not in _MEMO:
        _MEMO["port"] = run_ranks(_port_drives, 2)
    return _MEMO["port"]


def _keys(reference, drive, kind):
    return sorted(k for k in reference if k.startswith(f"{drive}/") and
                  kind(k.split("/")))


@pytest.mark.parametrize("drive", list(DRIVES))
def test_adaptive_outputs_match_the_reference(reference, port, drive):
    keys = _keys(reference, drive, lambda p: p[-1] in ("a", "b") and
                 p[-2] != "hot")
    assert len(keys) > 60
    for res in port:
        for k in keys:
            np.testing.assert_allclose(res[k], reference[k], **SUM_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("drive", list(DRIVES))
def test_adaptive_decisions_match_the_reference(reference, port, drive):
    """Swaps, epochs, hot sets, windows and stats of the reference, on
    both ranks."""
    keys = _keys(reference, drive, lambda p: not (
        p[-1] in ("a", "b") and p[-2] != "hot") and p[-1] != "plan_stats")
    # the staging buckets are the port's own (no max_lookups grid bucket):
    # its pool keeps its entries through the swaps whatever the reference's
    # does
    keys = [k for k in keys if not k.endswith("/pool_grew")]
    for res in port:
        for k in keys:
            np.testing.assert_array_equal(res[k], reference[k], err_msg=k)
        assert not res[f"{drive}/pool_grew"]
    r = reference
    assert r[f"{drive}/churn/stats"][0] >= 11          # hot_swaps
    assert set(r[f"{drive}/step19/hot/a"]) & set(range(64, 96))
    for flag in ("epochs_agree", "rejected", "stale_raised"):
        assert r[f"{drive}/{flag}"], flag
    # a swapped slab gives a cold-built executor's bits where hot lookups
    # are served at their source (collective); the host exchange's
    # round-robin start is per-step feedback a cold executor lacks
    assert bool(r[f"{drive}/cold_equal"]) == (DRIVES[drive][2] ==
                                              "collective")


@pytest.mark.parametrize("drive", list(DRIVES))
def test_access_plan_stats_match_the_reference(reference, port, drive):
    for res in port:
        np.testing.assert_array_equal(res[f"{drive}/plan_stats"],
                                      reference[f"{drive}/plan_stats"])


@pytest.mark.parametrize("drive", list(DRIVES))
def test_the_ranks_decide_alike(port, drive):
    r0, r1 = port
    for k in r0:
        if k.startswith(f"{drive}/"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
