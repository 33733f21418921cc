"""The port's steady-state executor on the CPU (the kernels' plain versions)
against the reference's executor (Pallas kernels in interpret mode) and the
numpy oracle, plus the steady-state contracts within the port: rebind by
identity, zero restacks on a stable feed, in-place update_tables, ragged
capacity buckets, and submit/result == step bit-identically."""
import numpy as np
import pytest
import torch

from repro.core import ops as jops
from repro.core.executor import executor_for as jexecutor_for
from repro.models.lm import LM
from repro.configs.deepseek_v2_lite_16b import reduced as jreduced
from repro_torch.configs.deepseek_v2_lite_16b import reduced as treduced
from repro_torch.convert import program_inputs_to_torch
from repro_torch.core import ops as tops
from repro_torch.core.executor import (ProgramExecutor, clear_executor_cache,
                                       executor_for)
from repro_torch.core.pipeline import compile_program
from repro_torch.kernels import ops as kops
from repro_torch.models.lm import embedding_program

TOL = dict(rtol=2e-5, atol=2e-5)
DLRM_HOT = (3, 100, 27, 10)      # four DLRM-DCNv2 features' multi-hot sizes


def _mixed(m):
    """Every fusable kind: a fused CSR group (weighted + unweighted + kg
    upcast), a fused gather over a shared table, an spmm singleton and a
    max-semiring singleton with E=5, built from either package's ops."""
    op = m.EmbeddingOp
    return m.EmbeddingProgram("mixed", (
        ("w", op("sls", 5, 9, 8, avg_lookups=3, weighted=True)),
        ("u", op("sls", 4, 7, 8, avg_lookups=2)),
        ("k", op("kg", 6, 11, 8)),
        ("g1", op("gather", 6, 20, 8, block_rows=2)),
        ("g2", op("gather", 6, 20, 8, block_rows=2)),
        ("solo", op("spmm", 3, 5, 16, avg_lookups=2)),
        ("mx", op("sls", 7, 6, 5, avg_lookups=2,
                  semiring=m.Semiring("max"))),
    ), shared_tables=(("g1", "g2"),))


def _dlrm(m):
    return m.EmbeddingProgram("dlrm-reduced", tuple(
        (f"f{i}", m.EmbeddingOp("sls", 8, 1000, 128, avg_lookups=h))
        for i, h in enumerate(DLRM_HOT)))


def _feed(prog, seeds, tables=None):
    """Host inputs per step with fixed tables (the steady-state feed)."""
    steps = []
    for s in seeds:
        ins = jops.make_program_inputs(prog, seed=s)
        if tables is None:
            tables = {n: ins[n]["table"] for n in ins}
        for n in ins:
            ins[n]["table"] = tables[n]
        steps.append(ins)
    return steps


def _to_port(steps):
    """The same steps for the port: one tensor per host table (aliasing
    kept), index streams as numpy."""
    conv = program_inputs_to_torch(steps[0], "cpu")
    out = []
    for ins in steps:
        out.append({n: {**{k: np.asarray(v) for k, v in ins[n].items()
                           if k != "table"}, "table": conv[n]["table"]}
                    for n in ins})
    return out


def _assert_outputs(got, want, tol=TOL, exact=False):
    assert set(got) == set(want)
    for n in want:
        g = got[n].numpy()
        if exact:
            np.testing.assert_array_equal(g, np.asarray(want[n]), err_msg=n)
        else:
            np.testing.assert_allclose(g, np.asarray(want[n]), err_msg=n,
                                       **tol)


@pytest.mark.parametrize("lvl", ["O0", "O1", "O2", "O3"])
def test_executor_matches_reference_executor_all_levels(lvl):
    jprog, tprog = _mixed(jops), _mixed(tops)
    host = _feed(jprog, (0, 1, 2))
    ours = _to_port(host)
    jex = jexecutor_for(jprog, lvl, vlen=4, backend="pallas",
                        interpret=True)
    tex = executor_for(tprog, lvl, vlen=4, device="cpu")
    for h, t in zip(host, ours):
        got = tex.step(t)
        _assert_outputs(got, jops.program_reference(jprog, h))
        _assert_outputs(got, jex.step(h))
    assert kops.launch_counts() == {"sls": 0, "block_gather": 0,
                                    "fusedmm": 0, "flash_attention": 0}


def test_reduced_dlrm_bank_matches_reference():
    jprog, tprog = _dlrm(jops), _dlrm(tops)
    host = _feed(jprog, (3, 4))
    ours = _to_port(host)
    tex = executor_for(tprog, "O3", device="cpu")
    assert len(tex.compiled.units) == 1
    jex = jexecutor_for(jprog, "O3", backend="pallas", interpret=True)
    for h, t in zip(host, ours):
        got = tex.step(t)
        _assert_outputs(got, jops.program_reference(jprog, h), TOL)
        _assert_outputs(got, jex.step(h), TOL)


def test_reduced_deepseek_embedding_program_matches_reference():
    jprog = LM(jreduced()).embedding_program(2, 8)
    tprog = embedding_program(treduced(), 2, 8)
    host = _feed(jprog, (5, 6))
    ours = _to_port(host)
    tex = executor_for(tprog, "O3", device="cpu")
    assert [u.names for u in tex.compiled.units] == \
        [("tok_embed", "label_gather", "moe_dispatch")]
    jex = jexecutor_for(jprog, "O3", backend="pallas", interpret=True)
    for h, t in zip(host, ours):
        got = tex.step(t)
        _assert_outputs(got, jops.program_reference(jprog, h), exact=True)
        _assert_outputs(got, jex.step(h), exact=True)


def _fresh(prog=None, depth=2):
    prog = prog or _mixed(tops)
    return ProgramExecutor(compile_program(prog, "O3", vlen=4,
                                           use_cache=False),
                           device="cpu", depth=depth)


def test_stable_feed_never_restacks_and_hits_the_scratch():
    ex = _fresh()
    steps = _to_port(_feed(_mixed(jops), (0,) * 5))
    ex.step(steps[0])
    stacks = ex.stats["table_stacks"]
    assert stacks == len(ex.compiled.units)
    tables = [id(u.table) for u in ex._units]
    misses = ex.stats["marshal_misses"]
    for ins in steps[1:]:
        ex.step(ins)
    assert ex.stats["table_stacks"] == stacks
    assert ex.stats["table_rebinds"] == 0
    assert [id(u.table) for u in ex._units] == tables
    assert ex.stats["marshal_misses"] == misses
    assert ex.stats["marshal_hits"] >= 4 * 3


def test_other_tables_rebind_by_identity():
    ex = _fresh()
    host = _feed(_mixed(jops), (0,))
    first = _to_port(host)[0]
    ex.step(first)
    other_host = _feed(_mixed(jops), (9,))
    other = _to_port(other_host)[0]
    got = ex.step(other)
    assert ex.stats["table_rebinds"] == len(ex.compiled.units)
    _assert_outputs(got, jops.program_reference(_mixed(jops),
                                                other_host[0]))


def test_update_tables_copies_into_the_owned_stack():
    ex = _fresh()
    ex.step(_to_port(_feed(_mixed(jops), (0,)))[0])
    owned = [u for u in ex._units if u.owns_table]
    assert len(owned) == 1
    stack = owned[0].table
    new_host = _feed(_mixed(jops), (7,))
    new = _to_port(new_host)[0]
    ex.update_tables(new)
    assert owned[0].table is stack          # refreshed in place
    assert ex.stats["table_restacks"] == 1
    assert ex.stats["table_rebinds"] == len(ex.compiled.units) - 1
    _assert_outputs(ex.step(new), jops.program_reference(_mixed(jops),
                                                         new_host[0]))
    ex.update_tables(new)                   # same tensors: a no-op
    assert ex.stats["table_restacks"] == 1


def test_ragged_sequence_through_capacity_buckets():
    jprog = jops.EmbeddingProgram("ragged", (
        ("a", jops.EmbeddingOp("sls", 6, 12, 8, avg_lookups=2)),
        ("b", jops.EmbeddingOp("sls", 5, 9, 8, avg_lookups=12)),
    ))
    tprog = tops.EmbeddingProgram("ragged", (
        ("a", tops.EmbeddingOp("sls", 6, 12, 8, avg_lookups=2)),
        ("b", tops.EmbeddingOp("sls", 5, 9, 8, avg_lookups=12)),
    ))
    ex = _fresh(tprog)
    host = _feed(jprog, [s * 31 + 1 for s in range(6)])
    results = ex.run_steps(_to_port(host))
    assert ex.stats["max_inflight"] == 2
    for got, h in zip(results, host):
        _assert_outputs(got, jops.program_reference(jprog, h))
    assert len({key[1] for key in ex.pool._entries}) >= 2


def test_submit_result_is_step_bit_identical():
    steps = _to_port(_feed(_mixed(jops), (11, 12, 13, 14)))
    sync = [_fresh().step(ins) for ins in steps]   # one executor per step
    ex = _fresh(depth=3)
    handles = [ex.submit(ins) for ins in steps]
    for h, want in zip(handles, sync):
        _assert_outputs(h.result(), {n: t.numpy() for n, t in want.items()},
                        exact=True)
    ex2 = _fresh()
    for ins, want in zip(steps, sync):
        _assert_outputs(ex2.step(ins), {n: t.numpy()
                                        for n, t in want.items()},
                        exact=True)


@pytest.mark.parametrize("policy", ["strict", "clamp", "drop"])
def test_index_policies_match_the_reference(policy):
    """Out-of-range indices: strict raises the typed error, clamp and drop
    repair them exactly as the reference executor does, and count."""
    from repro.core.access_plan import MalformedAccessError as JErr
    from repro_torch.core.access_plan import MalformedAccessError as TErr
    jprog, tprog = _mixed(jops), _mixed(tops)
    host = _feed(jprog, (21,))
    host[0]["u"]["idxs"][0] = 10_000            # past the table
    host[0]["k"]["idxs"][1] = -3
    ours = _to_port(host)
    jex = jexecutor_for(jprog, "O3", vlen=4, backend="pallas",
                        interpret=True, index_policy=policy)
    tex = executor_for(tprog, "O3", vlen=4, device="cpu",
                       index_policy=policy)
    if policy == "strict":
        with pytest.raises(TErr):
            tex.step(ours[0])
        with pytest.raises(JErr):
            jex.step(host[0])
        return
    keys = ("oob_lookups", "dropped_lookups")
    before = [(tex.stats[k], jex.stats[k]) for k in keys]
    _assert_outputs(tex.step(ours[0]), jex.step(host[0]))
    counted = [(tex.stats[k] - t, jex.stats[k] - j)
               for k, (t, j) in zip(keys, before)]
    assert all(t == j for t, j in counted)
    assert sum(t for t, _ in counted) == 2


def test_executor_for_memoizes_and_fusedmm_raises():
    """Memoised per signature; the fusedmm unit (which raised before it had
    a kernel) now runs and equals the numpy oracle."""
    clear_executor_cache()
    prog = _mixed(tops)
    assert executor_for(prog, "O3", device="cpu") is \
        executor_for(prog, "O3", device="cpu")
    fprog = tops.EmbeddingProgram("f", (
        ("m", tops.EmbeddingOp("fusedmm", 4, 4, 8, avg_lookups=2)),))
    host = tops.make_program_inputs(fprog)
    got = executor_for(fprog, "O3", device="cpu").step(
        program_inputs_to_torch(host, "cpu"))
    np.testing.assert_allclose(got["m"].numpy(),
                               tops.program_reference(fprog, host)["m"],
                               rtol=1e-4, atol=1e-4)


def test_tables_must_be_tensors_on_the_executor_device():
    ex = _fresh()
    with pytest.raises(TypeError, match="tensors"):
        ex.step(_feed(_mixed(jops), (0,))[0])     # numpy tables
    assert torch.device("cpu") == ex.device
