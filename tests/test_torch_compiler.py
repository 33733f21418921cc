"""The port's copy of the compiler front end against the reference: for the
same programs, the same units and members, the same AccessPlan fields and
the same DLC text, at every opt level."""
import dataclasses

import numpy as np
import pytest

from repro.core import dlc as jdlc
from repro.core import ops as jops
from repro.core.pipeline import compile_program as jcompile
from repro_torch.core import dlc as tdlc
from repro_torch.core import ops as tops
from repro_torch.core.pipeline import compile_program as tcompile

# four features of DLRM-DCNv2 with their published multi-hot sizes
DLRM_HOT = (3, 100, 27, 10)


def _programs(m):
    """The same programs built from either package's ops module ``m``."""
    op = m.EmbeddingOp
    return {
        "single_sls": m.EmbeddingProgram("s", (
            ("t", op("sls", 6, 40, 16, avg_lookups=4)),)),
        "kg": m.EmbeddingProgram("k", (
            ("t", op("kg", 7, 30, 8, semiring=m.Semiring("max", "add"))),)),
        "dlrm_bank": m.EmbeddingProgram("dlrm", tuple(
            (f"f{i}", op("sls", 8, 1000, 128, avg_lookups=h))
            for i, h in enumerate(DLRM_HOT))),
        "shared_gather": m.EmbeddingProgram("g", (
            ("tok", op("gather", 12, 64, 32)),
            ("lab", op("gather", 12, 64, 32)),
            ("moe", op("gather", 24, 40, 32)),
        ), shared_tables=(("tok", "lab"),)),
    }


def _norm(x):
    """A package-neutral, comparable form of compiler artifacts."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, _norm(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tolist())
    if isinstance(x, (list, tuple)):
        return tuple(_norm(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _norm(v)) for k, v in x.items()))
    return x


@pytest.mark.parametrize("name", ["single_sls", "kg", "dlrm_bank",
                                  "shared_gather"])
@pytest.mark.parametrize("lvl", ["O0", "O1", "O2", "O3"])
def test_port_compiles_like_the_reference(name, lvl):
    want = jcompile(_programs(jops)[name], lvl, use_cache=False)
    got = tcompile(_programs(tops)[name], lvl, use_cache=False)
    assert [u.names for u in got.units] == [u.names for u in want.units]
    for gu, wu in zip(got.units, want.units):
        assert _norm(gu.group) == _norm(wu.group)
        assert _norm(gu.result.op) == _norm(wu.result.op)
        assert gu.result.opt == wu.result.opt
        assert _norm(gu.result.access_plan) == _norm(wu.result.access_plan)
        assert tdlc.pretty(gu.result.dlc) == jdlc.pretty(wu.result.dlc)
    assert [r.name for r in got.pass_records()] == \
        [r.name for r in want.pass_records()]


def test_dlrm_bank_fuses_into_one_unit():
    """The fusion budget is the reference's, so the 4-feature bank fuses
    into one SLS unit over 4 stacked tables, as in the reference."""
    got = tcompile(_programs(tops)["dlrm_bank"], "O3", use_cache=False)
    assert len(got.units) == 1 and got.units[0].result.op.num_tables == 4
