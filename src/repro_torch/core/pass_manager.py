"""PassManager — the compiler's pass registry, scheduler and diagnostics.

The hard-coded pass sequence that used to live in :mod:`repro.core.pipeline`
is now data: every stage of emberc is a registered :class:`Pass` with a
declared input IR stage (``op``/``scf``/``slc``/``slcv``/``dlc``), a minimum
opt level, and the compile options it consumes.  The manager

* runs the passes in registration order, skipping those gated off by the opt
  level or whose input stage does not match the current IR stage;
* records per-pass wall time and notes (:class:`PassRecord`) — the
  diagnostics the compile cache and the benchmarks introspect;
* runs an **IR verifier between passes** (``slc.verify`` on SLC/SLCV
  functions, structural checks on SCF and DLC), so a pass that produces a
  malformed function is caught at its own boundary rather than three passes
  later.

Custom passes register with :meth:`PassManager.register` (optionally
positioned ``after=`` an existing pass), which is also how tests inject
deliberately-broken passes to exercise the verifier.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from . import scf as scf_ir
from . import slc as slc_ir
from .access_plan import AccessPlan, plan_access_pass
from .decouple import decouple
from .dlc import DlcProgram, lower_to_dlc
from .ops import EmbeddingOp
from .passes import apply_store_streams, bufferize, queue_align, vectorize
from .scf import ScfFunc, build_scf
from .slc import SlcFunc, SlcVerifyError

#: IR stages a pass may declare.  ``op`` is the frontend EmbeddingOp /
#: EmbeddingProgram level; ``slcv`` is SLC after vectorization (slcv.for
#: loops present); ``program`` marks program-level passes (fusion) that the
#: driver in :mod:`repro.core.pipeline` runs before per-op compilation;
#: ``access`` is the host-side companion of the DLC artifact — the
#: :class:`~repro.core.access_plan.AccessPlan` emitted by ``plan-access``.
STAGES = ("program", "op", "scf", "slc", "slcv", "dlc", "access")


class PassManagerError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class Pass:
    """A registered compiler pass.

    ``stage``     IR stage(s) the pass consumes (str or tuple of str);
    ``produces``  stage of its output (defaults to its input stage);
    ``min_level`` smallest numeric opt level at which the pass runs;
    ``options``   names of compile options forwarded as keyword args.
    """

    name: str
    stage: tuple
    fn: Callable
    produces: Optional[str] = None
    min_level: int = 0
    options: tuple = ()

    def __post_init__(self):
        stage = self.stage if isinstance(self.stage, tuple) else (self.stage,)
        object.__setattr__(self, "stage", stage)
        for s in stage + ((self.produces,) if self.produces else ()):
            assert s in STAGES, f"unknown IR stage {s!r}"


@dataclasses.dataclass
class PassRecord:
    """Per-pass diagnostic entry (the timing/diagnostics surface)."""

    name: str
    stage: str               # input stage the pass saw (or would have seen)
    ran: bool
    duration_s: float = 0.0
    note: str = ""


def _slcv_of(fn: SlcFunc, vlen: int = 128, **_):
    return vectorize(fn, vlen=vlen)


def default_passes() -> list:
    """The emberc pipeline (paper §5–§7) as a pass list."""
    return [
        Pass("build-scf", "op", lambda op, **_: build_scf(op),
             produces="scf"),
        Pass("decouple", "scf", lambda fn, **_: decouple(fn),
             produces="slc"),
        Pass("vectorize", "slc", _slcv_of, produces="slcv",
             min_level=1, options=("vlen",)),
        Pass("bufferize", ("slc", "slcv"), lambda fn, **_: bufferize(fn),
             min_level=2),
        Pass("store-streams", ("slc", "slcv"),
             lambda fn, **_: apply_store_streams(fn), min_level=3),
        Pass("queue-align", ("slc", "slcv"), lambda fn, **_: queue_align(fn),
             min_level=3),
        Pass("lower-dlc", ("slc", "slcv"), lambda fn, **_: lower_to_dlc(fn),
             produces="dlc"),
        # the host-side access artifact: stream layout, capacity-bucket
        # lattice, shard routing table and hot/cold classification as data —
        # what every host marshaling path interprets (repro.core.access_plan)
        Pass("plan-access", "dlc", plan_access_pass, produces="access",
             options=("frontend_op", "group", "shards", "hot_rows")),
    ]


def verify_ir(stage: str, unit) -> None:
    """Inter-pass verifier: structural invariants per IR stage."""
    if stage in ("slc", "slcv"):
        if not isinstance(unit, SlcFunc):
            raise SlcVerifyError(f"stage {stage} holds {type(unit).__name__}")
        slc_ir.verify(unit)
        if stage == "slcv" and not any(
                l.vlen for l, _ in slc_ir.loops(unit.body)):
            raise SlcVerifyError("slcv function has no vectorized loop")
    elif stage == "scf":
        if not isinstance(unit, ScfFunc):
            raise SlcVerifyError(f"stage scf holds {type(unit).__name__}")
        if "out" not in unit.memrefs or not unit.body:
            raise SlcVerifyError("scf function missing out memref or body")
    elif stage == "dlc":
        if not isinstance(unit, DlcProgram):
            raise SlcVerifyError(f"stage dlc holds {type(unit).__name__}")
        tokens = [c.token for c in unit.cases]
        if len(tokens) != len(set(tokens)):
            raise SlcVerifyError(f"duplicate DLC case tokens: {tokens}")
    elif stage == "access":
        if not isinstance(unit, AccessPlan):
            raise SlcVerifyError(
                f"stage access holds {type(unit).__name__}")
        if unit.local_rows <= 0 or len(unit.roff) != unit.num_segments:
            raise SlcVerifyError("access plan has inconsistent geometry")


class PassManager:
    """Runs registered passes over one compilation unit with verification.

    ``PassManager.total_executed`` counts every pass body actually executed
    by *any* manager — the observable the compile-cache tests use to prove a
    cache hit re-ran nothing.
    """

    total_executed = 0

    def __init__(self, passes: Optional[list] = None, verify: bool = True):
        self.passes = list(default_passes() if passes is None else passes)
        self.verify = verify

    def register(self, p: Pass, after: Optional[str] = None) -> None:
        """Insert a pass (at the end, or right after the named pass)."""
        if after is None:
            self.passes.append(p)
            return
        for i, q in enumerate(self.passes):
            if q.name == after:
                self.passes.insert(i + 1, p)
                return
        raise PassManagerError(f"no pass named {after!r} to insert after")

    def run(self, op: EmbeddingOp, opt_level: int, **options):
        """Compile one EmbeddingOp through the registered pipeline.

        Returns ``(artifacts, records)`` where ``artifacts`` maps every
        produced stage name to its IR (``scf``, ``slc`` — the final
        SLC/SLCV function — and ``dlc``).
        """
        unit, stage = op, "op"
        # the frontend op is always available to passes that declare it
        # (plan-access rebuilds the host stream layout from it)
        options.setdefault("frontend_op", op)
        artifacts: dict = {}
        records: list = []
        for p in self.passes:
            if opt_level < p.min_level or stage not in p.stage:
                records.append(PassRecord(p.name, stage, ran=False,
                                          note="opt-gated"
                                          if opt_level < p.min_level
                                          else f"stage {stage} not in "
                                               f"{p.stage}"))
                continue
            kw = {k: options[k] for k in p.options if k in options}
            t0 = time.perf_counter()
            unit = p.fn(unit, **kw)
            dt = time.perf_counter() - t0
            PassManager.total_executed += 1
            stage = p.produces or stage
            if self.verify:
                verify_ir(stage, unit)
            records.append(PassRecord(p.name, stage, ran=True, duration_s=dt))
            if stage in ("slc", "slcv"):
                artifacts["slc"] = unit
            else:
                artifacts[stage] = unit
        if "dlc" not in artifacts:
            raise PassManagerError(
                "pipeline did not reach the DLC stage; passes: "
                f"{[p.name for p in self.passes]}")
        return artifacts, records
