"""Structured Lookup-Compute (SLC) IR — the paper's contribution #5 (§6).

The SLC IR extends structured control flow with *streams* (lookup-side
values produced by the access unit) and *callbacks* (execute-side compute
wrapped inside the loops that trigger it).  Crucially — and this is the whole
point of the IR — callbacks read stream values through explicit
``to_val`` conversions (:class:`ToVal`), so the data flow between access and
execute code is *not* (de)serialized through queues yet.  That keeps global
analyses (vectorization, bufferization, code motion across the
access/execute boundary) straightforward; the queue machinery only appears
after lowering to DLC (:mod:`repro.core.dlc`).

Node inventory (paper Fig 12 grammar, adapted):

=================  =========================================================
``SlcFor``         ``slc.for`` / ``slcv.for`` (when ``vlen`` is set); may own
                   loop-carried execute-side counters (``carry``, §7.3)
``MemStr``         ``slc.mem_str`` — load stream
``AluStr``         ``slc.alu_str`` — integer ALU stream
``BufStr``         ``slcv.buf_str`` — buffer stream (§7.2), reset per
                   enclosing iteration
``PushBuf``        ``slc.push`` into a buffer stream
``Callback``       ``slc.callback`` — imperative compute (SCF stmts + ToVal)
``StoreBuf``       whole-vector store of a buffer into a memref row; the
                   bufferized dual of the element-wise accumulate callback.
                   ``as_store_stream=True`` marks it for access-unit direct
                   store (model-specific opt, §7.4)
=================  =========================================================
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from .ops import EmbeddingOp
from . import scf

# ---------------------------------------------------------------------------
# Stream-index expressions (what MemStr/AluStr indices may contain)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamRef:
    name: str


SIdx = Union[scf.Const, scf.Param, StreamRef, "SBin"]


@dataclasses.dataclass(frozen=True)
class SBin:
    op: str
    a: SIdx
    b: SIdx


# ---------------------------------------------------------------------------
# Callback-body expression extensions (usable inside scf exprs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ToVal:
    """slc.to_val — materialize the current stream value on the core."""
    stream: str


@dataclasses.dataclass(frozen=True)
class DotBuf:
    """Dot product of two buffer streams (fusedmm's SDDMM reduction)."""
    buf_a: str
    buf_b: str
    fn: str = "identity"   # post-reduction scalar function


# ---------------------------------------------------------------------------
# SLC statements
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MemStr:
    stream: str
    memref: str
    indices: tuple  # of SIdx


@dataclasses.dataclass
class AluStr:
    stream: str
    op: str
    a: SIdx
    b: SIdx


@dataclasses.dataclass
class AccStr:
    """Accumulation stream (paper §7.4): the access unit tracks segment
    boundaries by accumulating lengths instead of loading offsets.  Value is
    the *exclusive* running sum (the total BEFORE this iteration's add)."""
    stream: str
    src: object        # SIdx added per enclosing-loop iteration
    init: int = 0


@dataclasses.dataclass
class BufStr:
    stream: str


@dataclasses.dataclass
class PushBuf:
    buf: str
    src: str  # source stream


@dataclasses.dataclass
class Callback:
    body: list  # scf stmts, exprs may contain ToVal / DotBuf


@dataclasses.dataclass
class StoreBuf:
    memref: str
    row_indices: tuple          # of callback exprs (ToVal / VarRef / Const)
    buf: str
    accumulate: Optional[str]   # None overwrite, else semiring-add name
    scale: Optional[object] = None   # optional callback expr multiplied in
    as_store_stream: bool = False    # §7.4: bypass the core entirely


@dataclasses.dataclass
class SlcFor:
    stream: str
    lb: SIdx
    ub: SIdx
    body: list
    vlen: Optional[int] = None      # set by the vectorize pass (slcv.for)
    carry: dict = dataclasses.field(default_factory=dict)  # var -> init


SlcNode = Union[MemStr, AluStr, AccStr, BufStr, PushBuf, Callback,
                StoreBuf, SlcFor]


@dataclasses.dataclass
class SlcFunc:
    name: str
    memrefs: dict
    params: dict
    body: list
    op: EmbeddingOp
    # optimization record: which passes ran (drives DLC lowering + backends)
    opt: dict = dataclasses.field(default_factory=lambda: {
        "vectorized": False, "vlen": None, "bufferized": False,
        "queue_aligned": False, "store_streams": False,
    })


# ---------------------------------------------------------------------------
# Structural helpers / verifier
# ---------------------------------------------------------------------------

def walk(body, fn, depth=0):
    for node in body:
        fn(node, depth)
        if isinstance(node, SlcFor):
            walk(node.body, fn, depth + 1)
        elif isinstance(node, Callback):
            pass


def loops(body):
    out = []
    walk(body, lambda n, d: out.append((n, d)) if isinstance(n, SlcFor) else None)
    return out


def innermost_loop(fn: SlcFunc) -> Optional[SlcFor]:
    ls = loops(fn.body)
    if not ls:
        return None
    return max(ls, key=lambda t: t[1])[0]


def streams_defined(body) -> set:
    out = set()

    def f(n, d):
        if isinstance(n, (MemStr, AluStr, AccStr, BufStr)):
            out.add(n.stream)
        elif isinstance(n, SlcFor):
            out.add(n.stream)
    walk(body, f)
    return out


def _expr_streams(e, acc):
    if isinstance(e, ToVal):
        acc.add(e.stream)
    elif isinstance(e, DotBuf):
        acc.add(e.buf_a)
        acc.add(e.buf_b)
    elif isinstance(e, scf.Bin):
        _expr_streams(e.a, acc)
        _expr_streams(e.b, acc)
    elif isinstance(e, scf.Apply):
        _expr_streams(e.a, acc)
    elif isinstance(e, scf.Load):
        for i in e.indices:
            _expr_streams(i, acc)


def callback_streams(node) -> set:
    """Streams a callback/StoreBuf converts to values (its queue operands)."""
    acc: set = set()
    if isinstance(node, StoreBuf):
        for i in node.row_indices:
            _expr_streams(i, acc)
        acc.add(node.buf)
        if node.scale is not None:
            _expr_streams(node.scale, acc)
        return acc

    def stmts(body):
        for s in body:
            if isinstance(s, (scf.Let, scf.SetVar)):
                _expr_streams(s.value, acc)
            elif isinstance(s, scf.Store):
                for i in s.indices:
                    _expr_streams(i, acc)
                _expr_streams(s.value, acc)
            elif isinstance(s, scf.For):
                _expr_streams(s.lb, acc)
                _expr_streams(s.ub, acc)
                stmts(s.body)
    stmts(node.body)
    return acc


class SlcVerifyError(Exception):
    pass


def verify(fn: SlcFunc):
    """Structural invariants every SLC function must satisfy."""
    defined: set = set(fn.params)

    def check_sidx(e, scope):
        if isinstance(e, StreamRef):
            if e.name not in scope:
                raise SlcVerifyError(f"use of undefined stream {e.name!r}")
        elif isinstance(e, SBin):
            check_sidx(e.a, scope)
            check_sidx(e.b, scope)

    def rec(body, scope):
        scope = set(scope)
        for node in body:
            if isinstance(node, SlcFor):
                check_sidx(node.lb, scope)
                check_sidx(node.ub, scope)
                rec(node.body, scope | {node.stream})
                scope.add(node.stream)
            elif isinstance(node, MemStr):
                if node.memref not in fn.memrefs:
                    raise SlcVerifyError(f"unknown memref {node.memref!r}")
                if not fn.memrefs[node.memref].read_only:
                    raise SlcVerifyError(
                        f"mem_str over writable memref {node.memref!r}: the "
                        "access unit may only read read-only data (§6.2)")
                for i in node.indices:
                    check_sidx(i, scope)
                scope.add(node.stream)
            elif isinstance(node, AluStr):
                check_sidx(node.a, scope)
                check_sidx(node.b, scope)
                scope.add(node.stream)
            elif isinstance(node, AccStr):
                check_sidx(node.src, scope)
                scope.add(node.stream)
            elif isinstance(node, BufStr):
                scope.add(node.stream)
            elif isinstance(node, PushBuf):
                if node.buf not in scope or node.src not in scope:
                    raise SlcVerifyError("push into/from undefined stream")
            elif isinstance(node, (Callback, StoreBuf)):
                for s in callback_streams(node):
                    if s not in scope:
                        raise SlcVerifyError(
                            f"callback reads undefined stream {s!r}")
            else:
                raise SlcVerifyError(f"unknown node {node!r}")
    rec(fn.body, set())
    return True


def pretty(fn: SlcFunc) -> str:
    """Render SLC in the paper's surface syntax (Fig 15) for inspection."""
    lines = [f"void {fn.name}(...)  // opt={ {k: v for k, v in fn.opt.items() if v} }"]

    def sidx(e):
        if isinstance(e, scf.Const):
            return str(e.value)
        if isinstance(e, scf.Param):
            return e.name
        if isinstance(e, StreamRef):
            return e.name
        if isinstance(e, SBin):
            return f"({sidx(e.a)}{e.op}{sidx(e.b)})"
        return repr(e)

    def expr(e):
        if isinstance(e, ToVal):
            return f"slc.to_val({e.stream})"
        if isinstance(e, DotBuf):
            d = f"dot({e.buf_a},{e.buf_b})"
            return d if e.fn == "identity" else f"{e.fn}({d})"
        if isinstance(e, scf.Const):
            return str(e.value)
        if isinstance(e, scf.Param):
            return e.name
        if isinstance(e, scf.VarRef):
            return e.name
        if isinstance(e, scf.Load):
            return f"{e.memref}[{','.join(expr(i) for i in e.indices)}]"
        if isinstance(e, scf.Bin):
            return f"({expr(e.a)}{e.op}{expr(e.b)})"
        if isinstance(e, scf.Apply):
            return f"{e.fn}({expr(e.a)})"
        return repr(e)

    def stmt(s, ind):
        pad = "  " * ind
        if isinstance(s, scf.Let):
            lines.append(f"{pad}{s.var} = {expr(s.value)};")
        elif isinstance(s, scf.SetVar):
            lines.append(f"{pad}{s.var} = {expr(s.value)};")
        elif isinstance(s, scf.Store):
            tgt = f"{s.memref}[{','.join(expr(i) for i in s.indices)}]"
            op = {"add": "+=", None: "="}.get(s.accumulate, f"{s.accumulate}=")
            lines.append(f"{pad}{tgt} {op} {expr(s.value)};")
        elif isinstance(s, scf.For):
            lines.append(f"{pad}for({s.var}={expr(s.lb)}; {s.var}<{expr(s.ub)}; {s.var}++){{")
            for b in s.body:
                stmt(b, ind + 1)
            lines.append(f"{pad}}}")

    def rec(body, ind):
        pad = "  " * ind
        for node in body:
            if isinstance(node, SlcFor):
                v = f"<{node.vlen}>" if node.vlen else ""
                carry = f" carry{node.carry}" if node.carry else ""
                lines.append(
                    f"{pad}slc{'v' if node.vlen else ''}.for{v}(stream {node.stream}"
                    f" from {sidx(node.lb)} to {sidx(node.ub)}){carry}{{")
                rec(node.body, ind + 1)
                lines.append(f"{pad}}}")
            elif isinstance(node, MemStr):
                idx = ",".join(sidx(i) for i in node.indices)
                lines.append(f"{pad}stream {node.stream} = slc.mem_str({node.memref}[{idx}]);")
            elif isinstance(node, AluStr):
                lines.append(f"{pad}stream {node.stream} = slc.alu_str({sidx(node.a)}{node.op}{sidx(node.b)});")
            elif isinstance(node, AccStr):
                lines.append(f"{pad}stream {node.stream} = slc.acc_str(+= {sidx(node.src)}, init={node.init});")
            elif isinstance(node, BufStr):
                lines.append(f"{pad}stream {node.stream} = slcv.buf_str();")
            elif isinstance(node, PushBuf):
                lines.append(f"{pad}slc.push({node.buf}, {node.src});")
            elif isinstance(node, StoreBuf):
                row = ",".join(expr(i) for i in node.row_indices)
                sc = f"{expr(node.scale)} * " if node.scale is not None else ""
                op = {"add": "+=", None: "="}.get(node.accumulate, f"{node.accumulate}=")
                ss = "  // store-stream (access-unit direct)" if node.as_store_stream else ""
                lines.append(f"{pad}{node.memref}[{row},:] {op} {sc}vec({node.buf});{ss}")
            elif isinstance(node, Callback):
                lines.append(f"{pad}slc.callback{{")
                for s in node.body:
                    stmt(s, ind + 1)
                lines.append(f"{pad}}}")
    rec(fn.body, 1)
    return "\n".join(lines)
