"""Structured Control Flow (SCF) IR.

This is Ember's *input* IR (paper Fig 13a): the loop-nest form of an
embedding operation as it comes out of torch-mlir / MPACT.  We model it as a
small tree of dataclasses with executable semantics (:func:`interp_scf`),
which the SCF→SLC decoupling algorithm (:mod:`repro.core.decouple`) consumes.

Expressions are side-effect free; statements mutate scalar variables
(``Let``/``SetVar``) or memrefs (``Store``).  Loop bounds may be expressions
over parent-loop loads (e.g. ``ptrs[b]``) — exactly the pattern whose
offloadability the paper's decoupling legality rules reason about.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from .ops import EmbeddingOp, Semiring

# ----------------------------------------------------------------------------
# Expressions
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Const:
    value: Union[int, float]


@dataclasses.dataclass(frozen=True)
class Param:
    """A compile-time-known scalar (e.g. emb_len, num_segments)."""
    name: str


@dataclasses.dataclass(frozen=True)
class VarRef:
    name: str


@dataclasses.dataclass(frozen=True)
class Load:
    memref: str
    indices: tuple


@dataclasses.dataclass(frozen=True)
class Bin:
    op: str  # + - * / min max
    a: "Expr"
    b: "Expr"


@dataclasses.dataclass(frozen=True)
class Apply:
    """Unary scalar function (fusedmm's f(s)); kept abstract by name."""
    fn: str  # 'relu' | 'identity'
    a: "Expr"


Expr = Union[Const, Param, VarRef, Load, Bin, Apply]

# ----------------------------------------------------------------------------
# Statements
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class Let:
    var: str
    value: Expr


@dataclasses.dataclass
class SetVar:
    var: str
    value: Expr


@dataclasses.dataclass
class Store:
    memref: str
    indices: tuple
    value: Expr
    accumulate: Optional[str] = None  # None = overwrite; else ⊕ op name


@dataclasses.dataclass
class For:
    var: str
    lb: Expr
    ub: Expr
    body: list


Stmt = Union[Let, SetVar, Store, For]


@dataclasses.dataclass
class MemRefDecl:
    name: str
    rank: int
    dtype: str
    read_only: bool


@dataclasses.dataclass
class ScfFunc:
    name: str
    memrefs: dict          # name -> MemRefDecl
    params: dict           # name -> int
    body: list             # list[Stmt]
    op: EmbeddingOp        # provenance


# ----------------------------------------------------------------------------
# Builders: EmbeddingOp -> SCF loop nest (paper Fig 10b / Table 1 col 2)
# ----------------------------------------------------------------------------

def build_scf(op: EmbeddingOp) -> ScfFunc:
    sr = op.semiring
    P = Param

    def decl(name, rank, ro=True, dtype=None):
        return MemRefDecl(name, rank, dtype or op.dtype, ro)

    fused = op.num_tables > 1
    if op.kind == "gather":
        memrefs = {
            "idxs": decl("idxs", 1, dtype="int32"),
            "table": decl("table", 2),
            "out": decl("out", 3, ro=False),
        }
        if fused:
            memrefs["roff"] = decl("roff", 1, dtype="int32")
        head = [Let("i0", Load("idxs", (VarRef("g"),))),
                Let("base", Load("roff", (VarRef("g"),))),
                Let("i", Bin("+", VarRef("i0"), VarRef("base")))] if fused \
            else [Let("i", Load("idxs", (VarRef("g"),)))]
        body = [
            For("g", Const(0), P("num_segments"), head + [
                For("r", Const(0), P("block_rows"), [
                    Let("row", Bin("+", Bin("*", VarRef("i"), P("block_rows")),
                                   VarRef("r"))),
                    For("e", Const(0), P("emb_len"), [
                        Store("out", (VarRef("g"), VarRef("r"), VarRef("e")),
                              Load("table", (VarRef("row"), VarRef("e")))),
                    ]),
                ]),
            ]),
        ]
        params = {"num_segments": op.num_segments, "block_rows": op.block_rows,
                  "emb_len": op.emb_len}
        return ScfFunc("gather", memrefs, params, body, op)

    if op.kind == "kg":
        memrefs = {
            "idxs": decl("idxs", 1, dtype="int32"),
            "vals": decl("vals", 1),
            "table": decl("table", 2),
            "out": decl("out", 2, ro=False),
        }
        body = [
            For("b", Const(0), P("num_segments"), [
                Let("i", Load("idxs", (VarRef("b"),))),
                Let("w", Load("vals", (VarRef("b"),))),
                For("e", Const(0), P("emb_len"), [
                    Store("out", (VarRef("b"), VarRef("e")),
                          Bin(_mul_binop(sr), VarRef("w"),
                              Load("table", (VarRef("i"), VarRef("e")))),
                          accumulate=sr.add),
                ]),
            ]),
        ]
        params = {"num_segments": op.num_segments, "emb_len": op.emb_len}
        return ScfFunc("kg", memrefs, params, body, op)

    if op.kind == "fusedmm":
        memrefs = {
            "ptrs": decl("ptrs", 1, dtype="int32"),
            "idxs": decl("idxs", 1, dtype="int32"),
            "x": decl("x", 2),
            "out": decl("out", 2, ro=False),
        }
        body = [
            For("i", Const(0), P("num_segments"), [
                Let("beg", Load("ptrs", (VarRef("i"),))),
                Let("end", Load("ptrs", (Bin("+", VarRef("i"), Const(1)),))),
                For("p", VarRef("beg"), VarRef("end"), [
                    Let("j", Load("idxs", (VarRef("p"),))),
                    Let("s", Const(0.0)),
                    # SDDMM loop: reads x[i,:] (fresh: j-indexed x rows) —
                    # offloadable; the accumulation into s is execute-side.
                    For("e", Const(0), P("emb_len"), [
                        SetVar("s", Bin("+", VarRef("s"),
                                        Bin("*",
                                            Load("x", (VarRef("i"), VarRef("e"))),
                                            Load("x", (VarRef("j"), VarRef("e")))))),
                    ]),
                    # workspace loop (paper §6.2): re-reads x[j,:] — already
                    # read by a sibling at the same level ⇒ NOT an offload
                    # candidate; it stays on the execute unit.
                    For("e2", Const(0), P("emb_len"), [
                        Store("out", (VarRef("i"), VarRef("e2")),
                              Bin("*", VarRef("s"),
                                  Load("x", (VarRef("j"), VarRef("e2")))),
                              accumulate="add"),
                    ]),
                ]),
            ]),
        ]
        params = {"num_segments": op.num_segments, "emb_len": op.emb_len}
        return ScfFunc("fusedmm", memrefs, params, body, op)

    # sls / spmm share one nest (paper §4: SLS ≡ SpMM(ikj, CSR))
    lengths = op.index_format == "lengths"
    assert not (fused and lengths), \
        "multi-table fusion requires the offsets index format"
    memrefs = {
        ("lens" if lengths else "ptrs"):
            decl("lens" if lengths else "ptrs", 1, dtype="int32"),
        "idxs": decl("idxs", 1, dtype="int32"),
        "table": decl("table", 2),
        "out": decl("out", 2, ro=False),
    }
    if fused:
        memrefs["roff"] = decl("roff", 1, dtype="int32")
    weighted = op.weighted or op.kind == "spmm"
    if weighted:
        memrefs["vals"] = decl("vals", 1)
    inner_val: Expr = Load("table", (VarRef("i"), VarRef("e")))
    if weighted:
        inner_val = Bin(_mul_binop(sr), VarRef("w"), inner_val)
    if fused:
        # the table-offset stream: idxs rebase onto the stacked table is
        # access-unit index arithmetic (MemStr roff[b] + AluStr add)
        seg_body = [Let("i0", Load("idxs", (VarRef("p"),))),
                    Let("i", Bin("+", VarRef("i0"), VarRef("base")))]
    else:
        seg_body = [Let("i", Load("idxs", (VarRef("p"),)))]
    if weighted:
        seg_body.append(Let("w", Load("vals", (VarRef("p"),))))
    seg_body.append(
        For("e", Const(0), Param("emb_len"), [
            Store("out", (VarRef("b"), VarRef("e")), inner_val,
                  accumulate=sr.add),
        ]))
    if lengths:
        # segment boundaries tracked by ACCUMULATING lengths (paper §7.4's
        # accumulation streams) instead of loading offsets
        body = [
            Let("acc", Const(0)),
            For("b", Const(0), Param("num_segments"), [
                Let("n", Load("lens", (VarRef("b"),))),
                Let("beg", VarRef("acc")),
                Let("end", Bin("+", VarRef("acc"), VarRef("n"))),
                For("p", VarRef("beg"), VarRef("end"), seg_body),
                SetVar("acc", VarRef("end")),
            ]),
        ]
    else:
        seg_head = [
            Let("beg", Load("ptrs", (VarRef("b"),))),
            Let("end", Load("ptrs", (Bin("+", VarRef("b"), Const(1)),))),
        ]
        if fused:
            seg_head.append(Let("base", Load("roff", (VarRef("b"),))))
        body = [
            For("b", Const(0), Param("num_segments"),
                seg_head + [For("p", VarRef("beg"), VarRef("end"), seg_body)]),
        ]
    params = {"num_segments": op.num_segments, "emb_len": op.emb_len}
    return ScfFunc(op.kind, memrefs, params, body, op)


def _mul_binop(sr: Semiring) -> str:
    return {"mul": "*", "add": "+"}[sr.mul]


# ----------------------------------------------------------------------------
# Interpreter
# ----------------------------------------------------------------------------

_BINOPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "min": min,
    "max": max,
}

_ACC = {
    "add": lambda a, b: a + b,
    "max": lambda a, b: max(a, b),
    "min": lambda a, b: min(a, b),
}

_FNS = {"identity": lambda x: x, "relu": lambda x: max(x, 0.0)}


def eval_expr(e: Expr, env: dict, mem: dict, params: dict):
    if isinstance(e, Const):
        return e.value
    if isinstance(e, Param):
        return params[e.name]
    if isinstance(e, VarRef):
        return env[e.name]
    if isinstance(e, Load):
        idx = tuple(int(eval_expr(i, env, mem, params)) for i in e.indices)
        return mem[e.memref][idx]
    if isinstance(e, Bin):
        return _BINOPS[e.op](eval_expr(e.a, env, mem, params),
                             eval_expr(e.b, env, mem, params))
    if isinstance(e, Apply):
        return _FNS[e.fn](eval_expr(e.a, env, mem, params))
    raise TypeError(e)


def _run_stmts(stmts: list, env: dict, mem: dict, params: dict):
    for s in stmts:
        if isinstance(s, Let) or isinstance(s, SetVar):
            env[s.var] = eval_expr(s.value, env, mem, params)
        elif isinstance(s, Store):
            idx = tuple(int(eval_expr(i, env, mem, params)) for i in s.indices)
            v = eval_expr(s.value, env, mem, params)
            if s.accumulate is None:
                mem[s.memref][idx] = v
            else:
                mem[s.memref][idx] = _ACC[s.accumulate](mem[s.memref][idx], v)
        elif isinstance(s, For):
            lb = int(eval_expr(s.lb, env, mem, params))
            ub = int(eval_expr(s.ub, env, mem, params))
            for i in range(lb, ub):
                env[s.var] = i
                _run_stmts(s.body, env, mem, params)
        else:
            raise TypeError(s)


def interp_scf(fn: ScfFunc, inputs: dict) -> np.ndarray:
    """Execute the SCF loop nest; returns ``out``."""
    from .ops import out_shape
    op = fn.op
    mem = dict(inputs)
    init = op.semiring.identity if op.has_compute else 0.0
    mem["out"] = np.full(out_shape(op), init, np.dtype(op.dtype))
    _run_stmts(fn.body, {}, mem, fn.params)
    out = mem["out"]
    if op.has_compute and op.semiring.add != "add" and op.uses_csr:
        lens = np.diff(inputs["ptrs"])
        out[lens == 0] = 0.0
    return out.astype(np.dtype(op.dtype))
