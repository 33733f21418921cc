"""Executable semantics for the SLC and DLC IRs.

These interpreters are the semantic oracles of the compiler: every pass and
lowering is property-tested by checking

    interp_scf(scf) == interp_slc(decouple(scf))
                    == interp_slc(optimized)
                    == interp_dlc(lower_to_dlc(optimized))
                    == backend outputs

The DLC interpreter is *queue-faithful*: it first runs the access-unit
(lookup) program to completion, materializing the control/data queues as the
TMU would (paper Fig 10d), and only then runs the execute-unit program,
which may touch memory solely through pops, workspace reads, and stores.
The queues returned alongside the result feed the cost model and the queue
conservation property tests.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from . import scf
from .ops import out_shape
from .slc import (AccStr, AluStr, BufStr, Callback, DotBuf, MemStr, PushBuf,
                  SBin, SlcFor, SlcFunc, StoreBuf, StreamRef, ToVal)

_BINOPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "min": np.minimum,
    "max": np.maximum,
}

_ACC = {
    "add": lambda a, b: a + b,
    "max": np.maximum,
    "min": np.minimum,
}

_FNS = {"identity": lambda x: x, "relu": lambda x: np.maximum(x, 0.0),
        "hsum": np.sum}


# ---------------------------------------------------------------------------
# SLC interpreter
# ---------------------------------------------------------------------------

class _SlcState:
    def __init__(self, fn: SlcFunc, inputs: dict):
        self.fn = fn
        self.acc: dict = {}     # AccStr running sums (per program run)
        self.mem = dict(inputs)
        op = fn.op
        init = op.semiring.identity if op.has_compute else 0.0
        self.mem["out"] = np.full(out_shape(op), init, np.dtype(op.dtype))
        self.streams: dict = {}
        self.vars: dict = {}     # execute-unit locals + carries

    def sidx(self, e):
        if isinstance(e, scf.Const):
            return e.value
        if isinstance(e, scf.Param):
            return self.fn.params[e.name]
        if isinstance(e, StreamRef):
            return self.streams[e.name]
        if isinstance(e, SBin):
            return _BINOPS[e.op](self.sidx(e.a), self.sidx(e.b))
        raise TypeError(e)

    def expr(self, e):
        if isinstance(e, ToVal):
            return self.streams[e.stream]
        if isinstance(e, DotBuf):
            a = np.concatenate([np.atleast_1d(x) for x in self.streams[e.buf_a]])
            b = np.concatenate([np.atleast_1d(x) for x in self.streams[e.buf_b]])
            return _FNS[e.fn](np.dot(a, b))
        if isinstance(e, scf.Const):
            return e.value
        if isinstance(e, scf.Param):
            return self.fn.params[e.name]
        if isinstance(e, scf.VarRef):
            return self.vars[e.name]
        if isinstance(e, scf.Load):
            idx = tuple(np.asarray(self.expr(i)).astype(np.int64)
                        if not np.isscalar(self.expr(i)) else int(self.expr(i))
                        for i in e.indices)
            return self.mem[e.memref][idx]
        if isinstance(e, scf.Bin):
            return _BINOPS[e.op](self.expr(e.a), self.expr(e.b))
        if isinstance(e, scf.Apply):
            return _FNS[e.fn](self.expr(e.a))
        raise TypeError(e)

    def run_callback_stmts(self, body):
        for s in body:
            if isinstance(s, (scf.Let, scf.SetVar)):
                self.vars[s.var] = self.expr(s.value)
            elif isinstance(s, scf.Store):
                idx = tuple(_as_index(self.expr(i)) for i in s.indices)
                v = self.expr(s.value)
                if s.accumulate is None:
                    self.mem[s.memref][idx] = v
                else:
                    self.mem[s.memref][idx] = _ACC[s.accumulate](
                        self.mem[s.memref][idx], v)
            elif isinstance(s, scf.For):
                lb = int(self.expr(s.lb))
                ub = int(self.expr(s.ub))
                for i in range(lb, ub):
                    self.vars[s.var] = i
                    self.run_callback_stmts(s.body)
            else:
                raise TypeError(s)


def _as_index(v):
    if np.isscalar(v) or getattr(v, "ndim", 1) == 0:
        return int(v)
    return np.asarray(v).astype(np.int64)


def interp_slc(fn: SlcFunc, inputs: dict) -> np.ndarray:
    st = _SlcState(fn, inputs)
    _run_slc_body(st, fn.body)
    out = st.mem["out"]
    op = fn.op
    if op.has_compute and op.semiring.add != "add" and op.uses_csr:
        lens = np.diff(inputs["ptrs"])
        out[lens == 0] = 0.0
    return out.astype(np.dtype(op.dtype))


def _run_slc_body(st: _SlcState, body):
    for node in body:
        if isinstance(node, SlcFor):
            for var, init in node.carry.items():
                st.vars.setdefault(var, init)
            lb = int(st.sidx(node.lb))
            ub = int(st.sidx(node.ub))
            if node.vlen is None:
                for i in range(lb, ub):
                    st.streams[node.stream] = i
                    _run_slc_body(st, node.body)
            else:
                for base in range(lb, ub, node.vlen):
                    # the mask stream of slcv.for (§7.1) ≙ the clipped range
                    st.streams[node.stream] = np.arange(
                        base, min(ub, base + node.vlen))
                    _run_slc_body(st, node.body)
        elif isinstance(node, MemStr):
            idx = tuple(_as_index(st.sidx(i)) for i in node.indices)
            st.streams[node.stream] = st.mem[node.memref][idx]
        elif isinstance(node, AluStr):
            st.streams[node.stream] = _BINOPS[node.op](
                st.sidx(node.a), st.sidx(node.b))
        elif isinstance(node, AccStr):
            cur = st.acc.get(node.stream, node.init)
            st.streams[node.stream] = cur            # exclusive prefix
            st.acc[node.stream] = cur + int(st.sidx(node.src))
        elif isinstance(node, BufStr):
            st.streams[node.stream] = []
        elif isinstance(node, PushBuf):
            st.streams[node.buf].append(np.atleast_1d(st.streams[node.src]))
        elif isinstance(node, Callback):
            st.run_callback_stmts(node.body)
        elif isinstance(node, StoreBuf):
            _store_buf(st, node)
        else:
            raise TypeError(node)


def _store_buf(st: _SlcState, node: StoreBuf):
    vec = np.concatenate(st.streams[node.buf]) if st.streams[node.buf] \
        else np.zeros((0,), np.dtype(st.fn.op.dtype))
    if node.scale is not None:
        vec = _BINOPS["*" if st.fn.op.semiring.mul == "mul" else "+"](
            st.expr(node.scale), vec)
    row = tuple(_as_index(st.expr(i)) for i in node.row_indices)
    tgt = st.mem[node.memref][row]
    if node.accumulate is None:
        st.mem[node.memref][row] = vec[: tgt.shape[-1]]
    else:
        st.mem[node.memref][row] = _ACC[node.accumulate](tgt, vec[: tgt.shape[-1]])


# ---------------------------------------------------------------------------
# DLC interpreter (queue-faithful)
# ---------------------------------------------------------------------------

def interp_dlc(prog, inputs: dict, return_queues: bool = False):
    """Run a :class:`repro.core.dlc.DlcProgram`.

    Phase 1 executes the lookup (access-unit) program, producing ctrlQ/dataQ.
    Phase 2 executes the compute (execute-unit) program by draining them.
    """
    from . import dlc as D

    op = prog.op
    mem = dict(inputs)
    init = op.semiring.identity if op.has_compute else 0.0
    mem["out"] = np.full(out_shape(op), init, np.dtype(op.dtype))

    ctrlq: deque = deque()
    dataq: deque = deque()
    streams: dict = {}
    acc_state: dict = {}

    def src_val(s):
        kind, v = s
        if kind == "const":
            return v
        if kind == "param":
            return prog.params[v]
        return streams[v]

    # ---- phase 1: access unit ----
    def run_access(body):
        for node in body:
            if isinstance(node, D.DLoop):
                lb = int(src_val(node.lb))
                ub = int(src_val(node.ub))
                if node.vlen is None:
                    for i in range(lb, ub):
                        streams[node.tu] = i
                        run_access(node.body)
                else:
                    for base in range(lb, ub, node.vlen):
                        streams[node.tu] = np.arange(base, min(ub, base + node.vlen))
                        run_access(node.body)
            elif isinstance(node, D.DMem):
                idx = tuple(_as_index(src_val(i)) for i in node.indices)
                streams[node.sid] = mem[node.memref][idx]
            elif isinstance(node, D.DAlu):
                streams[node.sid] = _BINOPS[node.op](src_val(node.a),
                                                     src_val(node.b))
            elif isinstance(node, D.DAcc):
                cur = acc_state.get(node.sid, node.init)
                streams[node.sid] = cur
                acc_state[node.sid] = cur + int(src_val(node.src))
            elif isinstance(node, D.DPushData):
                dataq.append(np.copy(src_val(node.src)))
            elif isinstance(node, D.DPushTok):
                ctrlq.append(node.token)
            elif isinstance(node, D.DStore):
                row = tuple(_as_index(src_val(i)) for i in node.row)
                val = src_val(node.src)
                tgt = mem[node.memref][row]
                if np.ndim(val) and tgt.ndim and val.shape != tgt.shape:
                    # masked tail of a vectorized store stream
                    mem[node.memref][row][: len(val)] = val
                else:
                    mem[node.memref][row] = val
            else:
                raise TypeError(node)

    run_access(prog.lookup)
    ctrlq.append(D.DONE)
    n_data = len(dataq)
    n_tok = len(ctrlq)

    # ---- phase 2: execute unit ----
    local = dict(prog.locals_init)

    def cexpr(e):
        if isinstance(e, scf.Const):
            return e.value
        if isinstance(e, scf.Param):
            return prog.params[e.name]
        if isinstance(e, scf.VarRef):
            return local[e.name]
        if isinstance(e, scf.Load):
            idx = tuple(_as_index(cexpr(i)) for i in e.indices)
            return mem[e.memref][idx]
        if isinstance(e, scf.Bin):
            return _BINOPS[e.op](cexpr(e.a), cexpr(e.b))
        if isinstance(e, scf.Apply):
            return _FNS[e.fn](cexpr(e.a))
        raise TypeError(e)

    def run_cstmts(body):
        for s in body:
            if isinstance(s, D.CPop):
                n = s.count if isinstance(s.count, int) else int(cexpr(s.count))
                if s.also is not None:
                    a_chunks, b_chunks = [], []
                    for _ in range(n):
                        a_chunks.append(np.atleast_1d(dataq.popleft()))
                        b_chunks.append(np.atleast_1d(dataq.popleft()))
                    local[s.var] = np.concatenate(a_chunks)
                    local[s.also] = np.concatenate(b_chunks)
                elif n == 1:
                    local[s.var] = dataq.popleft()
                else:
                    local[s.var] = np.concatenate(
                        [np.atleast_1d(dataq.popleft()) for _ in range(n)])
            elif isinstance(s, D.CDot):
                local[s.var] = _FNS[s.fn](
                    np.dot(local[s.a], local[s.b]))
            elif isinstance(s, D.CStoreRow):
                row = tuple(_as_index(cexpr(r)) for r in s.row)
                vec = np.atleast_1d(local[s.var])
                if s.scale is not None:
                    vec = _BINOPS["*" if op.semiring.mul == "mul" else "+"](
                        vec, cexpr(s.scale))
                tgt = mem[s.memref][row]
                vec = vec[: tgt.shape[-1]] if tgt.ndim else vec
                if s.accumulate is None:
                    if np.ndim(vec) and tgt.ndim and vec.shape != tgt.shape:
                        mem[s.memref][row][: len(vec)] = vec
                    else:
                        mem[s.memref][row] = vec
                else:
                    if np.ndim(vec) and tgt.ndim and vec.shape != tgt.shape:
                        sub = mem[s.memref][row][: len(vec)]
                        mem[s.memref][row][: len(vec)] = _ACC[s.accumulate](sub, vec)
                    else:
                        mem[s.memref][row] = _ACC[s.accumulate](tgt, vec)
            elif isinstance(s, (scf.Let, scf.SetVar)):
                local[s.var] = cexpr(s.value)
            elif isinstance(s, scf.Store):
                idx = tuple(_as_index(cexpr(i)) for i in s.indices)
                v = cexpr(s.value)
                if s.accumulate is None:
                    mem[s.memref][idx] = v
                else:
                    mem[s.memref][idx] = _ACC[s.accumulate](mem[s.memref][idx], v)
            elif isinstance(s, scf.For):
                for i in range(int(cexpr(s.lb)), int(cexpr(s.ub))):
                    local[s.var] = i
                    run_cstmts(s.body)
            else:
                raise TypeError(s)

    cases = {c.token: c for c in prog.cases}
    while True:
        tok = ctrlq.popleft()
        if tok == D.DONE:
            break
        run_cstmts(cases[tok].body)

    out = mem["out"]
    if op.has_compute and op.semiring.add != "add" and op.uses_csr:
        lens = np.diff(inputs["ptrs"])
        out[lens == 0] = 0.0
    out = out.astype(np.dtype(op.dtype))
    if return_queues:
        stats = {"data_pushed": n_data, "tokens": n_tok - 1,
                 "data_left": len(dataq), "ctrl_left": len(ctrlq)}
        return out, stats
    return out
