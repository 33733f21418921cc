"""Decoupled Lookup-Compute (DLC) IR — the paper's contribution #3 (§4).

The DLC IR is the low-level DAE abstraction: a *lookup program* (streaming
dataflow code for the access unit: traversal operators, memory streams, ALU
streams, queue pushes) and a *compute program* (imperative code for the
execute unit: a while-loop popping control tokens and dispatching to
per-token cases).  Data and control flow between the two **only** through
the queues — which is exactly what makes post-decoupling global optimization
hard, and why the optimizing passes run on SLC before lowering here.

Positional semantics stand in for the paper's ``(tu_id, event)`` pairs: a
node placed before a child loop fires on the parent's iteration event
(``ite``); a node placed after a child loop fires on that child's ``end``
event.  The queue-faithful interpreter lives in :mod:`repro.core.interp`;
the Pallas backend erases the queues into a DMA schedule
(:mod:`repro.core.backend_pallas`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from . import scf
from .ops import EmbeddingOp
from .slc import (AccStr, AluStr, BufStr, Callback, DotBuf, MemStr, PushBuf,
                  SBin, SlcFor, SlcFunc, StoreBuf, StreamRef, ToVal,
                  callback_streams)

DONE = "done"

Src = tuple  # ('const', v) | ('param', name) | ('stream', sid)


# ---- lookup (access-unit) program ----------------------------------------

@dataclasses.dataclass
class DLoop:
    tu: str
    lb: Src
    ub: Src
    body: list
    vlen: Optional[int] = None


@dataclasses.dataclass
class DMem:
    sid: str
    memref: str
    indices: tuple  # of Src


@dataclasses.dataclass
class DAlu:
    sid: str
    op: str
    a: Src
    b: Src


@dataclasses.dataclass
class DAcc:
    """Accumulation stream (§7.4): exclusive running sum on the access unit."""
    sid: str
    src: Src
    init: int = 0


@dataclasses.dataclass
class DPushData:
    src: Src


@dataclasses.dataclass
class DPushTok:
    token: str


@dataclasses.dataclass
class DStore:
    """Store stream (§7.4): access unit writes a row directly to memory."""
    memref: str
    row: tuple  # of Src
    src: Src


# ---- compute (execute-unit) program ---------------------------------------

@dataclasses.dataclass
class CPop:
    """Pop `count` chunks into `var` (count>1 → concatenated vector).
    When `also` is set, chunks for the two vars are interleaved in dataQ."""
    var: str
    count: Union[int, object] = 1
    also: Optional[str] = None


@dataclasses.dataclass
class CDot:
    var: str
    a: str
    b: str
    fn: str = "identity"


@dataclasses.dataclass
class CStoreRow:
    memref: str
    row: tuple  # of scf exprs over compute locals
    var: str
    accumulate: Optional[str]
    scale: Optional[object] = None


@dataclasses.dataclass
class DCase:
    token: str
    body: list  # CPop/CDot/CStoreRow/scf stmts


@dataclasses.dataclass
class DlcProgram:
    name: str
    op: EmbeddingOp
    params: dict
    lookup: list            # access-unit dataflow tree
    cases: list             # compute-unit token cases
    locals_init: dict       # execute-side persistent locals (counters, …)
    opt: dict


# ---------------------------------------------------------------------------
# SLC → DLC lowering (paper §6.3)
# ---------------------------------------------------------------------------

class _Lower:
    def __init__(self, fn: SlcFunc):
        self.fn = fn
        self.cases: list = []
        self.locals_init: dict = {}
        self.ntok = 0
        self.alu_n = 0
        self.bufs: set = set()
        self.buf_chunks: dict = {}   # buf -> chunk count (int)
        self.extra_access: list = []

    def tok(self, hint) -> str:
        self.ntok += 1
        return f"t{self.ntok}_{hint}"

    def sidx_to_src(self, e, access_nodes) -> Src:
        if isinstance(e, scf.Const):
            return ("const", e.value)
        if isinstance(e, scf.Param):
            return ("param", e.name)
        if isinstance(e, StreamRef):
            return ("stream", e.name)
        if isinstance(e, SBin):
            # materialize compound index arithmetic as an ALU stream
            a = self.sidx_to_src(e.a, access_nodes)
            b = self.sidx_to_src(e.b, access_nodes)
            self.alu_n += 1
            sid = f"alu{self.alu_n}"
            access_nodes.append(DAlu(sid, e.op, a, b))
            return ("stream", sid)
        raise TypeError(e)

    # -- compute-side expression rewrite: ToVal(s) -> VarRef(q_s) ----------
    def rewrite_cb_expr(self, e):
        if isinstance(e, ToVal):
            return scf.VarRef(f"q_{e.stream}")
        if isinstance(e, scf.Bin):
            return scf.Bin(e.op, self.rewrite_cb_expr(e.a),
                           self.rewrite_cb_expr(e.b))
        if isinstance(e, scf.Apply):
            return scf.Apply(e.fn, self.rewrite_cb_expr(e.a))
        if isinstance(e, scf.Load):
            return scf.Load(e.memref,
                            tuple(self.rewrite_cb_expr(i) for i in e.indices))
        return e

    def rewrite_cb_stmt(self, s):
        if isinstance(s, scf.Let):
            return scf.Let(s.var, self.rewrite_cb_expr(s.value))
        if isinstance(s, scf.SetVar):
            return scf.SetVar(s.var, self.rewrite_cb_expr(s.value))
        if isinstance(s, scf.Store):
            return scf.Store(s.memref,
                             tuple(self.rewrite_cb_expr(i) for i in s.indices),
                             self.rewrite_cb_expr(s.value), s.accumulate)
        if isinstance(s, scf.For):
            return scf.For(s.var, self.rewrite_cb_expr(s.lb),
                           self.rewrite_cb_expr(s.ub),
                           [self.rewrite_cb_stmt(b) for b in s.body])
        raise TypeError(s)

    def lower_body(self, body) -> list:
        nodes: list = []
        for node in body:
            if isinstance(node, SlcFor):
                for var, init in node.carry.items():
                    self.locals_init[var] = init
                lb = self.sidx_to_src(node.lb, nodes)
                ub = self.sidx_to_src(node.ub, nodes)
                nodes.append(DLoop(node.tu if hasattr(node, "tu") else node.stream,
                                   lb, ub, self.lower_body(node.body),
                                   vlen=node.vlen))
            elif isinstance(node, MemStr):
                idx = tuple(self.sidx_to_src(i, nodes) for i in node.indices)
                nodes.append(DMem(node.stream, node.memref, idx))
            elif isinstance(node, AluStr):
                nodes.append(DAlu(node.stream, node.op,
                                  self.sidx_to_src(node.a, nodes),
                                  self.sidx_to_src(node.b, nodes)))
            elif isinstance(node, AccStr):
                nodes.append(DAcc(node.stream,
                                  self.sidx_to_src(node.src, nodes),
                                  node.init))
            elif isinstance(node, BufStr):
                self.bufs.add(node.stream)
                self.buf_chunks[node.stream] = 0
            elif isinstance(node, PushBuf):
                # buffered data: pushed chunk-wise with NO per-chunk token
                nodes.append(DPushData(("stream", node.src)))
                self.buf_chunks[node.buf] += 1  # chunks per inner iteration
            elif isinstance(node, Callback):
                nodes.extend(self.lower_callback(node))
            elif isinstance(node, StoreBuf):
                nodes.extend(self.lower_storebuf(node))
            else:
                raise TypeError(node)
        return nodes

    def lower_callback(self, cb: Callback) -> list:
        streams = sorted(callback_streams(cb))
        token = self.tok("cb")
        access = [DPushData(("stream", s)) for s in streams]
        access.append(DPushTok(token))
        body = [CPop(f"q_{s}") for s in streams]
        body += [self.rewrite_cb_stmt(s) for s in cb.body]
        self.cases.append(DCase(token, body))
        return access

    def lower_storebuf(self, sb: StoreBuf) -> list:
        emb_len = self.fn.params["emb_len"]
        vlen = self.fn.opt.get("vlen") or 1
        n_chunks = -(-emb_len // vlen)

        if sb.as_store_stream:
            # §7.4: no queue traffic at all — access unit stores directly.
            # NOTE: the buffer's PushBuf ops were already emitted as
            # DPushData; the caller strips them (see lower_to_dlc) since the
            # buffered value goes straight to memory here.
            row = tuple(self.sidx_to_src(_cb_expr_to_sidx(i), self.extra_access)
                        for i in sb.row_indices)
            return [DStore(sb.memref, row, ("buf", sb.buf))]

        access: list = []
        body: list = []
        # Queue discipline: the buffer chunks were pushed by the inner loop
        # (they sit in dataQ *first*); scalar operands (row ids, scales) are
        # marshaled after the inner traversal, at this StoreBuf's position.
        # Pops must mirror that order exactly.
        if isinstance(sb.scale, DotBuf):
            body.append(CPop(f"q_{sb.scale.buf_a}", count=n_chunks,
                             also=f"q_{sb.scale.buf_b}"))
            buf_var = f"q_{sb.scale.buf_b}" if sb.buf == sb.scale.buf_b \
                else f"q_{sb.buf}"
        else:
            body.append(CPop(f"q_{sb.buf}", count=n_chunks))
            buf_var = f"q_{sb.buf}"

        # scalar row operands (those still marshaled through the queue)
        row_exprs = []
        for i in sb.row_indices:
            if isinstance(i, ToVal):
                access.append(DPushData(("stream", i.stream)))
                body.append(CPop(f"q_{i.stream}"))
                row_exprs.append(scf.VarRef(f"q_{i.stream}"))
            else:
                row_exprs.append(self.rewrite_cb_expr(i))

        scale_expr = None
        if isinstance(sb.scale, DotBuf):
            body.append(CDot("q_dot", f"q_{sb.scale.buf_a}",
                             f"q_{sb.scale.buf_b}", sb.scale.fn))
            scale_expr = scf.VarRef("q_dot")
        elif sb.scale is not None:
            if isinstance(sb.scale, ToVal):
                access.append(DPushData(("stream", sb.scale.stream)))
                body.append(CPop(f"q_{sb.scale.stream}"))
                scale_expr = scf.VarRef(f"q_{sb.scale.stream}")
            else:
                scale_expr = self.rewrite_cb_expr(sb.scale)

        body.append(CStoreRow(sb.memref, tuple(row_exprs), buf_var,
                              sb.accumulate, scale=scale_expr))
        token = self.tok("row")
        access.append(DPushTok(token))
        self.cases.append(DCase(token, body))
        return access


def _cb_expr_to_sidx(e):
    if isinstance(e, ToVal):
        return StreamRef(e.stream)
    if isinstance(e, scf.Const) or isinstance(e, scf.Param):
        return e
    if isinstance(e, scf.Bin):
        return SBin(e.op, _cb_expr_to_sidx(e.a), _cb_expr_to_sidx(e.b))
    raise TypeError(f"store-stream row must be access-side computable: {e}")


def lower_to_dlc(fn: SlcFunc) -> DlcProgram:
    lo = _Lower(fn)
    lookup = lo.lower_body(fn.body)
    if fn.opt.get("store_streams"):
        lookup = _fuse_store_streams(lookup, lo)
    return DlcProgram(fn.name, fn.op, dict(fn.params), lookup,
                      lo.cases, lo.locals_init, dict(fn.opt))


def _fuse_store_streams(lookup: list, lo: _Lower) -> list:
    """For store-stream outputs the buffered PushBuf chunks must not hit the
    queue: rewrite  [loop{..., push v}, store(buf)]  into a direct store of
    the value stream inside the loop, addressed by loop position."""
    def rec(body):
        out = []
        i = 0
        while i < len(body):
            node = body[i]
            if isinstance(node, DLoop):
                node = DLoop(node.tu, node.lb, node.ub, rec(node.body),
                             node.vlen)
                # pattern: DLoop whose body pushes data, followed by DStore
                if (i + 1 < len(body) and isinstance(body[i + 1], DStore)
                        and body[i + 1].src[0] == "buf"):
                    st: DStore = body[i + 1]
                    inner = []
                    for n in node.body:
                        if isinstance(n, DPushData):
                            # the pushed chunk becomes a direct store,
                            # column-addressed by the inner traversal
                            inner.append(DStore(st.memref,
                                                st.row + (("stream", node.tu),),
                                                n.src))
                        else:
                            inner.append(n)
                    out.append(DLoop(node.tu, node.lb, node.ub, inner,
                                     node.vlen))
                    i += 2
                    continue
                out.append(node)
            else:
                out.append(node)
            i += 1
        return out
    return rec(lookup)


# ---------------------------------------------------------------------------
# Pretty printer (paper Fig 10c/10e surface syntax)
# ---------------------------------------------------------------------------

def pretty(prog: DlcProgram) -> str:
    lines = [f"// DLC lookup program (access unit) — {prog.name}"]

    def src(s):
        k, v = s
        return {"const": str(v), "param": v,
                "stream": v, "buf": f"buf({v})"}[k]

    def rec(body, ind):
        pad = "  " * ind
        for n in body:
            if isinstance(n, DLoop):
                v = f"<{n.vlen}>" if n.vlen else ""
                lines.append(f"{pad}{n.tu} = loop_tr{v}({src(n.lb)}, {src(n.ub)}) {{")
                rec(n.body, ind + 1)
                lines.append(f"{pad}}}")
            elif isinstance(n, DMem):
                lines.append(f"{pad}{n.sid} = mem_str({n.memref}"
                             f"[{','.join(src(i) for i in n.indices)}])")
            elif isinstance(n, DAlu):
                lines.append(f"{pad}{n.sid} = alu_str({src(n.a)} {n.op} {src(n.b)})")
            elif isinstance(n, DAcc):
                lines.append(f"{pad}{n.sid} = acc_str(+= {src(n.src)}, init={n.init})")
            elif isinstance(n, DPushData):
                lines.append(f"{pad}push_op(dataQ, {src(n.src)})")
            elif isinstance(n, DPushTok):
                lines.append(f"{pad}callback(ctrlQ, {n.token})")
            elif isinstance(n, DStore):
                lines.append(f"{pad}store_str({n.memref}"
                             f"[{','.join(src(i) for i in n.row)}] <- {src(n.src)})")
    rec(prog.lookup, 0)

    lines.append("")
    lines.append("// DLC compute program (execute unit)")
    lines.append("while((tkn = ctrlQ.pop()) != done) {")
    for case in prog.cases:
        lines.append(f"  if (tkn == {case.token}) {{")
        for s in case.body:
            if isinstance(s, CPop):
                extra = f" interleaved_with {s.also}" if s.also else ""
                lines.append(f"    {s.var} = dataQ.pop<{s.count} chunks>(){extra}")
            elif isinstance(s, CDot):
                lines.append(f"    {s.var} = {s.fn}(dot({s.a}, {s.b}))")
            elif isinstance(s, CStoreRow):
                sc = f"{_pp_expr(s.scale)} * " if s.scale is not None else ""
                op = {"add": "+=", None: "="}.get(s.accumulate, f"{s.accumulate}=")
                row = ",".join(_pp_expr(r) for r in s.row)
                lines.append(f"    {s.memref}[{row},:] {op} {sc}{s.var}")
            else:
                lines.append(f"    {_pp_stmt(s)}")
        lines.append("  }")
    lines.append("}")
    if prog.locals_init:
        lines.insert(len(lines) - len(prog.cases) * 3 - 2,
                     f"// execute-unit locals: {prog.locals_init}")
    return "\n".join(lines)


def _pp_expr(e):
    if isinstance(e, scf.Const):
        return str(e.value)
    if isinstance(e, scf.Param):
        return e.name
    if isinstance(e, scf.VarRef):
        return e.name
    if isinstance(e, scf.Load):
        return f"{e.memref}[{','.join(_pp_expr(i) for i in e.indices)}]"
    if isinstance(e, scf.Bin):
        return f"({_pp_expr(e.a)}{e.op}{_pp_expr(e.b)})"
    if isinstance(e, scf.Apply):
        return f"{e.fn}({_pp_expr(e.a)})"
    return repr(e)


def _pp_stmt(s):
    if isinstance(s, (scf.Let, scf.SetVar)):
        return f"{s.var} = {_pp_expr(s.value)}"
    if isinstance(s, scf.Store):
        op = {"add": "+=", None: "="}.get(s.accumulate, f"{s.accumulate}=")
        return f"{s.memref}[{','.join(_pp_expr(i) for i in s.indices)}] {op} {_pp_expr(s.value)}"
    if isinstance(s, scf.For):
        inner = "; ".join(_pp_stmt(b) for b in s.body)
        return f"for({s.var} in {_pp_expr(s.lb)}..{_pp_expr(s.ub)}) {{ {inner} }}"
    return repr(s)


# ---------------------------------------------------------------------------
# Queue traffic accounting (feeds the cost model / Fig 14 demonstrations)
# ---------------------------------------------------------------------------

def queue_profile(prog: DlcProgram) -> dict:
    """Static per-inner-element queue traffic of the program (Fig 14):
    how many data items and tokens are marshaled per looked-up element."""
    # count pushes at each loop depth; normalize to the innermost trip
    depth_items = {}

    def rec(body, depth):
        for n in body:
            if isinstance(n, DLoop):
                rec(n.body, depth + 1)
            elif isinstance(n, (DPushData, DPushTok)):
                key = (depth, isinstance(n, DPushTok))
                depth_items[key] = depth_items.get(key, 0) + 1
    rec(prog.lookup, 0)
    max_d = max((d for d, _ in depth_items), default=0)
    data_inner = sum(v for (d, tok), v in depth_items.items()
                     if d == max_d and not tok)
    tok_inner = sum(v for (d, tok), v in depth_items.items()
                    if d == max_d and tok)
    return {"inner_depth": max_d,
            "data_pushes_at_inner": data_inner,
            "token_pushes_at_inner": tok_inner,
            "by_depth": depth_items}
