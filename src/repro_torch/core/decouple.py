"""SCF → SLC decoupling (paper §6.2).

Implements the paper's offloading legality rules verbatim:

An SCF loop is an *offloading candidate* iff

  (1) its iteration bounds are static (Const/Param) or computed by another
      offloading candidate (i.e. expressions over already-streamed values) —
      access units cannot read data back from the execute unit; and
  (2) it loads from at least one read-only memory location that has not
      already been read (by a parent loop or an earlier sibling subtree, at
      embedding-vector granularity).

Loops failing (2) are *workspace loops* (they only revisit partial results /
already-marshaled data) and stay on the execute unit, inside callbacks.
At most one offloading candidate is selected per nesting level (embedding
operations, being sparse-dense contractions, never need more — §6.2).

Offloaded read-only loads and index arithmetic become ``MemStr``/``AluStr``
streams hoisted before their callback; remaining compute is wrapped into
``Callback`` nodes whose expressions read streams through ``ToVal``.
"""
from __future__ import annotations

from . import scf
from .slc import (AccStr, AluStr, Callback, MemStr, SBin, SlcFor, SlcFunc,
                  StreamRef, ToVal, verify)


class _Ctx:
    def __init__(self, fn: scf.ScfFunc):
        self.fn = fn
        self.stream_of: dict = {}      # scf var -> stream name
        self.read_rows: set = set()    # (memref, row-key) freshness record
        self.used: set = set()
        self.pending_acc: dict = {}
        self.counter = 0

    def fresh(self, hint: str) -> str:
        name = f"s_{hint}"
        if name in self.used:
            self.counter += 1
            name = f"s_{hint}{self.counter}"
        self.used.add(name)
        return name


def _row_key(ctx: _Ctx, load: scf.Load):
    """Vector-granularity location key: drop the innermost index."""
    return (load.memref, tuple(_sym(ctx, i) for i in load.indices[:-1]))


def _sym(ctx: _Ctx, e) -> object:
    if isinstance(e, scf.Const):
        return ("c", e.value)
    if isinstance(e, scf.Param):
        return ("p", e.name)
    if isinstance(e, scf.VarRef):
        return ("v", ctx.stream_of.get(e.name, e.name))
    if isinstance(e, scf.Bin):
        return (e.op, _sym(ctx, e.a), _sym(ctx, e.b))
    if isinstance(e, scf.Load):
        return ("ld", e.memref, tuple(_sym(ctx, i) for i in e.indices))
    return ("?",)


def _streamable_idx(ctx: _Ctx, e) -> bool:
    """Can this index expression be evaluated on the access unit?"""
    if isinstance(e, (scf.Const, scf.Param)):
        return True
    if isinstance(e, scf.VarRef):
        return e.name in ctx.stream_of
    if isinstance(e, scf.Bin):
        return _streamable_idx(ctx, e.a) and _streamable_idx(ctx, e.b)
    return False


def _to_sidx(ctx: _Ctx, e):
    if isinstance(e, (scf.Const, scf.Param)):
        return e
    if isinstance(e, scf.VarRef):
        return StreamRef(ctx.stream_of[e.name])
    if isinstance(e, scf.Bin):
        return SBin(e.op, _to_sidx(ctx, e.a), _to_sidx(ctx, e.b))
    raise TypeError(e)


def _loads_in(stmt) -> list:
    out = []

    def expr(e):
        if isinstance(e, scf.Load):
            out.append(e)
            for i in e.indices:
                expr(i)
        elif isinstance(e, scf.Bin):
            expr(e.a)
            expr(e.b)
        elif isinstance(e, scf.Apply):
            expr(e.a)

    def rec(s):
        if isinstance(s, (scf.Let, scf.SetVar)):
            expr(s.value)
        elif isinstance(s, scf.Store):
            expr(s.value)
            for i in s.indices:
                expr(i)
        elif isinstance(s, scf.For):
            expr(s.lb)
            expr(s.ub)
            for b in s.body:
                rec(b)
    rec(stmt)
    return out


def _has_fresh_load(ctx: _Ctx, loop: scf.For) -> bool:
    ro = {n for n, d in ctx.fn.memrefs.items() if d.read_only}
    for ld in _loads_in(loop):
        if ld.memref in ro and _row_key(ctx, ld) not in ctx.read_rows:
            return True
    return False


def _bounds_ok(ctx: _Ctx, loop: scf.For) -> bool:
    return _streamable_idx(ctx, loop.lb) and _streamable_idx(ctx, loop.ub)


def _is_candidate(ctx: _Ctx, loop: scf.For) -> bool:
    return _bounds_ok(ctx, loop) and _has_fresh_load(ctx, loop)


def decouple(fn: scf.ScfFunc) -> SlcFunc:
    ctx = _Ctx(fn)
    body = _lower_level(ctx, fn.body, allow_candidate=True)
    out = SlcFunc(fn.name, fn.memrefs, dict(fn.params), body, fn.op)
    verify(out)
    return out


def _lower_level(ctx: _Ctx, stmts: list, allow_candidate: bool) -> list:
    """Lower one SCF nesting level to SLC nodes."""
    stmts = _recognize_accumulators(ctx, stmts)
    nodes: list = []
    pending: list = []   # callback stmts accumulated at this level
    picked_candidate = False

    def flush():
        if pending:
            nodes.append(Callback(list(pending)))
            pending.clear()

    for s in stmts:
        if isinstance(s, scf.Let) and _offloadable_let(ctx, s):
            flush()
            nodes.append(_stream_for_let(ctx, s))
        elif isinstance(s, scf.For):
            if allow_candidate and not picked_candidate and _is_candidate(ctx, s):
                picked_candidate = True
                flush()
                nodes.append(_lower_candidate_loop(ctx, s))
            else:
                # workspace loop: stays on the execute unit
                pending.append(_rewrite_stmt(ctx, s, extract=None))
        elif isinstance(s, (scf.Let, scf.SetVar, scf.Store)):
            extracted: list = []
            pending.append(_rewrite_stmt(ctx, s, extract=extracted))
            # hoist extracted streams *before* the callback
            if extracted:
                flush_at = len(nodes)
                flush()
                for m in extracted:
                    nodes.insert(flush_at, m)
                    flush_at += 1
        else:
            raise TypeError(s)
    flush()
    return nodes


def _offloadable_let(ctx: _Ctx, s: scf.Let) -> bool:
    v = s.value
    if isinstance(v, _AccRef):
        return True
    if isinstance(v, scf.Load):
        d = ctx.fn.memrefs.get(v.memref)
        return (d is not None and d.read_only and
                all(_streamable_idx(ctx, i) for i in v.indices))
    # pure index arithmetic over streams
    if isinstance(v, scf.Bin):
        return _streamable_idx(ctx, v)
    return False


def _stream_for_let(ctx: _Ctx, s: scf.Let):
    v = s.value
    name = ctx.fresh(s.var)
    if isinstance(v, _AccRef):
        # §7.4 accumulation stream: exclusive running sum of the length
        # stream (already decoupled — body order guarantees it exists)
        src = StreamRef(ctx.stream_of[v.src_var])
        node = AccStr(name, src, init=v.init)
        ctx.stream_of[s.var] = name
        return node
    if isinstance(v, scf.Load):
        node = MemStr(name, v.memref, tuple(_to_sidx(ctx, i) for i in v.indices))
        ctx.read_rows.add(_row_key(ctx, v))
    else:
        node = AluStr(name, v.op, _to_sidx(ctx, v.a), _to_sidx(ctx, v.b))
    ctx.stream_of[s.var] = name
    return node


def _lower_candidate_loop(ctx: _Ctx, loop: scf.For) -> SlcFor:
    sname = ctx.fresh(loop.var)
    ctx.stream_of[loop.var] = sname
    body = _lower_level(ctx, loop.body, allow_candidate=True)
    return SlcFor(sname, _to_sidx(ctx, loop.lb), _to_sidx(ctx, loop.ub), body)


def _rewrite_stmt(ctx: _Ctx, s, extract):
    """Rewrite an execute-side statement: VarRef→ToVal for streamed vars;
    when ``extract`` is a list, hoist offloadable Loads into MemStr streams
    (paper §6.2: loads moved before their corresponding callback)."""

    def expr(e):
        if isinstance(e, scf.VarRef):
            if e.name in ctx.stream_of:
                return ToVal(ctx.stream_of[e.name])
            return e
        if isinstance(e, scf.Load):
            d = ctx.fn.memrefs.get(e.memref)
            offl = (extract is not None and d is not None and d.read_only and
                    all(_streamable_idx(ctx, i) for i in e.indices))
            if offl:
                name = ctx.fresh(f"{e.memref}v")
                extract.append(
                    MemStr(name, e.memref,
                           tuple(_to_sidx(ctx, i) for i in e.indices)))
                ctx.read_rows.add(_row_key(ctx, e))
                return ToVal(name)
            return scf.Load(e.memref, tuple(expr(i) for i in e.indices))
        if isinstance(e, scf.Bin):
            return scf.Bin(e.op, expr(e.a), expr(e.b))
        if isinstance(e, scf.Apply):
            return scf.Apply(e.fn, expr(e.a))
        return e

    if isinstance(s, scf.Let):
        return scf.Let(s.var, expr(s.value))
    if isinstance(s, scf.SetVar):
        return scf.SetVar(s.var, expr(s.value))
    if isinstance(s, scf.Store):
        return scf.Store(s.memref, tuple(expr(i) for i in s.indices),
                         expr(s.value), s.accumulate)
    if isinstance(s, scf.For):
        # workspace loop body: locals keep their names; streams become ToVal
        return scf.For(s.var, expr(s.lb) if not isinstance(s.lb, (scf.Const, scf.Param)) else s.lb,
                       s.ub if isinstance(s.ub, (scf.Const, scf.Param)) else expr(s.ub),
                       [_rewrite_stmt(ctx, b, extract=None) for b in s.body])
    raise TypeError(s)


def _recognize_accumulators(ctx: _Ctx, stmts: list) -> list:
    """Paper §7.4 accumulation streams: the pattern

        acc = C;  for b { n = lens[b]; beg = acc; end = acc+n; ...;
                          acc = end }

    becomes an access-unit ``acc_str`` (exclusive running sum of the length
    stream), making the scalar accumulator offloadable — without this the
    inner-loop bounds depend on an execute-side variable and the loop could
    not be decoupled at all."""
    out = []
    i = 0
    while i < len(stmts):
        s0 = stmts[i]
        nxt = stmts[i + 1] if i + 1 < len(stmts) else None
        if (isinstance(s0, scf.Let) and isinstance(s0.value, scf.Const)
                and isinstance(nxt, scf.For)
                and _accumulates(nxt.body, s0.var)):
            ctx.pending_acc[s0.var] = int(s0.value.value)
            out.append(nxt)   # drop the init; the loop body is rewritten
            i += 2
            continue
        out.append(s0)
        i += 1
    # inside a loop whose parent registered an accumulator: rewrite
    return [_rewrite_acc_loop(ctx, s) if isinstance(s, scf.For) else s
            for s in out]


def _accumulates(body, var) -> bool:
    has_beg = any(isinstance(b, scf.Let) and isinstance(b.value, scf.VarRef)
                  and b.value.name == var for b in body)
    has_upd = any(isinstance(b, scf.SetVar) and b.var == var for b in body)
    return has_beg and has_upd


def _rewrite_acc_loop(ctx: _Ctx, loop: scf.For) -> scf.For:
    accs = {v for v in ctx.pending_acc
            if _accumulates(loop.body, v)}
    if not accs:
        return loop
    var = accs.pop()
    init = ctx.pending_acc.pop(var)
    # locate: end = acc + n; SetVar(acc, end)  →  the increment var is n
    end_var = None
    for b in loop.body:
        if (isinstance(b, scf.SetVar) and b.var == var
                and isinstance(b.value, scf.VarRef)):
            end_var = b.value.name
    src_var = None
    for b in loop.body:
        if (isinstance(b, scf.Let) and b.var == end_var
                and isinstance(b.value, scf.Bin) and b.value.op == "+"):
            for o in (b.value.a, b.value.b):
                if isinstance(o, scf.VarRef) and o.name != var:
                    src_var = o.name
    if src_var is None:
        return loop  # pattern mismatch: leave untouched (execute-side)
    beg_var = next(b.var for b in loop.body
                   if isinstance(b, scf.Let)
                   and isinstance(b.value, scf.VarRef)
                   and b.value.name == var)
    new_body = []
    for b in loop.body:
        if (isinstance(b, scf.Let) and isinstance(b.value, scf.VarRef)
                and b.value.name == var):
            # beg = acc  →  synthetic node resolved into an AccStr
            new_body.append(scf.Let(b.var, _AccRef(var, init, src_var)))
        elif isinstance(b, scf.Let) and b.var == end_var:
            # end = acc + n  →  end = beg + n (beg is now a stream)
            new_body.append(scf.Let(b.var, scf.Bin(
                "+", scf.VarRef(beg_var), scf.VarRef(src_var))))
        elif isinstance(b, scf.SetVar) and b.var == var:
            continue  # the accumulation lives in the stream now
        else:
            new_body.append(b)
    return scf.For(loop.var, loop.lb, loop.ub, new_body)


@__import__("dataclasses").dataclass(frozen=True)
class _AccRef:
    var: str
    init: int
    src_var: str
