"""Vectorization pass (paper §7.1).

The paper vectorizes the *inner* loop only — prior work showed inner-loop
vectorization is the efficient scheme for sparse-dense contractions when the
dense operand is row-major with rows ≥ vlen, which embedding operations
satisfy.  A loop may be vectorized iff all of its callbacks can be; the one
non-trivially-vectorizable pattern in embedding ops is the scalar reduction
accumulator (fusedmm's SDDMM dot product), which we vectorize as
vector-FMA + horizontal sum (``Apply('hsum', ·)``), exactly how SVE/TPU-VPU
reductions lower.

On the TPU target ``vlen`` is a multiple of the 128-wide lane dimension.
"""
from __future__ import annotations

import copy

from .. import scf
from ..slc import Callback, SlcFor, SlcFunc, ToVal, verify


class VectorizeError(Exception):
    pass


def _vectorizable_stmt(s) -> bool:
    if isinstance(s, (scf.Let, scf.SetVar, scf.Store)):
        return True
    if isinstance(s, scf.For):
        return all(_vectorizable_stmt(b) for b in s.body)
    return False


def _innermost(body):
    loop = None
    for node in body:
        if isinstance(node, SlcFor):
            loop = node
    if loop is None:
        return None
    inner = _innermost(loop.body)
    return inner if inner is not None else loop


def vectorize(fn: SlcFunc, vlen: int = 128) -> SlcFunc:
    """Return a new SlcFunc with the innermost loop vectorized (slcv dual)."""
    fn = copy.deepcopy(fn)
    inner = _innermost(fn.body)
    if inner is None:
        raise VectorizeError("no loop to vectorize")
    # legality: every callback of the loop must vectorize
    for node in inner.body:
        if isinstance(node, Callback):
            if not all(_vectorizable_stmt(s) for s in node.body):
                raise VectorizeError(f"callback not vectorizable: {node}")
    inner.vlen = vlen
    # rewrite scalar reduction accumulators: s = s + <vec>  →
    # s = s + hsum(<vec>)   (vector FMA + horizontal reduction)
    inner_streams = {inner.stream}
    for node in inner.body:
        if isinstance(node, Callback):
            node.body = [_rewrite_reduction(s, inner_streams, fn)
                         for s in node.body]
    fn.opt["vectorized"] = True
    fn.opt["vlen"] = vlen
    verify(fn)
    return fn


def _uses_vector(e, fn: SlcFunc) -> bool:
    """Does this expression reference any stream (vector-valued post-pass)?"""
    if isinstance(e, ToVal):
        return True
    if isinstance(e, scf.Bin):
        return _uses_vector(e.a, fn) or _uses_vector(e.b, fn)
    if isinstance(e, scf.Apply):
        return _uses_vector(e.a, fn)
    if isinstance(e, scf.Load):
        return any(_uses_vector(i, fn) for i in e.indices)
    return False


def _rewrite_reduction(s, inner_streams, fn):
    if (isinstance(s, scf.SetVar) and isinstance(s.value, scf.Bin)
            and s.value.op == "+"
            and isinstance(s.value.a, scf.VarRef)
            and s.value.a.name == s.var
            and _uses_vector(s.value.b, fn)):
        return scf.SetVar(s.var, scf.Bin("+", s.value.a,
                                         scf.Apply("hsum", s.value.b)))
    return s
