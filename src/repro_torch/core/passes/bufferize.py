"""Bufferization pass (paper §7.2).

Marshals and computes embedding vectors as *compound* values: the access
unit pushes all ``emb_len`` elements of an embedding vector per control
token, and the execute unit processes them with a tight chunked loop.  This
amortizes token overhead over whole vectors — the dominant win for long
embedding vectors (RM2/RM3 in Fig 16).

Structurally (Fig 15b → 15c): a buffer stream is declared before the inner
loop; the inner loop pushes loaded elements into it; the element-wise
callback moves *after* the inner loop and becomes a whole-row store
(:class:`~repro.core.slc.StoreBuf`).

Two shapes are recognized:

* reduction ops (sls/spmm/kg/gather): the inner callback is a single
  (possibly scaled) accumulate of the table-element stream — it becomes
  ``out[row, :] ⊕= scale ⊗ vec(buf)``;
* fusedmm: the SDDMM accumulator + SpMM workspace loop pair becomes two
  buffer streams and ``out[i, :] += f(dot(buf_xi, buf_xj)) * vec(buf_xj)``
  — the workspace loop's memory traffic disappears into the buffer reuse
  (this is what the paper's hand-written MP code does).
"""
from __future__ import annotations

import copy

from .. import scf
from ..slc import (BufStr, Callback, DotBuf, MemStr, PushBuf, SlcFor, SlcFunc,
                   StoreBuf, ToVal, verify)


class BufferizeError(Exception):
    pass


def bufferize(fn: SlcFunc) -> SlcFunc:
    fn = copy.deepcopy(fn)
    if not _bufferize_body(fn, fn.body, parent=None):
        raise BufferizeError("no bufferizable inner loop found")
    fn.opt["bufferized"] = True
    verify(fn)
    return fn


def _bufferize_body(fn, body, parent) -> bool:
    for pos, node in enumerate(body):
        if not isinstance(node, SlcFor):
            continue
        if any(isinstance(c, SlcFor) for c in node.body):
            if _bufferize_body(fn, node.body, parent=node):
                return True
            continue
        # `node` is an innermost loop — try both recognized shapes
        if _try_reduction_shape(fn, body, pos, node):
            return True
        if _try_fusedmm_shape(fn, body, pos, node):
            return True
    return False


def _try_reduction_shape(fn, parent_body, pos, inner: SlcFor) -> bool:
    """sls/spmm/kg/gather: inner = [MemStr(s_val), Callback([Store])]."""
    mems = [n for n in inner.body if isinstance(n, MemStr)]
    cbs = [n for n in inner.body if isinstance(n, Callback)]
    if len(mems) != 1 or len(cbs) != 1 or len(cbs[0].body) != 1:
        return False
    st = cbs[0].body[0]
    if not isinstance(st, scf.Store):
        return False
    s_val = mems[0].stream
    # store value: ToVal(s_val) or Bin(op, scale, ToVal(s_val))
    scale = None
    v = st.value
    if isinstance(v, scf.Bin) and isinstance(v.b, ToVal) and v.b.stream == s_val:
        scale = v.a
    elif not (isinstance(v, ToVal) and v.stream == s_val):
        return False
    # store indices: leading row indices + trailing inner-loop index
    if not (isinstance(st.indices[-1], ToVal)
            and st.indices[-1].stream == inner.stream):
        return False
    row = tuple(st.indices[:-1])

    buf = f"buf_{s_val}"
    inner.body = [mems[0], PushBuf(buf, s_val)]
    parent_body[pos:pos + 1] = [
        BufStr(buf),
        inner,
        StoreBuf(st.memref, row, buf, st.accumulate, scale=scale),
    ]
    return True


def _try_fusedmm_shape(fn, parent_body, pos, inner: SlcFor) -> bool:
    """fusedmm: [MemStr xi, MemStr xj, Callback[s += xi*xj]] + trailing
    workspace callback ``for e2: out[i,e2] += s * x[j,e2]``."""
    mems = [n for n in inner.body if isinstance(n, MemStr)]
    cbs = [n for n in inner.body if isinstance(n, Callback)]
    if len(mems) != 2 or len(cbs) != 1:
        return False
    red = cbs[0].body[-1]
    if not (isinstance(red, scf.SetVar) and isinstance(red.value, scf.Bin)):
        return False
    acc_var = red.var
    # locate: preceding init callback (s = 0) and trailing workspace callback
    init_cb = ws_cb = None
    for n in parent_body[:pos]:
        if isinstance(n, Callback) and any(
                isinstance(s, scf.Let) and s.var == acc_var for s in n.body):
            init_cb = n
    for n in parent_body[pos + 1:]:
        if isinstance(n, Callback) and any(
                isinstance(s, scf.For) for s in n.body):
            ws_cb = n
            break
    if init_cb is None or ws_cb is None:
        return False
    ws_for = next(s for s in ws_cb.body if isinstance(s, scf.For))
    ws_store = next(s for s in ws_for.body if isinstance(s, scf.Store))
    row = tuple(i for i in ws_store.indices
                if not (isinstance(i, scf.VarRef) and i.name == ws_for.var))
    fnname = "identity"
    for s in ws_cb.body:
        if isinstance(s, scf.SetVar) and isinstance(s.value, scf.Apply):
            fnname = s.value.fn

    s_xi, s_xj = mems[0].stream, mems[1].stream
    bxi, bxj = f"buf_{s_xi}", f"buf_{s_xj}"
    inner.body = [mems[0], mems[1], PushBuf(bxi, s_xi), PushBuf(bxj, s_xj)]
    new_nodes = [
        BufStr(bxi), BufStr(bxj), inner,
        StoreBuf(ws_store.memref, row, bxj, ws_store.accumulate,
                 scale=DotBuf(bxi, bxj, fnname)),
    ]
    out = []
    for n in parent_body:
        if n is init_cb or n is ws_cb:
            continue
        if n is inner:
            out.extend(new_nodes)
        else:
            out.append(n)
    parent_body[:] = out
    return True
