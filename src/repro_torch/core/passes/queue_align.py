"""Queue-alignment pass (paper §7.3).

Scalar operands (segment IDs) interleaved between embedding vectors in the
data queue break vector-load alignment.  When the output-row index a
callback pops is just the induction variable of an outer loop, Ember keeps a
*core-side counter* instead: the access unit stops marshaling the scalar,
and the execute unit increments its local counter on a segment-end control
token (Fig 14d / 15d).

On the TPU backend this corresponds to (a) deriving output addresses from
the grid position / scalar-prefetched ``ptrs`` instead of streaming them,
and (b) padding ``emb_len`` to a multiple of the 128-lane vector so each
marshaled vector is tile-aligned in VMEM — both recorded in ``fn.opt`` for
the kernel-plan generator.
"""
from __future__ import annotations

import copy

from .. import scf
from ..slc import Callback, SlcFor, SlcFunc, StoreBuf, ToVal, verify


def queue_align(fn: SlcFunc) -> SlcFunc:
    fn = copy.deepcopy(fn)
    aligned = _align_body(fn.body, loop_stack=[])
    if fn.opt.get("vlen"):
        v = fn.opt["vlen"]
        fn.opt["padded_emb"] = -(-fn.params["emb_len"] // v) * v
    fn.opt["queue_aligned"] = bool(aligned)
    verify(fn)
    return fn


def _align_body(body, loop_stack) -> bool:
    changed = False
    for node in body:
        if isinstance(node, SlcFor):
            changed |= _align_body(node.body, loop_stack + [node])
        elif isinstance(node, StoreBuf) and not node.as_store_stream:
            # store-stream rows are access-side addresses already (§7.4);
            # there is no queue traffic left to align for them
            changed |= _align_storebuf(node, body, loop_stack)
    return changed


def _align_storebuf(sb: StoreBuf, body, loop_stack) -> bool:
    """Replace row indices that are outer-loop induction streams with
    execute-side counters incremented on segment-end tokens."""
    if not loop_stack:
        return False
    by_stream = {l.stream: l for l in loop_stack}
    new_rows = []
    changed = False
    for idx in sb.row_indices:
        # Only the *outermost* loop's induction can be kept as a core-side
        # counter: counters of nested loops would need per-ancestor-iteration
        # resets, which the token stream does not expose (the paper pads
        # those scalars to vectors instead, §7.3 — we keep popping them).
        if (isinstance(idx, ToVal) and idx.stream in by_stream
                and by_stream[idx.stream] is loop_stack[0]):
            loop = by_stream[idx.stream]
            ctr = f"ctr_{idx.stream}"
            if ctr not in loop.carry:
                loop.carry[ctr] = 0
                # increment at the end of each `loop` iteration: the last
                # position of its body ≙ the child's end event in DLC
                loop.body.append(Callback([
                    scf.SetVar(ctr, scf.Bin("+", scf.VarRef(ctr), scf.Const(1)))
                ]))
            new_rows.append(scf.VarRef(ctr))
            changed = True
        else:
            new_rows.append(idx)
    sb.row_indices = tuple(new_rows)
    return changed
