"""Model-specific optimizations (paper §7.4).

Block-sparse attention gathers (SpAttn) have *no* compute: the callback just
copies the marshaled vector into the output.  Ember adds **store streams** so
the access unit writes results directly to memory without passing through
the core at all — the whole operation is offloaded (the 17× case in Fig 7).

The paper also adds cache-level / temporal-hint selection on load streams
(load reused index blocks from L2, stream embedding data non-temporally).
TPUs have no hardware-managed cache between HBM and VMEM, so those hints
have no direct analogue (DESIGN.md §2); we record the *intent* as plan hints
(``resident_blocks``) which the Pallas block-gather kernel realizes by
keeping hot blocks pinned in VMEM across grid steps, and which the cost
model uses to discount re-fetch traffic.
"""
from __future__ import annotations

import copy

from ..slc import SlcFunc, StoreBuf, verify


def apply_store_streams(fn: SlcFunc) -> SlcFunc:
    """Convert compute-free whole-row stores into access-unit store streams."""
    if fn.op.has_compute:
        return fn  # only legal when the execute unit contributes nothing
    fn = copy.deepcopy(fn)
    n = 0

    def rec(body):
        nonlocal n
        for node in body:
            if isinstance(node, StoreBuf) and node.accumulate is None \
                    and node.scale is None:
                node.as_store_stream = True
                n += 1
            elif hasattr(node, "body"):
                rec(node.body)
    rec(fn.body)
    if n:
        fn.opt["store_streams"] = True
        fn.opt["resident_blocks"] = True   # L2-residency intent (see above)
    verify(fn)
    return fn
