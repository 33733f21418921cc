"""Plain PyTorch versions of the Hopper kernels.

The kernel wrappers (:mod:`.sls`, :mod:`.gather`) run these for tensors on
the CPU; the tests hold them against the JAX package, and ``chip_smoke.py``
holds each kernel against them on the card.  They repeat the kernels'
arithmetic (fp32 accumulation, one cast to the table's dtype at the end) and
are no yardstick of speed.

Unlike the reference's oracles, CSR input is taken as ``ptrs`` directly (no
segment-id form): ``idxs`` may be longer than ``ptrs[-1]`` (the executor's
capacity padding), and the tail is never read.
"""
from __future__ import annotations

from typing import Optional

import torch


def sls(table: torch.Tensor, ptrs: torch.Tensor, idxs: torch.Tensor,
        weights: Optional[torch.Tensor] = None, *, num_segments: int,
        add_op: str = "add", mul_op: str = "mul",
        seg_base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SLS / EmbeddingBag over CSR segments:
    ``out[b] = (+)_{p in [ptrs[b], ptrs[b+1])} w_p (x) T[idxs[p] + seg_base[b]]``
    with (+) in {add, max, min} and (x) in {mul, add}; an empty segment is 0
    under every (+).  Reads ``ptrs[-1]`` on the host."""
    dev = table.device
    emb_len = table.shape[1]
    p64 = ptrs.to(torch.int64)
    nnz = int(p64[-1])
    seg = torch.repeat_interleave(torch.arange(num_segments, device=dev),
                                  p64[1:] - p64[:-1], output_size=nnz)
    rows = idxs[:nnz].to(torch.int64)
    if seg_base is not None:
        rows = rows + seg_base.to(torch.int64)[seg]
    vals = table.index_select(0, rows).float()
    if weights is not None:
        w = weights[:nnz].float()[:, None]
        vals = vals * w if mul_op == "mul" else vals + w
    out = torch.zeros((num_segments, emb_len), dtype=torch.float32,
                      device=dev)
    if add_op == "add":
        out.index_add_(0, seg, vals)
    else:
        # include_self=False: rows no lookup reaches keep their 0
        out.scatter_reduce_(0, seg[:, None].expand(-1, emb_len), vals,
                            reduce={"max": "amax", "min": "amin"}[add_op],
                            include_self=False)
    return out.to(table.dtype)


def block_gather(table: torch.Tensor, idxs: torch.Tensor, *,
                 block_rows: int = 1,
                 roff: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block gather: ``out[g, r] = T[(idxs[g] + roff[g]) * R + r]``."""
    blk = idxs.to(torch.int64)
    if roff is not None:
        blk = blk + roff.to(torch.int64)
    rows = (blk[:, None] * block_rows +
            torch.arange(block_rows, device=table.device)[None, :])
    return table.index_select(0, rows.reshape(-1)).reshape(
        idxs.shape[0], block_rows, table.shape[1])
