"""Block gather on Hopper: the wrapper of ``ember_block_gather``
(``csrc/ember_kernels.cu``), which replaces the TPU kernel
``block_gather_pallas`` / ``_gather_kernel`` of ``src/repro/kernels/gather.py``.

A pure copy of whole rows (the store stream: no compute).  A fused gather
unit's ``roff`` table-offset stream is passed in and added in the kernel.
CPU tensors run the plain version (:func:`repro_torch.kernels.ref.block_gather`);
a CUDA call launches the kernel or raises.  ``block_gather_cuda.launches``
counts the kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref
from .sls import aligned16, check_index, check_table, one_device, row_tile


def block_gather_cuda(table: torch.Tensor, idxs: torch.Tensor, *,
                      block_rows: int = 1,
                      roff: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[g, r, :] = table[(idxs[g] + roff[g]) * block_rows + r, :]``.

    table (N * block_rows, E) f32/bf16; idxs (G,) int32; roff (G,) int32 or
    None -> (G, block_rows, E).  Indices are not bounds-checked here (the
    executor validates them on the host)."""
    check_table(table)
    check_index("idxs", idxs)
    if roff is not None:
        check_index("roff", roff, idxs.numel())
    if block_rows < 1 or table.shape[0] % block_rows:
        raise ValueError(f"table rows {table.shape[0]} are not whole blocks "
                         f"of {block_rows}")
    dev = one_device(table, idxs, roff)
    if dev.type == "cpu":
        return ref.block_gather(table, idxs, block_rows=block_rows, roff=roff)
    num_blocks, emb_len = idxs.numel(), table.shape[1]
    out = torch.empty((num_blocks, block_rows, emb_len), dtype=table.dtype,
                      device=dev)
    if num_blocks == 0 or emb_len == 0:
        return out
    itemsize = table.element_size()
    tile = row_tile(emb_len, itemsize, aligned16(table, out))
    with torch.cuda.device(dev):
        err = _build.library().ember_block_gather(
            table.data_ptr(), idxs.data_ptr(),
            None if roff is None else roff.data_ptr(), out.data_ptr(),
            num_blocks, block_rows, emb_len * itemsize, tile.elems * itemsize,
            tile.threads_per_row, tile.rows_per_block,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ember_block_gather")
    block_gather_cuda.launches += 1
    return out


block_gather_cuda.launches = 0
