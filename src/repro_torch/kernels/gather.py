"""Block gather on Hopper: the wrapper of the kernels in
``csrc/ember_kernels.cu`` that replace the TPU kernel ``block_gather_pallas``
/ ``_gather_kernel`` of ``src/repro/kernels/gather.py``.

A pure copy of whole rows (the store stream: no compute).  A fused gather
unit's ``roff`` table-offset stream is passed in and added in the kernel.
Two variants, chosen from the shapes by :func:`.sls.kernel_variant`:

* ``bulk`` (rows of whole 16-byte units, 16-byte aligned table): a grouping
  pre-pass (``ember_gather_group``) collects the lookups of each distinct
  block on the card, then ``ember_block_gather_bulk`` reads every distinct
  block once with ``cp.async.bulk`` and stores it to each of its outputs;
* ``rows`` (other widths, unaligned tables): ``ember_block_gather`` copies
  each output row with 16-byte (or single-element) loads.

CPU tensors run the plain version (:func:`repro_torch.kernels.ref.block_gather`);
a CUDA call launches the chosen variant or raises.
``block_gather_cuda.launches`` counts the copy kernel's launches,
``block_gather_cuda.variants`` those of each variant and of the grouping
pass ("group").
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref
from .sls import (aligned16, check_index, check_table, kernel_variant,
                  one_device, row_tile)


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
    variant = kernel_variant("block_gather", emb_len, table.element_size(),
                             aligned16(table, out))
    launch_variant(variant, table, idxs, out, block_rows=block_rows,
                   roff=roff)
    return out


def launch_variant(variant: str, table: torch.Tensor, idxs: torch.Tensor,
                   out: torch.Tensor, *, block_rows: int = 1,
                   roff: Optional[torch.Tensor] = None) -> None:
    """Launch the gather's ``variant`` ("bulk" or "rows") into ``out`` (G,
    block_rows, E) on the current stream, and count it.  The one launch
    path of :func:`block_gather_cuda`, which has checked the arguments and
    chosen the variant; called directly only to time one variant against
    the other on the same inputs.  Raises on a build or launch error."""
    num_blocks, emb_len = idxs.numel(), table.shape[1]
    itemsize = table.element_size()
    lib = _build.library()
    roff_ptr = None if roff is None else roff.data_ptr()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        if variant == "bulk":
            scratch = torch.empty(lib.ember_gather_scratch_bytes(num_blocks),
                                  dtype=torch.uint8, device=out.device)
            _build.check(lib.ember_gather_group(
                idxs.data_ptr(), roff_ptr, scratch.data_ptr(), num_blocks,
                stream), "ember_gather_group")
            block_gather_cuda.variants["group"] += 1
            err = lib.ember_block_gather_bulk(
                table.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                num_blocks, block_rows * emb_len * itemsize, stream)
        elif variant == "rows":
            tile = row_tile(emb_len, itemsize, aligned16(table, out))
            err = lib.ember_block_gather(
                table.data_ptr(), idxs.data_ptr(), roff_ptr, out.data_ptr(),
                num_blocks, block_rows, emb_len * itemsize,
                tile.elems * itemsize, tile.threads_per_row,
                tile.rows_per_block, stream)
        else:
            raise ValueError(f"no block_gather variant {variant!r}")
    _build.check(err, f"ember_block_gather ({variant})")
    block_gather_cuda.launches += 1
    block_gather_cuda.variants[variant] += 1


block_gather_cuda.launches = 0
block_gather_cuda.variants = {"bulk": 0, "group": 0, "rows": 0}
