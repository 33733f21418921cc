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
a CUDA call launches the chosen variant or raises; meta tensors (the dry
run) get their outputs' shapes and report the bytes
(:func:`.sls.meta_launch`), here and in the backward.
``block_gather_cuda.launches`` counts the copy kernel's launches,
``block_gather_cuda.variants`` those of each variant and of the grouping
pass ("group").

The gradient (the reference takes it with ``jax.grad`` of ``jnp.take``) is
a scatter-add, ``dtable[r] = sum over g with idxs[g] = r of dout[g]``: a
segmented sum over the transposed lookups (:func:`block_gather_backward`).
:func:`transposed_lookups` sorts the lookups stably by block id on the card
(``ember_transpose``, ``csrc/ember_transpose.cu``) and ``ember_sls`` sums
each block's segment in that order (its sparse variant where the table has
no fewer blocks than there are lookups).  :class:`BlockGather` pairs the
two; :func:`block_gather` (``kernels.ops.block_gather``) takes it where the
table needs a gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref
from .sls import (DTYPES, aligned16, check_index, check_table, kernel_variant,
                  launch_on, launch_variant as launch_sls, meta_launch,
                  one_device, refuse_autograd, row_tile)


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
    dev = one_device(table, idxs, roff, meta=True)
    if dev.type == "cpu":
        return ref.block_gather(table, idxs, block_rows=block_rows, roff=roff)
    refuse_autograd("ember_block_gather", table)
    num_blocks, emb_len = idxs.numel(), table.shape[1]
    out = torch.empty((num_blocks, block_rows, emb_len), dtype=table.dtype,
                      device=dev)
    if dev.type == "meta":      # the rows read are the rows written
        meta_launch("block_gather", (out, idxs, roff), (out,))
        return out
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


def block_gather_backward(dout: torch.Tensor, idxs: torch.Tensor,
                          num_rows: int, *, block_rows: int = 1,
                          roff: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The gradient of :func:`block_gather_cuda` for its table of
    ``num_rows`` rows: dout (G, block_rows, E) -> (num_rows, E) in dout's
    dtype, each table row the fp32 sum of the dout blocks that read it
    (0 where none does).

    CPU tensors run the plain ``index_add_``
    (:func:`repro_torch.kernels.ref.block_gather_backward`).  On the card
    the lookups are transposed into CSR over the table's ``num_rows /
    block_rows`` blocks (:func:`transposed_lookups`) and ``ember_sls`` sums
    each block's segment of dout rows (``block_rows * E`` wide), in the
    sorted order: deterministic.  ``block_gather_backward.launches`` counts
    the ``ember_sls`` launches it made (none where there is nothing to
    sum: no lookups, or rows of width 0)."""
    check_index("idxs", idxs)
    if roff is not None:
        check_index("roff", roff, idxs.numel())
    num_blocks = idxs.numel()
    if dout.dim() != 3 or dout.shape[:2] != (num_blocks, block_rows) or \
            num_rows % block_rows:
        raise ValueError(f"dout {tuple(dout.shape)} is not the gather of "
                         f"{num_blocks} blocks of {block_rows} rows of a "
                         f"{num_rows}-row table")
    dev = one_device(dout, idxs, roff, meta=True)
    if dev.type == "cpu":
        return ref.block_gather_backward(dout, idxs, num_rows,
                                         block_rows=block_rows, roff=roff)
    emb_len = dout.shape[2]
    if dev.type == "meta":
        out = torch.empty((num_rows, emb_len), dtype=dout.dtype, device=dev)
        meta_launch("block_gather_bwd", (dout, idxs, roff), (out,))
        return out
    if num_blocks == 0 or emb_len == 0:
        return torch.zeros((num_rows, emb_len), dtype=dout.dtype, device=dev)
    if dout.dtype not in DTYPES:
        raise ValueError(f"dout must be float32 or bfloat16, got {dout.dtype}")
    refuse_autograd("ember_sls", dout)
    n_tbl = num_rows // block_rows
    order, ptrs = transposed_lookups(idxs, roff, n_tbl)
    rows = dout.reshape(num_blocks, block_rows * emb_len).contiguous()
    out = torch.empty((n_tbl, block_rows * emb_len), dtype=dout.dtype,
                      device=dev)
    launch_sls(kernel_variant("sls", rows.shape[1], rows.element_size(),
                              aligned16(rows, out), num_segments=n_tbl,
                              lookups=num_blocks, plain_sum=True),
               rows, ptrs, order, out)
    block_gather_backward.launches += 1
    return out.view(num_rows, emb_len)


block_gather_backward.launches = 0


def transposed_lookups(idxs: torch.Tensor, roff: Optional[torch.Tensor],
                       n_tbl: int) -> tuple:
    """The lookups as CSR over the table's ``n_tbl`` blocks, for
    :func:`block_gather_backward`: ``(order, ptrs)``, the lookups sorted
    stably by block id ``idxs[g] + roff[g]`` (int32, G) and each block's
    segment offsets (int32, ``n_tbl + 1``).  Block ids must lie in ``[0,
    n_tbl)``.

    CPU tensors run the plain version (:func:`ref.transposed_lookups`: a
    stable argsort, a bincount and a cumsum).  On the card one
    ``ember_transpose`` call (a stable radix sort of the block ids, then
    ``ptrs`` by lower bound) writes the same two tensors, or raises;
    ``transposed_lookups.launches`` counts those calls (none for G = 0)."""
    check_index("idxs", idxs)
    num_lookups = idxs.numel()
    if roff is not None:
        check_index("roff", roff, num_lookups)
    dev = one_device(idxs, roff, meta=True)
    if dev.type == "cpu":
        return ref.transposed_lookups(idxs, roff, n_tbl)
    if dev.type == "meta":
        order = torch.empty(num_lookups, dtype=torch.int32, device=dev)
        ptrs = torch.empty(n_tbl + 1, dtype=torch.int32, device=dev)
        meta_launch("gather_transpose", (idxs, roff), (order, ptrs))
        return order, ptrs
    if num_lookups == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.zeros(n_tbl + 1, dtype=torch.int32, device=dev))
    lib = _build.library()
    # one allocation: order, ptrs, then the kernel's scratch (16-byte
    # aligned: a whole number of 4-int units before it)
    head = -(-(num_lookups + n_tbl + 1) // 4) * 4
    buf = torch.empty(head + lib.ember_transpose_scratch_bytes(num_lookups)
                      // 4, dtype=torch.int32, device=dev)
    order, ptrs = buf[:num_lookups], buf[num_lookups:num_lookups + n_tbl + 1]
    err = launch_on(dev, lambda stream: lib.ember_transpose(
        idxs.data_ptr(), None if roff is None else roff.data_ptr(),
        order.data_ptr(), ptrs.data_ptr(), buf.data_ptr() + 4 * head,
        num_lookups, n_tbl, stream))
    _build.check(err, "ember_transpose")
    transposed_lookups.launches += 1
    return order, ptrs


transposed_lookups.launches = 0


class BlockGather(torch.autograd.Function):
    """The block gather with its gradient for the table
    (:func:`block_gather_backward`); the indices take none."""

    @staticmethod
    def forward(ctx, table, idxs, block_rows: int, roff):
        ctx.save_for_backward(idxs, roff)
        ctx.num_rows, ctx.block_rows = table.shape[0], block_rows
        return block_gather_cuda(table, idxs, block_rows=block_rows,
                                 roff=roff)

    @staticmethod
    def backward(ctx, dout):
        idxs, roff = ctx.saved_tensors
        return (block_gather_backward(dout.contiguous(), idxs, ctx.num_rows,
                                      block_rows=ctx.block_rows, roff=roff),
                None, None, None)


def block_gather(table: torch.Tensor, idxs: torch.Tensor, *,
                 block_rows: int = 1,
                 roff: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`block_gather_cuda`'s function, differentiable in the table:
    through :class:`BlockGather` where grad mode is on and the table needs
    a gradient, else the forward alone."""
    if torch.is_grad_enabled() and table.requires_grad:
        return BlockGather.apply(table, idxs, block_rows, roff)
    return block_gather_cuda(table, idxs, block_rows=block_rows, roff=roff)
