"""SLS / EmbeddingBag on Hopper: the wrapper of ``ember_sls``
(``csrc/ember_kernels.cu``), which replaces the TPU kernel
``sls_pallas`` / ``_sls_kernel`` of ``src/repro/kernels/sls.py``.

The wrapper checks its arguments, allocates the output, and launches on the
current CUDA stream.  A call whose tensors lie on the CPU runs the plain
version (:func:`repro_torch.kernels.ref.sls`) instead; a CUDA call launches
the kernel or raises -- nothing falls back.  ``sls_cuda.launches`` counts the
kernel launches.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _build, ref

ADD_OPS = {"add": 0, "max": 1, "min": 2}
MUL_OPS = {"mul": 0, "add": 1}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_THREADS = 256


def threads_per_row(vecs: int) -> int:
    """Threads that share one row: the power of two covering ``vecs``
    accesses, at most a warp."""
    return min(32, 1 << (max(vecs, 1) - 1).bit_length())


class RowTile(NamedTuple):
    elems: int              # elements per thread access (16 bytes, or 1)
    threads_per_row: int    # threads sharing one output row (<= a warp)
    rows_per_block: int     # output rows per BLOCK_THREADS-thread block


def row_tile(emb_len: int, itemsize: int, vec: bool = True) -> RowTile:
    """The launch shape of rows of ``emb_len`` elements: 16-byte vectors
    when ``vec`` (the operands are 16-byte aligned) and the row width allow
    them, else one element per access; the threads of a row cover its
    accesses; the rows of a block fill ``BLOCK_THREADS``.  The one place
    both kernels' launch geometry is decided."""
    elems = 16 // itemsize if vec and (emb_len * itemsize) % 16 == 0 else 1
    tpr = threads_per_row(-(-emb_len // elems))
    return RowTile(elems, tpr, max(1, BLOCK_THREADS // tpr))


#: the widest row the FusedMM ring variant holds: 32 lanes x 32 words
FUSEDMM_RING_MAX_ROW_BYTES = 4096
#: the narrowest row the FusedMM ring variant takes, the first width of
#: whole 16-byte units past 1 KB.  On an H100 (``chip_smoke.py``'s ``[6 gnn
#: widths]``; PERF.md) the rows variant was faster at every fp32 width up
#: to 512 B (a bulk copy costs the SM a fixed time however small) and at
#: 960 and 1024 B; from 1088 B to 4 KB the ring led or tied at every width.
FUSEDMM_RING_MIN_ROW_BYTES = 1040


def kernel_variant(kind: str, emb_len: int, itemsize: int,
                   aligned: bool) -> str:
    """Which kernel of a row-streaming ``kind`` runs rows of ``emb_len``
    elements of ``itemsize`` bytes: the bulk-copy variant when a row is
    whole 16-byte units and the operands are 16-byte aligned, as
    ``cp.async.bulk`` needs (``block_gather``: "bulk"; ``fusedmm``: "ring",
    for rows of :data:`FUSEDMM_RING_MIN_ROW_BYTES` to
    :data:`FUSEDMM_RING_MAX_ROW_BYTES`); else "rows", the per-thread row
    kernels that :func:`row_tile` shapes.  The one place the variant is
    decided, from the shapes, before the launch: a wrapper never switches
    variant after a build or launch error."""
    row_bytes = emb_len * itemsize
    bulk = aligned and row_bytes % 16 == 0
    if kind == "block_gather":
        return "bulk" if bulk else "rows"
    if kind == "fusedmm":
        return ("ring" if bulk and FUSEDMM_RING_MIN_ROW_BYTES <= row_bytes
                <= FUSEDMM_RING_MAX_ROW_BYTES else "rows")
    raise ValueError(f"no kernel variants for {kind!r}")


def aligned16(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def check_index(name: str, t: torch.Tensor, numel: Optional[int] = None):
    if t.dim() != 1 or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} entries, expected {numel}")


def check_table(table: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype not in DTYPES or \
            not table.is_contiguous():
        raise ValueError("table must be a contiguous 2-D float32 or bfloat16 "
                         f"tensor, got {table.dtype} of shape "
                         f"{tuple(table.shape)}")


def one_device(*tensors) -> torch.device:
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def sls_cuda(table: torch.Tensor, ptrs: torch.Tensor, idxs: torch.Tensor,
             weights: Optional[torch.Tensor] = None, *, num_segments: int,
             add_op: str = "add", mul_op: str = "mul",
             seg_base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[b] = (+)_{p in [ptrs[b], ptrs[b+1])} w_p (x)
    table[idxs[p] + seg_base[b]]``, shape ``(num_segments, E)`` in the
    table's dtype; an empty segment is 0.

    table (N, E) f32/bf16; ptrs (B+1,) int32; idxs (>= nnz,) int32 (entries
    past ``ptrs[-1]`` are never read); weights (len(idxs),) in the table's
    dtype or None; seg_base (B,) int32 or None.  Indices are not
    bounds-checked here: the executor validates them on the host
    (``AccessPlan.harden_step``)."""
    check_table(table)
    check_index("ptrs", ptrs, num_segments + 1)
    check_index("idxs", idxs)
    if seg_base is not None:
        check_index("seg_base", seg_base, num_segments)
    if weights is not None and (weights.dim() != 1 or
                                weights.dtype != table.dtype or
                                not weights.is_contiguous() or
                                weights.numel() != idxs.numel()):
        raise ValueError("weights must be a contiguous 1-D tensor of the "
                         "table's dtype, one per idxs entry")
    if add_op not in ADD_OPS or mul_op not in MUL_OPS:
        raise ValueError(f"unsupported semiring ({add_op}, {mul_op})")
    dev = one_device(table, ptrs, idxs, weights, seg_base)
    if dev.type == "cpu":
        return ref.sls(table, ptrs, idxs, weights, num_segments=num_segments,
                       add_op=add_op, mul_op=mul_op, seg_base=seg_base)
    emb_len = table.shape[1]
    out = torch.empty((num_segments, emb_len), dtype=table.dtype, device=dev)
    if num_segments == 0 or emb_len == 0:
        return out
    tile = row_tile(emb_len, table.element_size(), aligned16(table, out))
    with torch.cuda.device(dev):
        err = _build.library().ember_sls(
            table.data_ptr(), ptrs.data_ptr(), idxs.data_ptr(),
            None if weights is None else weights.data_ptr(),
            None if seg_base is None else seg_base.data_ptr(),
            out.data_ptr(), num_segments, emb_len, DTYPES[table.dtype],
            ADD_OPS[add_op], MUL_OPS[mul_op], int(tile.elems > 1),
            tile.threads_per_row, tile.rows_per_block,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ember_sls")
    sls_cuda.launches += 1
    return out


sls_cuda.launches = 0
