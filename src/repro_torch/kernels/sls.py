"""SLS / EmbeddingBag on Hopper: the wrapper of ``ember_sls``
(``csrc/ember_kernels.cu``), which replaces the TPU kernel
``sls_pallas`` / ``_sls_kernel`` of ``src/repro/kernels/sls.py``.

The wrapper checks its arguments, allocates the output, and launches on the
current CUDA stream.  A call whose tensors lie on the CPU runs the plain
version (:func:`repro_torch.kernels.ref.sls`) instead; a CUDA call launches
the kernel or raises -- nothing falls back.  Two variants, chosen from the
shapes by :func:`kernel_variant`:

* ``rows`` (``ember_sls``: ``sls_kernel``): every semiring, weights and
  ``seg_base``; a thread group per (segment, column tile);
* ``sparse`` (``ember_sls_sparse``): the unweighted sum without
  ``seg_base`` on rows of whole 16-byte units when there are no more
  lookups than segments -- the block gather's backward over its transposed
  lookups, mostly empty rows and a few hot ones.  Same bits as ``rows``.

``sls_cuda.launches`` counts the kernel launches, ``sls_cuda.variants``
those of each variant.
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
                   aligned: bool, *, num_segments: int = 0,
                   lookups: int = 0, plain_sum: bool = False) -> str:
    """Which kernel of a row-streaming ``kind`` runs rows of ``emb_len``
    elements of ``itemsize`` bytes: the bulk-copy variant when a row is
    whole 16-byte units and the operands are 16-byte aligned, as
    ``cp.async.bulk`` needs (``block_gather``: "bulk"; ``fusedmm``: "ring",
    for rows of :data:`FUSEDMM_RING_MIN_ROW_BYTES` to
    :data:`FUSEDMM_RING_MAX_ROW_BYTES`); ``sls``: "sparse" for a
    ``plain_sum`` (unweighted add, no ``seg_base``) on such rows with no
    more ``lookups`` (the length of idxs) than ``num_segments``, most of
    them then empty; else "rows", the per-thread row kernels that
    :func:`row_tile` shapes.  The one place the variant is decided, from
    the shapes, before the launch: a wrapper never switches variant after a
    build or launch error."""
    row_bytes = emb_len * itemsize
    bulk = aligned and row_bytes % 16 == 0
    if kind == "block_gather":
        return "bulk" if bulk else "rows"
    if kind == "fusedmm":
        return ("ring" if bulk and FUSEDMM_RING_MIN_ROW_BYTES <= row_bytes
                <= FUSEDMM_RING_MAX_ROW_BYTES else "rows")
    if kind == "sls":
        return ("sparse" if bulk and plain_sum and lookups <= num_segments
                else "rows")
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


def refuse_autograd(what: str, *tensors) -> None:
    """Raise where a kernel would run under autograd on tensors that need a
    gradient: its output, written through a raw pointer, has no
    ``grad_fn``, so the gradient would be dropped without a word.  The
    kernels on the training path are called through their
    ``torch.autograd.Function`` (``flash_attention.FlashAttention``,
    ``gather.BlockGather``), whose forward runs with grad mode off."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} was called under autograd on tensors that require a "
            "gradient; its output would carry none: call it through "
            "repro_torch.kernels.ops (its torch.autograd.Function)")


def launch_on(dev: torch.device, launch):
    """``launch(stream)`` with ``dev`` the current device and ``stream`` the
    raw handle of its current stream: directly where ``dev`` is current
    already (the common case; entering ``torch.cuda.device`` costs more
    host time than a small kernel takes), else inside ``torch.cuda.device``.
    Returns what ``launch`` returns."""
    if torch.cuda.current_device() == dev.index:
        return launch(torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return launch(torch._C._cuda_getCurrentRawStream(dev.index))


def one_device(*tensors, meta: bool = False) -> torch.device:
    """The one device of ``tensors``: the CPU or a CUDA card, or with
    ``meta`` also the meta device (a wrapper on the model's path, which
    the dry run drives without storage: :func:`meta_launch`)."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda") and not (meta and dev.type == "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


#: the step counters open on this thread
#: (:class:`repro_torch.roofline.analysis.StepCounter`); a stack, as
#: torch's dispatch modes are
META_COUNTERS: list = []


def meta_launch(kernel: str, reads: tuple, writes: tuple) -> None:
    """Where a wrapper is handed meta tensors (the dry run: nothing is
    allocated and nothing launches), it makes its outputs' shapes and
    reports here the bytes its kernel would read and write, which no aten
    op dispatches: ``reads`` and ``writes`` are tensors (None skipped),
    each counted once.  Counts no launch."""
    for counter in META_COUNTERS:
        counter.kernel(kernel, reads, writes)


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
    refuse_autograd("ember_sls", table, weights)
    emb_len = table.shape[1]
    out = torch.empty((num_segments, emb_len), dtype=table.dtype, device=dev)
    if num_segments == 0 or emb_len == 0:
        return out
    variant = kernel_variant(
        "sls", emb_len, table.element_size(), aligned16(table, out),
        num_segments=num_segments, lookups=idxs.numel(),
        plain_sum=weights is None and seg_base is None and add_op == "add")
    launch_variant(variant, table, ptrs, idxs, out, weights,
                   add_op=add_op, mul_op=mul_op, seg_base=seg_base)
    return out


def launch_variant(variant: str, table: torch.Tensor, ptrs: torch.Tensor,
                   idxs: torch.Tensor, out: torch.Tensor,
                   weights: Optional[torch.Tensor] = None, *,
                   add_op: str = "add", mul_op: str = "mul",
                   seg_base: Optional[torch.Tensor] = None) -> None:
    """Launch the SLS ``variant`` ("rows" or "sparse") into ``out``
    (num_segments, E) on the current stream, and count it.  The one launch
    path of :func:`sls_cuda`, which has checked the arguments and chosen
    the variant; called directly only to time one variant against the
    other on the same inputs.  Raises on a build or launch error, and on
    the sparse variant of anything but an unweighted sum without
    ``seg_base``."""
    num_segments, emb_len = out.shape
    itemsize = table.element_size()
    lib = _build.library()
    if variant == "rows":
        tile = row_tile(emb_len, itemsize, aligned16(table, out))
        err = launch_on(out.device, lambda stream: lib.ember_sls(
            table.data_ptr(), ptrs.data_ptr(), idxs.data_ptr(),
            None if weights is None else weights.data_ptr(),
            None if seg_base is None else seg_base.data_ptr(),
            out.data_ptr(), num_segments, emb_len, DTYPES[table.dtype],
            ADD_OPS[add_op], MUL_OPS[mul_op], int(tile.elems > 1),
            tile.threads_per_row, tile.rows_per_block, stream))
    elif variant == "sparse":
        if weights is not None or seg_base is not None or add_op != "add":
            raise ValueError("the sparse SLS variant sums unweighted rows "
                             "without seg_base")
        lookups = idxs.numel()
        scratch = torch.empty(
            lib.ember_sls_sparse_scratch_bytes(num_segments, lookups),
            dtype=torch.uint8, device=out.device)
        err = launch_on(out.device, lambda stream: lib.ember_sls_sparse(
            table.data_ptr(), ptrs.data_ptr(), idxs.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), num_segments, emb_len,
            lookups, DTYPES[table.dtype], stream))
    else:
        raise ValueError(f"no sls variant {variant!r}")
    _build.check(err, f"ember_sls ({variant})")
    sls_cuda.launches += 1
    sls_cuda.variants[variant] += 1


sls_cuda.launches = 0
sls_cuda.variants = {"rows": 0, "sparse": 0}
