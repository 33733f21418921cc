"""DLC -> stock PyTorch ops: the "traditional core" baseline (counterpart of
``repro/core/backend_jax.py``).

This backend runs each embedding operation with one or two library calls,
what a machine without the DAE kernels runs: ``index_select`` for a gather
(``roff`` added on the device), ``F.embedding_bag`` for sum pooling (with
``per_sample_weights`` when the lookups are weighted by multiplication) and
for max pooling without weights, and ``index_add_`` / ``scatter_reduce_``
for the other semirings; FusedMM is a composition of stock ops.  It is
the executor's ``backend="torch"``, the counterpart of the reference's
``backend="jax"``; the hand-written kernels are ``backend="cuda"``.

Unlike the plain versions in :mod:`repro_torch.kernels.ref` (the kernels'
CPU twins), nothing here loops over lookups in an order of its own: the
library picks its own summation order, so on the card a CSR kind agrees
with ``backend="cuda"`` to rounding, and a gather bit for bit.

CSR inputs (``sls``, ``spmm``, ``fusedmm``) take ``idxs`` (and ``vals``) of
exactly ``ptrs[-1]`` lookups; the executor trims its capacity padding on
the host before the copy.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .ops import EmbeddingOp


def _dev(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """One operand on ``device`` in ``dtype`` (host arrays are copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device,
                                                        dtype=dtype)


def execute(op: EmbeddingOp, inputs: dict) -> torch.Tensor:
    """Run ``op`` on ``inputs`` with stock ops on the tables' device.

    ``inputs["table"]`` (``inputs["x"]`` for fusedmm) is a tensor; index
    streams may be tensors on its device or host arrays; ``roff`` (a fused
    multi-table unit's per-segment table base) is added to each lookup."""
    if op.kind == "fusedmm":
        x = inputs["x"]
        ptrs = _dev(_ptrs_of(op, inputs), x.device, torch.int64)
        return _fusedmm(x, ptrs, _dev(inputs["idxs"], x.device, torch.int64),
                        op.num_segments)
    table = inputs["table"]
    dev = table.device
    idxs = _dev(inputs["idxs"], dev, torch.int64)
    if op.kind == "gather":
        if "roff" in inputs:
            idxs = idxs + _dev(inputs["roff"], dev, torch.int64)
        r = op.block_rows
        if r != 1:
            idxs = (idxs[:, None] * r +
                    torch.arange(r, device=dev)[None, :]).reshape(-1)
        return torch.index_select(table, 0, idxs).reshape(
            -1, r, table.shape[1])
    sr = op.semiring
    if op.kind == "kg":
        # one lookup per segment: every add_op reduces a single term
        w = _dev(inputs["vals"], dev, table.dtype)
        if sr.mul == "mul":
            return F.embedding_bag(
                idxs, table, torch.arange(op.num_segments, device=dev),
                mode="sum", per_sample_weights=w)
        return (torch.index_select(table, 0, idxs) + w[:, None]).to(
            table.dtype)
    ptrs = _dev(_ptrs_of(op, inputs), dev, torch.int64)
    w = inputs.get("vals")
    w = None if w is None else _dev(w, dev, table.dtype)
    if "roff" in inputs:      # fused multi-table: rebase each lookup
        seg = _segment_ids(ptrs, op.num_segments, idxs.numel())
        idxs = idxs + _dev(inputs["roff"], dev, torch.int64)[seg]
    if sr.add == "add" and (w is None or sr.mul == "mul"):
        return F.embedding_bag(idxs, table, ptrs, mode="sum",
                               per_sample_weights=w,
                               include_last_offset=True)
    if sr.add == "max" and w is None:
        return F.embedding_bag(idxs, table, ptrs, mode="max",
                               include_last_offset=True)
    rows = torch.index_select(table, 0, idxs)
    if w is not None:
        rows = rows * w[:, None] if sr.mul == "mul" else rows + w[:, None]
    seg = _segment_ids(ptrs, op.num_segments, idxs.numel())
    out = torch.zeros((op.num_segments, table.shape[1]), dtype=rows.dtype,
                      device=dev)
    if sr.add == "add":
        out.index_add_(0, seg, rows)
    else:
        # include_self=False: segments no lookup reaches keep their 0
        out.scatter_reduce_(0, seg[:, None].expand_as(rows), rows,
                            reduce={"max": "amax", "min": "amin"}[sr.add],
                            include_self=False)
    return out.to(table.dtype)


def _segment_ids(ptrs: torch.Tensor, num_segments: int,
                 nnz: int) -> torch.Tensor:
    """The segment of each lookup, on the device (no host read)."""
    return torch.repeat_interleave(
        torch.arange(num_segments, device=ptrs.device), ptrs[1:] - ptrs[:-1],
        output_size=nnz)


def _fusedmm(x: torch.Tensor, ptrs: torch.Tensor, idxs: torch.Tensor,
             num_segments: int) -> torch.Tensor:
    """``out[i] = sum_p <x[i], x[idxs[p]]> x[idxs[p]]`` over segment i, in
    fp32, cast to x's dtype once."""
    seg = _segment_ids(ptrs, num_segments, idxs.numel())
    xf = x.float()
    xj = F.embedding(idxs, xf)
    s = torch.einsum("pe,pe->p", F.embedding(seg, xf), xj)
    out = torch.zeros((num_segments, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, seg, xj * s[:, None]).to(x.dtype)


def _ptrs_of(op: EmbeddingOp, inputs: dict):
    """CSR offsets from either index format (lengths -> cumulative sum)."""
    if op.index_format == "lengths" and "ptrs" not in inputs:
        lens = inputs["lens"]
        if isinstance(lens, torch.Tensor):
            return F.pad(torch.cumsum(lens.to(torch.int64), 0), (1, 0))
        ptrs = np.zeros(op.num_segments + 1, np.int64)
        np.cumsum(lens, out=ptrs[1:])
        return ptrs
    return inputs["ptrs"]
