"""FusedMM (SDDMM + SpMM, GNN message passing) on Hopper: the wrapper of
``ember_fusedmm`` (``csrc/ember_fusedmm.cu``), which replaces the TPU kernel
``fusedmm_pallas`` / ``_fusedmm_kernel`` of ``src/repro/kernels/fusedmm.py``.

The wrapper checks its arguments, allocates the output, and launches on the
current CUDA stream.  A call whose tensors lie on the CPU runs the plain
version (:func:`repro_torch.kernels.ref.fusedmm`) instead; a CUDA call
launches the kernel or raises -- nothing falls back.
``fusedmm_cuda.launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .sls import DTYPES, aligned16, check_index, check_table, one_device, \
    row_tile

FNS = {"identity": 0, "relu": 1}
#: 16-byte (or one-element) accesses one thread may hold of a row: the
#: kernel keeps the whole row x[i] in the registers of one group
MAX_VECS_PER_THREAD = 8


def fusedmm_cuda(x: torch.Tensor, ptrs: torch.Tensor, idxs: torch.Tensor, *,
                 num_segments: int, fn: str = "identity") -> torch.Tensor:
    """``out[i] = sum_{p in [ptrs[i], ptrs[i+1])} f(<x[i], x[idxs[p]]>) *
    x[idxs[p]]``, shape ``(num_segments, E)`` in x's dtype; an empty segment
    is 0.

    x (N, E) f32/bf16 with N >= num_segments; ptrs (num_segments+1,) int32;
    idxs (>= nnz,) int32 (entries past ``ptrs[-1]`` are never read).
    Indices are not bounds-checked here: the executor validates them on the
    host (``AccessPlan.harden_step``)."""
    check_table(x)
    check_index("ptrs", ptrs, num_segments + 1)
    check_index("idxs", idxs)
    if fn not in FNS:
        raise ValueError(f"unsupported fusedmm fn {fn!r}")
    if x.shape[0] < num_segments:
        raise ValueError(f"x has {x.shape[0]} rows, fewer than "
                         f"{num_segments} segments")
    dev = one_device(x, ptrs, idxs)
    if dev.type == "cpu":
        return ref.fusedmm(x, ptrs, idxs, num_segments=num_segments, fn=fn)
    emb_len = x.shape[1]
    out = torch.empty((num_segments, emb_len), dtype=x.dtype, device=dev)
    if num_segments == 0 or emb_len == 0:
        return out
    tile = row_tile(emb_len, x.element_size(), aligned16(x, out))
    vecs = -(-emb_len // tile.elems)
    if vecs > MAX_VECS_PER_THREAD * tile.threads_per_row:
        raise ValueError(f"fusedmm rows of {emb_len} elements are wider than "
                         f"the kernel holds ({MAX_VECS_PER_THREAD} accesses "
                         f"of {tile.elems} per thread, a warp per row)")
    with torch.cuda.device(dev):
        err = _build.library().ember_fusedmm(
            x.data_ptr(), ptrs.data_ptr(), idxs.data_ptr(), out.data_ptr(),
            num_segments, emb_len, DTYPES[x.dtype], FNS[fn],
            int(tile.elems > 1), tile.threads_per_row, tile.rows_per_block,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ember_fusedmm")
    fusedmm_cuda.launches += 1
    return out


fusedmm_cuda.launches = 0
