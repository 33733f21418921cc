"""FusedMM (SDDMM + SpMM, GNN message passing) on Hopper: the wrapper of
the kernels in ``csrc/ember_fusedmm.cu``, which replace the TPU kernel
``fusedmm_pallas`` / ``_fusedmm_kernel`` of ``src/repro/kernels/fusedmm.py``.

Two variants, chosen from the shapes by :func:`.sls.kernel_variant`:
``ring`` (``ember_fusedmm_ring``: one warp per output row, neighbour rows
loaded by ``cp.async.bulk`` into a per-warp ring of shared memory) for rows
of whole 16-byte units from :data:`.sls.FUSEDMM_RING_MIN_ROW_BYTES` up to
4 KB on 16-byte aligned x, else ``rows`` (``ember_fusedmm``: 16-byte or
single-element loads into registers), which is the faster on narrower
rows.

The wrapper checks its arguments, allocates the output, and launches on the
current CUDA stream.  A call whose tensors lie on the CPU runs the plain
version (:func:`repro_torch.kernels.ref.fusedmm`) instead; a CUDA call
launches the chosen variant or raises -- nothing falls back.
``fusedmm_cuda.launches`` counts the kernel launches,
``fusedmm_cuda.variants`` those of each variant.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .sls import (DTYPES, aligned16, check_index, check_table,
                  kernel_variant, one_device, row_tile)

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
    variant = kernel_variant("fusedmm", emb_len, x.element_size(),
                             aligned16(x, out))
    launch_variant(variant, x, ptrs, idxs, out, fn=fn)
    return out


def launch_variant(variant: str, x: torch.Tensor, ptrs: torch.Tensor,
                   idxs: torch.Tensor, out: torch.Tensor, *,
                   fn: str = "identity") -> None:
    """Launch FusedMM's ``variant`` ("ring" or "rows") into ``out``
    (num_segments, E) on the current stream, and count it.  The one launch
    path of :func:`fusedmm_cuda`, which has checked the arguments and
    chosen the variant; called directly only to run or time one variant
    against the other on the same inputs.  Raises on a build or launch
    error, or on rows wider than the rows variant holds."""
    num_segments, emb_len = out.shape
    itemsize = x.element_size()
    lib = _build.library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        if variant == "ring":
            err = lib.ember_fusedmm_ring(
                x.data_ptr(), ptrs.data_ptr(), idxs.data_ptr(),
                out.data_ptr(), num_segments, emb_len, DTYPES[x.dtype],
                FNS[fn], stream)
        elif variant == "rows":
            tile = row_tile(emb_len, itemsize, aligned16(x, out))
            vecs = -(-emb_len // tile.elems)
            if vecs > MAX_VECS_PER_THREAD * tile.threads_per_row:
                raise ValueError(
                    f"fusedmm rows of {emb_len} elements are wider than the "
                    f"kernel holds ({MAX_VECS_PER_THREAD} accesses of "
                    f"{tile.elems} per thread, a warp per row)")
            err = lib.ember_fusedmm(
                x.data_ptr(), ptrs.data_ptr(), idxs.data_ptr(),
                out.data_ptr(), num_segments, emb_len, DTYPES[x.dtype],
                FNS[fn], int(tile.elems > 1), tile.threads_per_row,
                tile.rows_per_block, stream)
        else:
            raise ValueError(f"no fusedmm variant {variant!r}")
    _build.check(err, f"ember_fusedmm ({variant})")
    fusedmm_cuda.launches += 1
    fusedmm_cuda.variants[variant] += 1


fusedmm_cuda.launches = 0
fusedmm_cuda.variants = {"ring": 0, "rows": 0}
