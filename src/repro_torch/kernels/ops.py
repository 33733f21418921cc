"""Public kernel entry points, mirroring ``repro/kernels/ops.py``.

The reference picks Pallas interpret mode by backend (``default_interpret``);
here the tensors' device decides: CPU tensors run the plain versions
(:mod:`.ref`), CUDA tensors the hand-written Hopper kernels.
"""
from __future__ import annotations

from . import ref
from .flash_attention import flash_attention_cuda
from .fusedmm import fusedmm_cuda
from .gather import block_gather_cuda
from .sls import sls_cuda

#: the wrappers dispatch on the tensors' device themselves
sls = sls_cuda
block_gather = block_gather_cuda
fusedmm = fusedmm_cuda
attention = flash_attention_cuda

_WRAPPERS = {"sls": sls_cuda, "block_gather": block_gather_cuda,
             "fusedmm": fusedmm_cuda, "flash_attention": flash_attention_cuda}


def launch_counts() -> dict:
    """Kernel launches so far, by kernel."""
    return {name: w.launches for name, w in _WRAPPERS.items()}


def variant_launch_counts() -> dict:
    """Launches so far of each variant of the kernels that have variants
    (``block_gather``: bulk, its grouping pass, rows; ``fusedmm``: ring,
    rows)."""
    return {name: dict(w.variants) for name, w in _WRAPPERS.items()
            if hasattr(w, "variants")}


def reset_launch_counts() -> None:
    for w in _WRAPPERS.values():
        w.launches = 0
        for v in getattr(w, "variants", {}):
            w.variants[v] = 0


__all__ = ["sls", "block_gather", "fusedmm", "attention", "ref",
           "launch_counts", "variant_launch_counts", "reset_launch_counts"]
