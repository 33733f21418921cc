"""Public kernel entry points, mirroring ``repro/kernels/ops.py``.

The reference picks Pallas interpret mode by backend (``default_interpret``);
here the tensors' device decides: CPU tensors run the plain versions
(:mod:`.ref`), CUDA tensors the hand-written Hopper kernels.
"""
from __future__ import annotations

from . import ref
from .flash_attention import (flash_attention, flash_attention_bwd_cuda,
                              flash_attention_cuda)
from .fusedmm import fusedmm_cuda
from .gather import (block_gather, block_gather_backward, block_gather_cuda,
                     transposed_lookups)
from .sls import sls_cuda

#: the wrappers dispatch on the tensors' device themselves; the gather and
#: attention go through their autograd Functions where a gradient is needed
sls = sls_cuda
fusedmm = fusedmm_cuda
attention = flash_attention

_WRAPPERS = {"sls": sls_cuda, "block_gather": block_gather_cuda,
             "fusedmm": fusedmm_cuda, "flash_attention": flash_attention_cuda}
#: the backward wrappers: the flash backward kernels, and the block
#: gather's gradient: its lookups' transposition and its ``ember_sls``
#: launch (which ``sls`` counts too)
_BACKWARD = {"flash_attention_bwd": flash_attention_bwd_cuda,
             "block_gather_bwd": block_gather_backward,
             "gather_transpose": transposed_lookups}


def launch_counts() -> dict:
    """Kernel launches so far, by kernel."""
    return {name: w.launches for name, w in _WRAPPERS.items()}


def backward_launch_counts() -> dict:
    """Launches so far of the backward wrappers, by wrapper."""
    return {name: w.launches for name, w in _BACKWARD.items()}


def variant_launch_counts() -> dict:
    """Launches so far of each variant of the kernels that have variants
    (``sls``: rows, sparse; ``block_gather``: bulk, its grouping pass,
    rows; ``fusedmm``: ring, rows; ``flash_attention_bwd``: wgmma,
    simt)."""
    return {name: dict(w.variants)
            for name, w in {**_WRAPPERS, **_BACKWARD}.items()
            if hasattr(w, "variants")}


def reset_launch_counts() -> None:
    for w in (*_WRAPPERS.values(), *_BACKWARD.values()):
        w.launches = 0
        for v in getattr(w, "variants", {}):
            w.variants[v] = 0
    flash_attention_cuda.instances.clear()
    flash_attention_bwd_cuda.instances.clear()


__all__ = ["sls", "block_gather", "fusedmm", "attention", "ref",
           "launch_counts", "backward_launch_counts", "variant_launch_counts",
           "reset_launch_counts"]
