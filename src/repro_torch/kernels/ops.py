"""Public kernel entry points, mirroring ``repro/kernels/ops.py``.

The reference picks Pallas interpret mode by backend (``default_interpret``);
here the tensors' device decides: CPU tensors run the plain versions
(:mod:`.ref`), CUDA tensors the hand-written Hopper kernels.
"""
from __future__ import annotations

from . import ref
from .gather import block_gather_cuda
from .sls import sls_cuda


#: the wrappers dispatch on the tensors' device themselves
sls = sls_cuda
block_gather = block_gather_cuda


def launch_counts() -> dict:
    """Kernel launches so far, by kernel."""
    return {"sls": sls_cuda.launches,
            "block_gather": block_gather_cuda.launches}


def reset_launch_counts() -> None:
    sls_cuda.launches = 0
    block_gather_cuda.launches = 0


__all__ = ["sls", "block_gather", "ref", "launch_counts",
           "reset_launch_counts"]
