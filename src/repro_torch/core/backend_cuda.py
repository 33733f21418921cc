"""DLC -> Hopper kernel launch (counterpart of ``repro/core/backend_pallas.py``).

The optimized DLC program is erased into a :class:`KernelPlan` that shapes
the launch of the hand-written CUDA kernels in :mod:`repro_torch.kernels`:

=====================  =====================================================
DLC/opt property        KernelPlan effect
=====================  =====================================================
row width + dtype       the row tile (``kernels.sls.row_tile``): 16-byte
                        vector accesses when the row allows them; threads
                        per row = the power of two covering the row's
                        accesses (at most a warp); rows per block fill a
                        256-thread block
store_streams           pure-copy kernel (block gather)
=====================  =====================================================

The reference floors the column tile at the TPU's 128 lanes and walks
column tiles without bufferization; on Hopper every lookup reads whole rows
with no lane floor, so every opt level (O0 included) launches the same
kernels.
``fusedmm`` has no Hopper kernel yet and raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels.sls import RowTile, row_tile
from .ops import EmbeddingOp
from .passes import fuse_index_inputs, split_outputs
from .pipeline import CompileResult, ProgramCompileResult, opt_level_index

_ITEMSIZE = {"float32": 4, "bfloat16": 2}


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    kind: str
    tile: RowTile           # launch shape on 16-byte aligned operands; the
                            # kernel wrapper derives it again from the
                            # tensors it is given (one element per access
                            # on an unaligned table)
    store_stream: bool      # pure-copy path
    num_tables: int = 1     # >1: batched multi-table plan (stacked table +
                            # per-segment base stream)

    @property
    def batched(self) -> bool:
        return self.num_tables > 1


def make_plan(res: CompileResult) -> KernelPlan:
    op = res.op
    opt = res.opt
    return KernelPlan(
        kind=op.kind,
        tile=row_tile(op.emb_len, _ITEMSIZE[op.dtype]),
        store_stream=bool(opt.get("store_streams")),
        num_tables=op.num_tables,
    )


def _dev(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """One per-call operand on ``device``: a tensor must already be there in
    ``dtype``; a host array is converted and copied."""
    if isinstance(x, torch.Tensor):
        if x.device != device or x.dtype != dtype:
            raise ValueError(f"operand is {x.dtype} on {x.device}, expected "
                             f"{dtype} on {device}")
        return x
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device,
                                                        dtype=dtype)


def execute(res: CompileResult, inputs: dict) -> torch.Tensor:
    """Run the compiled op through the Hopper kernels.

    ``inputs["table"]`` is a tensor whose device picks the path (CUDA: the
    kernels; CPU: their plain versions); index streams may be tensors on
    that device or host arrays."""
    op = res.op
    plan = make_plan(res)
    if op.kind == "fusedmm":
        raise NotImplementedError(
            "fusedmm has no Hopper kernel yet (ROADMAP.md, Queue 2 item 1: "
            "kernels/fusedmm.py fusedmm_pallas)")
    table = inputs["table"]
    dev = table.device
    i32 = torch.int32
    if op.kind == "gather":
        assert plan.store_stream or opt_level_index(res.opt_level) < 3
        roff = None
        if plan.batched and "roff" in inputs:
            roff = _dev(inputs["roff"], dev, i32)
        return kops.block_gather(table, _dev(inputs["idxs"], dev, i32),
                                 block_rows=op.block_rows, roff=roff)
    if op.kind == "kg":
        # one lookup per segment, one weight per segment: weight index p
        ptrs = torch.arange(op.num_segments + 1, dtype=i32, device=dev)
        w = inputs["vals"]
    else:
        ptrs = _dev(_ptrs_of(op, inputs), dev, i32)
        w = inputs.get("vals")
    seg_base = None
    if plan.batched and "roff" in inputs:
        seg_base = _dev(inputs["roff"], dev, i32)
    return kops.sls(table, ptrs, _dev(inputs["idxs"], dev, i32),
                    None if w is None else _dev(w, dev, table.dtype),
                    num_segments=op.num_segments, add_op=op.semiring.add,
                    mul_op=op.semiring.mul, seg_base=seg_base)


def stack_tables(unit, inputs: dict) -> torch.Tensor:
    """Row-stack a fused unit's member tables (one per table slot, in the
    AccessPlan's slot order) on their device."""
    parts = [inputs[n]["table"] for n in unit.result.access_plan
             .slot_first_member]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def execute_program(pres: ProgramCompileResult, inputs: dict) -> dict:
    """Run a compiled program once (no marshaling cache).

    ``inputs`` maps op name -> that op's inputs: tables as tensors (their
    device picks the path), index streams as host arrays.  A fused unit
    stacks its tables and runs ONE kernel launch over the stacked table,
    then splits the output rows back per member op."""
    outs: dict = {}
    for unit in pres.units:
        if unit.group is None:
            outs[unit.names[0]] = execute(unit.result, inputs[unit.names[0]])
        else:
            fused = fuse_index_inputs(unit.group, inputs)
            fused["table"] = stack_tables(unit, inputs)
            outs.update(split_outputs(unit.group,
                                      execute(unit.result, fused)))
    return outs


def _ptrs_of(op: EmbeddingOp, inputs: dict):
    """CSR offsets from either index format (lengths -> cumulative sum).
    Tensors pass through untouched."""
    if op.index_format == "lengths" and "ptrs" not in inputs:
        ptrs = np.zeros(op.num_segments + 1, np.int32)
        np.cumsum(inputs["lens"], out=ptrs[1:])
        return ptrs
    ptrs = inputs["ptrs"]
    return ptrs if isinstance(ptrs, torch.Tensor) else np.asarray(ptrs)
