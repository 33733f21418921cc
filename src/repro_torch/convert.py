"""Carry the reference's state across to the port.

The reference hands program inputs around as ``{op name: {stream: array}}``
dicts whose tables are numpy (or JAX) arrays.  The port's input contract is
the same dict with tables as tensors on the executor's device and the
per-step index streams left as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.executor import resolve_device

TABLE_KEYS = ("table", "x")


def program_inputs_to_torch(inputs: dict, device=None) -> dict:
    """Move every table (``table`` / ``x``) of a reference program-inputs
    dict to ``device`` (the CUDA card unless ``device="cpu"``) once; leave
    the index streams as numpy.

    Aliasing is kept: a table object shared by several ops (a program's
    ``shared_tables`` slot) becomes ONE tensor, so the executor stacks it
    once and its identity check sees one source."""
    dev = resolve_device(device)
    moved: dict = {}          # id(source) -> (source, tensor)
    out: dict = {}
    for name, ins in inputs.items():
        new = {}
        for k, v in ins.items():
            if k in TABLE_KEYS:
                hit = moved.get(id(v))
                if hit is None:
                    hit = moved[id(v)] = (v, _to_tensor(v, dev))
                new[k] = hit[1]
            else:
                new[k] = np.asarray(v)
        out[name] = new
    return out


def _to_tensor(table, dev: torch.device) -> torch.Tensor:
    if isinstance(table, torch.Tensor):
        return table.to(dev).contiguous()
    return torch.tensor(np.ascontiguousarray(np.asarray(table)), device=dev)


def embed_tables_from_params(params: dict) -> dict:
    """The param-backed tables of the LM embedding program (counterpart of
    ``LM.embedding_table_inputs``), keyed the way
    :meth:`~repro_torch.core.executor.ProgramExecutor.update_tables` wants
    them.  Deliberately partial: the MoE capacity buffer is step data."""
    return {"tok_embed": {"table": params["embed"]},
            "label_gather": {"table": params["embed"]}}
