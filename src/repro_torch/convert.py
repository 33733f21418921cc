"""Carry the reference's state across to the port.

The reference hands program inputs around as ``{op name: {stream: array}}``
dicts whose tables are numpy (or JAX) arrays.  The port's input contract is
the same dict with tables as tensors on the executor's device and the
per-step index streams left as numpy arrays.

An LM's parameters are a pytree in the reference (per-layer leaves stacked
over the scanned super-blocks under ``scan``, the remainder layers under
``rest``) and a flat ``state_dict`` of :class:`repro_torch.models.lm.LM`
here: :func:`lm_params_from_reference` maps one onto the other, nested
names included (MLA's ``attn.{wq,w_dkv,w_uk,w_uv,w_kr,wo}``, the MoE
layers' ``moe.{router,wi_gate,wi_up,wo,shared.{wi_gate,wi_up,wo}}``, each
leaf in its own dtype: the router stays fp32).  Its decode caches are the
same kind of tree there and a list of per-layer dicts here:
:func:`caches_from_reference` and :func:`caches_to_reference` map both ways
(MLA's latent ``{c, kr, len}`` keep the reference's layout).
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
    arr = np.ascontiguousarray(np.asarray(table))
    if arr.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(dev)
    return torch.tensor(arr, device=dev)


def lm_params_from_reference(params: dict, cfg, device=None) -> dict:
    """The reference's LM parameter pytree (numpy arrays, or anything
    ``np.asarray`` takes) as a ``state_dict`` for
    :class:`repro_torch.models.lm.LM` on ``device`` (the CUDA card unless
    ``device="cpu"``), in the reference's dtype.

    Layer ``n * len(pattern) + i`` is slot ``i`` of super-block ``n`` in
    ``params["scan"]`` (leaves stacked over ``cfg.n_super``); the
    remainder layers follow from ``params["rest"]``."""
    dev = resolve_device(device)
    state = {"embed": _to_tensor(params["embed"], dev),
             "final_norm": _to_tensor(params["final_norm"], dev)}
    for li, layer in enumerate(_layers_of(params, cfg)):
        for key, val in _flatten(layer):
            state[f"blocks.{li}.{key}"] = _to_tensor(val, dev)
    return state


def _tree_index(tree, n: int):
    if isinstance(tree, dict):
        return {k: _tree_index(v, n) for k, v in tree.items()}
    return np.asarray(tree)[n]


def _flatten(tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def embed_tables_from_params(params: dict) -> dict:
    """The param-backed tables of the LM embedding program (counterpart of
    ``LM.embedding_table_inputs``), keyed the way
    :meth:`~repro_torch.core.executor.ProgramExecutor.update_tables` wants
    them.  Deliberately partial: the MoE capacity buffer is step data."""
    return {"tok_embed": {"table": params["embed"]},
            "label_gather": {"table": params["embed"]}}


#: cache leaves stored head-major here, (B, Smax, Hkv, ...) in the reference
_SEQ_MAJOR_LEAVES = ("k", "v", "k_scale", "v_scale")


def _layers_of(tree: dict, cfg) -> list:
    """The reference's ``{"scan": stacked over n_super, "rest": (...)}``
    tree as one entry per layer, in layer order."""
    layers = []
    pattern = tuple(cfg.block_pattern)
    for n in range(cfg.n_super):
        for i in range(len(pattern)):
            layers.append(_tree_index(tree["scan"][i], n))
    layers.extend(tree.get("rest", ()))
    return layers


def caches_from_reference(tree: dict, cfg, device=None) -> list:
    """The reference's decode caches (``LM.init_caches`` /
    ``decode_step`` output, leaves as numpy arrays or anything
    ``np.asarray`` takes) as the port's list of per-layer cache dicts on
    ``device``: ``k``/``v`` (B, Smax, Hkv, hd) -> (B, Hkv, Smax, hd),
    ``k_scale``/``v_scale`` (B, Smax, Hkv) -> (B, Hkv, Smax); ``len`` and
    an MLA layer's ``c`` (B, Smax, r) and ``kr`` (B, Smax, rd) as they
    are."""
    dev = resolve_device(device)
    out = []
    for layer in _layers_of(tree, cfg):
        cache = {}
        for key, val in layer.items():
            t = _to_tensor(np.asarray(val), dev)
            if key in _SEQ_MAJOR_LEAVES:
                t = t.transpose(1, 2).contiguous()
            cache[key] = t
        out.append(cache)
    return out


def caches_to_reference(caches: list, cfg) -> dict:
    """The port's per-layer caches as the reference's tree of numpy arrays
    (``{"scan": tuple over the pattern of dicts stacked over n_super,
    "rest": tuple}``), to compare leaf by leaf."""
    def host(key, t):
        if key in _SEQ_MAJOR_LEAVES:
            t = t.transpose(1, 2)
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy()
        return t.numpy()

    layers = [{k: host(k, t) for k, t in c.items()} for c in caches]
    pattern = tuple(cfg.block_pattern)
    n_scan = cfg.n_super * len(pattern)
    scan = ()
    if cfg.n_super:
        scan = tuple(
            {k: np.stack([layers[n * len(pattern) + i][k]
                          for n in range(cfg.n_super)])
             for k in layers[i]}
            for i in range(len(pattern)))
    return {"scan": scan, "rest": tuple(layers[n_scan:])}
