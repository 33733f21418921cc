"""Mixture-of-Experts layer (counterpart of ``repro/models/moe.py``), single
device: :func:`init_moe`, :func:`_slot_assignments`, :func:`moe_ffn_local`
and :func:`moe_ffn` without a mesh, plus :func:`dispatch_op` and
:func:`undispatch_program`, the dispatch as a characterized embedding
operation.  The expert-parallel paths (``moe_ffn(mesh=...)``, the
reference's ``_replicated_token_ep`` and its ``shard_map`` body) wait for
ROADMAP.md Queue 1 item 6 and raise.

MoE dispatch *is* an embedding operation in the paper's taxonomy: tokens are
gathered into per-expert capacity buffers by irregular indices, and the
un-dispatch is a plain irregular gather over the (E·C, D) capacity buffer.
Here the un-dispatch ``out_buf[slot]`` runs through the block gather
(``kernels.ops.block_gather``: the hand-written Hopper kernel on CUDA
tensors, its plain version on the CPU).  The dispatch scatter has no Pallas
counterpart in the reference and stays a stock ``index_copy_``.

Capacity-based dropping keeps every shape static, and nothing reads back to
the host, so a layer can be captured in a CUDA graph (the served
micro-step, ``runtime.server.WaveGraph``).  The expert products run over
**all** E experts at capacity C, as the reference's three einsums do.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.ops import EmbeddingOp, EmbeddingProgram
from ..kernels import ops as kops
from .common import _ACTS, ModelConfig, dense_init


def dispatch_op(cfg: ModelConfig, tokens: int) -> EmbeddingOp:
    """The EP dispatch as a characterized embedding operation: a gather of
    ``tokens · top-k`` rows over the (E·C, D) capacity buffer."""
    e, k = cfg.num_experts, max(cfg.experts_per_tok, 1)
    return EmbeddingOp("gather", num_segments=tokens * k,
                       num_embeddings=e * capacity_of(cfg, tokens),
                       emb_len=cfg.d_model)


def undispatch_program(cfg: ModelConfig, tokens: int, name=None):
    """The MoE un-dispatch as a standalone one-op
    :class:`~repro_torch.core.ops.EmbeddingProgram`: the second member of
    the serving pipeline group (:meth:`~repro_torch.models.lm.LM.
    embedding_pipeline`)."""
    return EmbeddingProgram(name or f"{cfg.name}-moe-undispatch",
                            (("moe_undispatch", dispatch_op(cfg, tokens)),))


def capacity_of(cfg: ModelConfig, tokens: int) -> int:
    """Expert capacity C for ``tokens`` routed tokens:
    ``int(T·k/E·capacity_factor) + 1``, as the reference computes it."""
    e, k = cfg.num_experts, max(cfg.experts_per_tok, 1)
    return int(tokens * k / e * cfg.capacity_factor) + 1


def init_moe(gen: Optional[torch.Generator], cfg: ModelConfig,
             dtype: torch.dtype, device=None) -> dict:
    """The router (D, E) in fp32, the experts' ``wi_gate`` / ``wi_up`` (E, D,
    F) and ``wo`` (E, F, D), and, with shared experts, a dense gated MLP of
    width F · num_shared_experts under ``shared``."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    p = {
        "router": dense_init(gen, (d, e), torch.float32, device),
        "wi_gate": dense_init(gen, (e, d, f), dtype, device),
        "wi_up": dense_init(gen, (e, d, f), dtype, device),
        "wo": dense_init(gen, (e, f, d), dtype, device),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {
            "wi_gate": dense_init(gen, (d, fs), dtype, device),
            "wi_up": dense_init(gen, (d, fs), dtype, device),
            "wo": dense_init(gen, (fs, d), dtype, device),
        }
    return p


def _slot_assignments(expert_ids: torch.Tensor, num_experts: int,
                      capacity: int) -> tuple:
    """Sort-based capacity slotting: expert_ids (N,) -> (slot (N,) int64,
    keep (N,) bool), slot in [0, E·C).  The n-th assignment (in order) to
    expert e takes slot ``e·C + n`` and is kept while n < C; later ones are
    clamped to the expert's last slot and dropped."""
    n = expert_ids.shape[0]
    ids = expert_ids.to(torch.int64)
    order = torch.argsort(ids, stable=True)
    sorted_e = ids[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(num_experts, device=ids.device))
    pos = torch.arange(n, device=ids.device) - starts[sorted_e]
    keep_sorted = pos < capacity
    slot_sorted = sorted_e * capacity + pos.clamp(max=capacity - 1)
    # un-sort back to assignment order
    inv = torch.argsort(order)
    return slot_sorted[inv], keep_sorted[inv]


def route(x2d: torch.Tensor, router: torch.Tensor, k: int) -> tuple:
    """The router: fp32 logits ``x2d @ router``, softmax, top-k, the k
    weights renormalised with their sum clamped at 1e-9 -> (probs (T, E)
    fp32, topw (T, k), tope (T, k) expert ids)."""
    probs = torch.softmax(x2d.float() @ router, dim=-1)
    topw, tope = torch.topk(probs, k, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, topw, tope


def moe_ffn_local(p, x2d: torch.Tensor, cfg: ModelConfig) -> tuple:
    """x2d (T, D) -> ((T, D), aux) on one device: :func:`route`, slot into
    capacity buffers, run every expert, gather back (``out_buf[slot]``
    through the block gather), combine in x's dtype, add the shared
    experts.  ``aux`` is the load-balance loss, E · sum_e frac_e · mean
    prob_e."""
    t, d = x2d.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    act = _ACTS[cfg.act]

    probs, topw, tope = route(x2d, p["router"], k)            # (T, k)

    # aux load-balance loss: frac_e is the share of the T·k assignments
    experts = torch.arange(e, device=x2d.device)
    frac = (tope[..., None] == experts).float().mean(dim=(0, 1))
    aux = e * torch.sum(frac * probs.mean(dim=0))

    capacity = capacity_of(cfg, t)
    slot, keep = _slot_assignments(tope.reshape(-1), e, capacity)

    # dispatch: row slot of the (E·C + 1, D) buffer; dropped assignments
    # land in the last row, which is cut off
    src = x2d[:, None].expand(t, k, d).reshape(t * k, d)      # (T·k, D)
    buf = torch.zeros((e * capacity + 1, d), dtype=x2d.dtype,
                      device=x2d.device)
    buf.index_copy_(0, torch.where(keep, slot, e * capacity), src)
    buf = buf[:e * capacity].view(e, capacity, d)

    h = act(torch.bmm(buf, p["wi_gate"])) * torch.bmm(buf, p["wi_up"])
    out_buf = torch.bmm(h, p["wo"]).view(e * capacity, d)

    # un-dispatch: the block gather of each assignment's slot
    gathered = kops.block_gather(out_buf, slot.to(torch.int32))
    gathered = gathered.view(t * k, d)
    gathered = torch.where(keep[:, None], gathered, 0.0)
    out = torch.sum(gathered.view(t, k, d) * topw[..., None].to(x2d.dtype),
                    dim=1)

    if "shared" in p:
        sp = p["shared"]
        out = out + (act(x2d @ sp["wi_gate"]) * (x2d @ sp["wi_up"])) \
            @ sp["wo"]
    return out, aux


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig, mesh=None) -> tuple:
    """x (B,S,D) -> ((B,S,D), aux), single device.  ``mesh`` (the
    reference's expert-parallel ``shard_map`` dispatch) raises: ROADMAP.md
    Queue 1 item 6."""
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE dispatch (moe_ffn(mesh=...)) is not ported "
            "yet (ROADMAP.md, Queue 1 item 6)")
    b, s, d = x.shape
    out, aux = moe_ffn_local(p, x.reshape(-1, d), cfg)
    return out.reshape(b, s, d), aux
