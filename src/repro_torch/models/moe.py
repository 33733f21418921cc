"""Mixture-of-Experts layer (counterpart of ``repro/models/moe.py``):
:func:`init_moe`, :func:`_slot_assignments`, :func:`moe_ffn_local`,
:func:`_replicated_token_ep` and :func:`moe_ffn`, on one device or expert
parallel over a mesh axis, plus :func:`dispatch_op` and
:func:`undispatch_program`, the dispatch as a characterized embedding
operation, and :func:`moe_ffn_ep_plain`, the n-rank semantics in one
process.

MoE dispatch *is* an embedding operation in the paper's taxonomy: tokens are
gathered into per-expert capacity buffers by irregular indices, and the
un-dispatch is a plain irregular gather over the (E·C, D) capacity buffer.
Here the un-dispatch ``out_buf[slot]`` runs through the block gather
(``kernels.ops.block_gather``: the hand-written Hopper kernel on CUDA
tensors, its plain version on the CPU).  The dispatch scatter has no Pallas
counterpart in the reference and stays a stock ``index_copy_``.

**Expert parallelism** (``moe_ffn(mesh=...)``, the reference's
``shard_map`` body): the experts split over the ``ep_axis`` (rank r holds
experts ``[r·E/n, (r+1)·E/n)`` of ``wi_gate``, ``wi_up``, ``wo``), the
router and the shared experts replicated.  The port is multi-controller:
every rank passes the same (B, S, D) activations and gets the full output
back.

* *Seq-split* (S divisible by n, the prefill): each rank routes its block
  of the sequence with the capacity of its own token count, and a tiled
  all-to-all carries the (E, C, D) dispatch buffer to the experts' owners
  and back -- the reference's ``moe_ffn_local(..., ep_axis=)``.  Capacity
  is per rank, so this is not the single device's function (other
  assignments drop): it is held to :func:`moe_ffn_ep_plain`.  The ranks'
  outputs are then all-gathered over S.
* *Replicated tokens* (decode): every rank routes every token, runs its
  experts, and the (E·C, D) output buffer comes together over the axis --
  the reference's ``_replicated_token_ep``, the single device's function.
  The reference sums the zero-filled buffers with a ``psum``; here each
  rank's block of experts is all-gathered, the same values at half the
  bytes.

``moe_ffn`` returns the rank's local ``aux``; :func:`mean_aux` averages it
over the axis and the data axes, as the reference's ``pmean``.  Every
collective goes through the axis's
:class:`~repro_torch.core.shard_plan.Collectives`.

**The backward** (expert-parallel training): each rank computes its share
of every gradient, and one fp32 sum over the axis, rounded once, makes it
whole -- nothing is summed twice.  The all-to-alls are their own
transpose, and the gather of the output blocks transposes to the rank's
block.  On the seq-split path the rank's share is its tokens: the FFN
input, the router and the shared experts enter the path together
(:meth:`~repro_torch.core.shard_plan.ModelAxis.enter_all`, one
all-reduce of their gradients), and the axis mean passes ``g / n`` to the
rank's own aux.  On the replicated-token path the rank's share is its
experts: only the dispatch buffer's cotangent is summed (the buffer enters
before the rank's slice of it); the router, the combine and the shared
experts ran whole on every rank, so their gradients are whole already, and
every rank's aux is the whole value already, so no mean runs over the
axis.  Over the data axes the mean's backward is the identity (the
trainer means the gradients there).

Capacity-based dropping keeps every shape static, and nothing reads back to
the host, so a layer can be captured in a CUDA graph (the served
micro-step, ``runtime.server.WaveGraph``; over a mesh only where the
collectives need no host staging).  The expert products run over **all**
of a rank's experts at capacity C, as the reference's three einsums do.
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


def moe_ffn_local(p, x2d: torch.Tensor, cfg: ModelConfig,
                  ep=None) -> tuple:
    """x2d (T, D) -> ((T, D), aux): :func:`route`, slot into capacity
    buffers, run every expert, gather back (``out_buf[slot]`` through the
    block gather), combine in x's dtype, add the shared experts.  ``aux``
    is the load-balance loss, E · sum_e frac_e · mean prob_e.

    With ``ep`` (a :class:`~repro_torch.core.shard_plan.ModelAxis`) this
    is one rank of the seq-split expert-parallel path: ``p`` holds the
    rank's experts, and the (E, C, D) buffer goes to their owners by a
    tiled all-to-all and comes back by the reverse one."""
    t, d = x2d.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    act = _ACTS[cfg.act]

    probs, topw, tope = route(x2d, p["router"], k)            # (T, k)
    aux = _aux(probs, tope, e)

    capacity = capacity_of(cfg, t)
    slot, keep = _slot_assignments(tope.reshape(-1), e, capacity)
    buf = _dispatch(x2d, slot, keep, k, e * capacity).view(e, capacity, d)

    if ep is not None:
        n = ep.size
        e_loc = e // n
        # tiled all-to-all: (E = n·E_loc, C, D) -> (E_loc, n·C, D)
        buf = ep.all_to_all(buf.view(n, e_loc, capacity, d))
        buf = buf.transpose(0, 1).reshape(e_loc, n * capacity, d)
    out_buf = _experts(p, buf, act)
    if ep is not None:
        # reverse tiled all-to-all: (E_loc, n·C, D) -> (E, C, D)
        out_buf = ep.all_to_all(
            out_buf.view(e_loc, n, capacity, d).transpose(0, 1))
    out = _combine(out_buf.reshape(e * capacity, d), slot, keep, topw, t, k)
    return _with_shared(p, x2d, out, act), aux


def _aux(probs: torch.Tensor, tope: torch.Tensor, e: int) -> torch.Tensor:
    """The load-balance loss: frac_e is the share of the T·k assignments
    routed to expert e."""
    experts = torch.arange(e, device=probs.device)
    frac = (tope[..., None] == experts).float().mean(dim=(0, 1))
    return e * torch.sum(frac * probs.mean(dim=0))


def _dispatch(x2d: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
              k: int, rows: int) -> torch.Tensor:
    """Each token's k copies into their slots of a (rows, D) buffer; the
    dropped assignments land in an extra last row, which is cut off."""
    t, d = x2d.shape
    src = x2d[:, None].expand(t, k, d).reshape(t * k, d)      # (T·k, D)
    buf = torch.zeros((rows + 1, d), dtype=x2d.dtype, device=x2d.device)
    buf.index_copy_(0, torch.where(keep, slot, rows), src)
    return buf[:rows]


def _experts(p, buf: torch.Tensor, act) -> torch.Tensor:
    """The experts' gated MLPs over (E, C, D) capacity buffers."""
    h = act(torch.bmm(buf, p["wi_gate"])) * torch.bmm(buf, p["wi_up"])
    return torch.bmm(h, p["wo"])


def _combine(out_buf: torch.Tensor, slot, keep, topw, t: int,
             k: int) -> torch.Tensor:
    """Un-dispatch (the block gather of each assignment's slot) and the
    top-k weighted sum in the buffer's dtype."""
    d = out_buf.shape[1]
    gathered = kops.block_gather(out_buf, slot.to(torch.int32))
    gathered = gathered.view(t * k, d)
    gathered = torch.where(keep[:, None], gathered, 0.0)
    return torch.sum(gathered.view(t, k, d) *
                     topw[..., None].to(out_buf.dtype), dim=1)


def _with_shared(p, x2d: torch.Tensor, out: torch.Tensor,
                 act) -> torch.Tensor:
    if "shared" not in p:
        return out
    sp = p["shared"]
    return out + (act(x2d @ sp["wi_gate"]) * (x2d @ sp["wi_up"])) @ sp["wo"]


def _replicated_token_ep(p, x2d: torch.Tensor, cfg: ModelConfig,
                         ep) -> tuple:
    """Decode-path expert parallelism: tokens too few to split over the
    axis.  Every rank routes all (replicated) tokens, fills the capacity
    buffer, runs only its own experts' block of it, and the blocks of
    every rank are gathered into the (E·C, D) output buffer (module
    docstring).  The single device's function."""
    t, d = x2d.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    act = _ACTS[cfg.act]
    e_loc = e // ep.size

    probs, topw, tope = route(x2d, p["router"], k)
    aux = _aux(probs, tope, e)
    capacity = capacity_of(cfg, t)
    slot, keep = _slot_assignments(tope.reshape(-1), e, capacity)
    # the rank runs only its experts' block: the buffer's gradient is
    # summed over the axis (the rest of the layer ran whole on every rank)
    buf = ep.enter(_dispatch(x2d, slot, keep, k, e * capacity))
    lo = ep.rank * e_loc * capacity
    my = buf[lo:lo + e_loc * capacity].view(e_loc, capacity, d)
    out_loc = _experts(p, my, act).reshape(e_loc * capacity, d)
    out_buf = ep.gather(out_loc, 0)                           # (E·C, D)
    out = _combine(out_buf, slot, keep, topw, t, k)
    return _with_shared(p, x2d, out, act), aux


def splits_sequence(s: int, n: int) -> bool:
    """Whether an expert-parallel axis of ``n`` takes a sequence of ``s``
    on the seq-split path (the reference's ``seq_split``)."""
    return s % n == 0 and s >= n


#: the shared experts' leaves, which every rank holds whole
SHARED = ("wi_gate", "wi_up", "wo")


def _enter_whole(p, x: torch.Tensor, ep) -> tuple:
    """The seq-split path's entry: ``x`` and the leaves every rank holds
    whole (the router, the shared experts) as this rank's share of the
    layer sees them -- their gradients, the rank's tokens' partials,
    summed over the axis in one fp32 all-reduce -- and ``p`` with them in
    place (the tensors themselves where autograd records nothing)."""
    whole = [x, p["router"]]
    if "shared" in p:
        whole += [p["shared"][k] for k in SHARED]
    got = ep.enter_all(whole)
    q = {k: p[k] for k in ("wi_gate", "wi_up", "wo")}
    q["router"] = got[1]
    if "shared" in p:
        q["shared"] = dict(zip(SHARED, got[2:]))
    return got[0], q


def mean_aux(aux: torch.Tensor, mesh, ep_axis: Optional[str],
             data_axes: tuple, s: int) -> torch.Tensor:
    """The local ``aux`` of a forward over ``s`` positions (what
    :func:`moe_ffn` returns on a rank) as the reference's ``pmean``s leave
    it: meaned over the expert-parallel axis on the seq-split path, whose
    ranks' values are their own tokens' (backward ``g / n``; on the
    replicated-token path every rank holds the whole value already), and
    over ``data_axes`` wider than 1 (backward the identity), at a 1-wide
    expert axis too."""
    from ..core.shard_plan import data_mean, model_axis, shard_count
    n = shard_count(mesh, ep_axis) if ep_axis is not None else 1
    if n > 1 and splits_sequence(s, n):
        aux = model_axis(mesh, ep_axis, aux.device).mean(aux)
    return data_mean(aux, [model_axis(mesh, a, aux.device)
                           for a in data_axes if shard_count(mesh, a) > 1])


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig, mesh=None,
            ep_axis: Optional[str] = "model") -> tuple:
    """x (B,S,D) -> ((B,S,D), aux).  With a ``mesh`` whose ``ep_axis`` is
    wider than 1: expert parallel (module docstring) -- seq-split where S
    divides by the axis size, replicated tokens otherwise -- and ``aux``
    this rank's local value, which :func:`mean_aux` means over the mesh
    (the LM does so once for the sum of its layers; a decode step
    discards it)."""
    from ..core.shard_plan import model_axis, shard_count
    b, s, d = x.shape
    n = shard_count(mesh, ep_axis) if ep_axis is not None else 1
    if n == 1:
        out, aux = moe_ffn_local(p, x.reshape(-1, d), cfg)
        out = out.reshape(b, s, d)
    elif cfg.num_experts % n:
        raise ValueError(f"{cfg.num_experts} experts do not split over "
                         f"the {ep_axis} axis of {n}")
    else:
        ep = model_axis(mesh, ep_axis, x.device)
        if splits_sequence(s, n):
            blk = s // n
            x, p = _enter_whole(p, x, ep)
            mine = x[:, ep.rank * blk:(ep.rank + 1) * blk].reshape(-1, d)
            out, aux = moe_ffn_local(p, mine, cfg, ep=ep)
            out = ep.gather(out.view(b, blk, d), 1)           # (B, S, D)
        else:
            out, aux = _replicated_token_ep(p, x.reshape(-1, d), cfg, ep)
            out = out.view(b, s, d)
    return out, aux


def moe_ffn_ep_plain(p, x: torch.Tensor, cfg: ModelConfig,
                     n: int) -> tuple:
    """The function :func:`moe_ffn` computes over an expert-parallel axis
    of ``n`` ranks, in one process on the full weights ``p``: where S
    divides by n, each rank's block of the sequence routed with its own
    capacity (the experts' owners change nothing but where the products
    run), the blocks joined and the aux losses averaged; otherwise the
    single device's :func:`moe_ffn_local`."""
    b, s, d = x.shape
    if not (s % n == 0 and s >= n):
        out, aux = moe_ffn_local(p, x.reshape(-1, d), cfg)
        return out.reshape(b, s, d), aux
    blk = s // n
    outs, auxs = [], []
    for r in range(n):
        out, aux = moe_ffn_local(
            p, x[:, r * blk:(r + 1) * blk].reshape(-1, d), cfg)
        outs.append(out.view(b, blk, d))
        auxs.append(aux)
    return torch.cat(outs, dim=1), torch.stack(auxs).mean()
