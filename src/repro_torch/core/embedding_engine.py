"""The model-facing embedding lookup and program (counterpart of
``repro/core/embedding_engine.py``; ported so far: :func:`lookup` with the
single-device strategies ``take``, ``one_hot`` and ``pallas`` and the
vocab-sharded ones ``masked_psum``, ``masked_psum_scatter`` and ``one_hot``
over a mesh, :func:`choose_strategy`, :func:`logits` (differentiable),
:func:`model_embedding_program` and :func:`xent_vocab_parallel`, on one
device and over a mesh: :class:`VocabParallelXent`).

Over a mesh the port is multi-controller: each rank passes its own vocab
rows of the table (``(V/n, D)``, rank r holding rows ``[r·V/n,
(r+1)·V/n)``) and the same ids, and gets the full lookup back.  The
masked lookup is Ember's decomposition at cluster scale: the ids shifted
to the rank's rows with the others masked (the *access*, a local gather
through the hand-written block gather, ``kernels.ops.block_gather``), then
a sum over the vocab axis (the *combine*: an all-reduce, or a
reduce-scatter over the sequence).  Every row has one owner and the others
add exact zeros, so the result is the single-device ``index_select``'s
bits.  Under autograd the combine's backward is the identity (the sum is
replicated), and the block gather's backward (the transposition and the
sparse ``ember_sls`` on the card) sums the cotangent into the rank's rows;
a masked id's cotangent is an exact zero, so the row it is clamped to
gains nothing from it."""
from __future__ import annotations

from typing import Optional

import torch

from .ops import EmbeddingOp, EmbeddingProgram, single_op_program

SHARDED_STRATEGIES = ("masked_psum", "masked_psum_scatter")


def choose_strategy(vocab_size: int, sharded: bool) -> str:
    """The reference's pick: ``take`` on one device, ``one_hot`` for a
    sharded vocab of at most 1024 rows, ``masked_psum`` above."""
    if not sharded:
        return "take"
    if vocab_size <= 1024:
        return "one_hot"
    return "masked_psum"


def lookup(table: torch.Tensor, ids: torch.Tensor, *, mesh=None,
           vocab_axis: Optional[str] = None, strategy: str = "take",
           data_axes: tuple = (), seq_scatter: bool = False) -> torch.Tensor:
    """Embed ``ids (..., S)`` from ``table (V, D)`` -> ``(..., S, D)``.

    With a ``mesh`` whose ``vocab_axis`` is wider than 1, ``table`` is this
    rank's vocab rows (module docstring) and ``strategy`` one of
    ``masked_psum`` (the full ``(..., S, D)`` on every rank),
    ``masked_psum_scatter`` (or ``seq_scatter``: rank r keeps block r of
    the S dim, ``(..., S/n, D)``) or ``one_hot`` (a one-hot product over
    the local rows, then the sum).  ``data_axes`` name the axes the batch
    is split over; each data group passes its own rows, and the lookup
    needs nothing across them.

    ``take``: ``index_select``; where grad mode is on and the table needs
    a gradient, through :class:`Take`, whose backward is deterministic.
    ``one_hot``: a one-hot product (an id
    outside the table gives a zero row, as ``jax.nn.one_hot`` does).
    ``pallas``: the single-device DAE lookup -- the one-gather program
    compiled by emberc (compile-cache backed) and run through
    :mod:`.backend_cuda`: the hand-written block gather on the card, its
    plain version on the CPU."""
    if mesh is not None and vocab_axis is not None:
        from .shard_plan import model_axis, shard_count
        if shard_count(mesh, vocab_axis) > 1:
            if strategy not in SHARDED_STRATEGIES + ("one_hot",):
                raise ValueError(f"strategy {strategy!r} does not take a "
                                 f"vocab-sharded table")
            return _masked_lookup(table, ids,
                                  model_axis(mesh, vocab_axis, table.device),
                                  strategy,
                                  seq_scatter or strategy.endswith("scatter"))
        if strategy in SHARDED_STRATEGIES:   # one shard holds every row
            strategy = "take"
    if strategy == "take":
        flat = ids.reshape(-1)
        if torch.is_grad_enabled() and table.requires_grad:
            rows = Take.apply(table, flat)
        else:
            rows = table.index_select(0, flat)
        return rows.reshape(*ids.shape, table.shape[1])
    if strategy == "one_hot":
        rows = torch.arange(table.shape[0], device=ids.device)
        return (ids[..., None] == rows).to(table.dtype) @ table
    if strategy == "pallas":
        return _dae_lookup(table, ids)
    if strategy in SHARDED_STRATEGIES:
        raise ValueError(f"lookup strategy {strategy!r} needs a mesh and "
                         f"its vocab axis")
    raise ValueError(strategy)


def _masked_lookup(table: torch.Tensor, ids: torch.Tensor, axis,
                   strategy: str, seq_scatter: bool) -> torch.Tensor:
    """The rank's part of a vocab-sharded lookup over ``axis`` (a
    :class:`~repro_torch.core.shard_plan.ModelAxis`): the ids shifted to
    its rows, the others masked to zero rows, then the combine."""
    v_local = table.shape[0]
    local = ids.to(torch.int64) - axis.rank * v_local
    in_range = (local >= 0) & (local < v_local)
    if strategy == "one_hot":
        rows = torch.arange(v_local, device=ids.device)
        emb = (local[..., None] == rows).to(table.dtype) @ table
    else:
        from ..kernels import ops as kops
        idx = local.clamp(0, v_local - 1).reshape(-1).to(torch.int32)
        emb = kops.block_gather(table, idx).view(*ids.shape, table.shape[1])
        emb = torch.where(in_range[..., None], emb, 0.0).to(table.dtype)
    if seq_scatter:
        return axis.scatter(emb, emb.dim() - 2)
    return axis.sum(emb)


class Take(torch.autograd.Function):
    """``index_select`` of rows with a deterministic gradient.  The stock
    backward sums the cotangents of repeated ids with atomics on the card,
    so two runs of one training differ in their bits; this one is the
    block gather's (:func:`repro_torch.kernels.gather.block_gather_backward`:
    the lookups transposed into CSR by a stable sort, each row's segment
    summed in fp32 in that order by one ``ember_sls`` launch, rounded to
    the table's dtype once; ``index_add_`` in fp32 on the CPU).  The
    forward is ``index_select``'s bits.  table (V, D), ids (N,) int ->
    (N, D)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, dout):
        from ..kernels.gather import block_gather_backward
        (ids,) = ctx.saved_tensors
        grad = block_gather_backward(dout.contiguous()[:, None],
                                     ids.to(torch.int32), ctx.num_rows)
        return grad, None


def _dae_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single-device DAE path: compile (cached) + run the gather kernel."""
    from . import backend_cuda
    from .pipeline import compile_program
    op = EmbeddingOp("gather", num_segments=ids.numel(),
                     num_embeddings=int(table.shape[0]),
                     emb_len=int(table.shape[1]))
    pres = compile_program(single_op_program(op, "lookup"), "O3")
    out = backend_cuda.execute(pres.units[0].result, {
        "table": table, "idxs": ids.reshape(-1).to(torch.int32)})
    return out.reshape(*ids.shape, table.shape[1])


def model_embedding_program(*, vocab_size: int, d_model: int, tokens: int,
                            extra_ops: tuple = (),
                            name: str = "model-step") -> EmbeddingProgram:
    """The irregular-lookup program of one model step.

    Token embedding and the label-logit gather of the vocab-parallel cross
    entropy both read the embed table -- annotated as a shared table so the
    fusion pass stacks it once; ``extra_ops`` appends model-specific lookups
    (e.g. :func:`repro_torch.models.moe.dispatch_op`).
    """
    ops = (("tok_embed",
            EmbeddingOp("gather", num_segments=tokens,
                        num_embeddings=vocab_size, emb_len=d_model)),
           ("label_gather",
            EmbeddingOp("gather", num_segments=tokens,
                        num_embeddings=vocab_size, emb_len=d_model)))
    return EmbeddingProgram(name, ops + tuple(extra_ops),
                            shared_tables=(("tok_embed", "label_gather"),))


def logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x (..., D) @ table.T (D, V) -> (..., V) in fp32: exact products of
    the operands summed in fp32 (the reference's ``dot_general`` with
    ``preferred_element_type=float32``); bf16 on the card through cuBLAS's
    bf16 x bf16 -> fp32 GEMM, differentiable through :class:`Bf16Logits`
    (meta tensors take the card's path: the dry run counts it)."""
    x2 = x.reshape(1, -1, x.shape[-1])
    if x.device.type in ("cuda", "meta") and \
            x.dtype == table.dtype == torch.bfloat16:
        if torch.is_grad_enabled() and (x.requires_grad or
                                        table.requires_grad):
            out = Bf16Logits.apply(x2, table)
        else:
            out = torch.bmm(x2, table.t()[None], out_dtype=torch.float32)
    else:
        out = torch.bmm(x2.float(), table.t()[None].float())
    return out.view(*x.shape[:-1], table.shape[0])


class Bf16Logits(torch.autograd.Function):
    """The bf16 x bf16 -> fp32 logits product with its transpose written
    out, as JAX transposes a ``dot_general`` with
    ``preferred_element_type=float32``: the fp32 cotangent against the other
    operand in fp32, the result cast to the operand's dtype --
    ``dx = (dl @ table).to(bf16)``, ``dtable = (dl^T @ x).to(bf16)``.
    (Autograd's own formula for ``bmm(..., out_dtype=)`` is not relied on.)
    x2 (1, N, D), table (V, D) -> (1, N, V) fp32."""

    @staticmethod
    def forward(ctx, x2, table):
        ctx.save_for_backward(x2, table)
        return torch.bmm(x2, table.t()[None], out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dl):
        x2, table = ctx.saved_tensors
        dl = dl[0].float()                                   # (N, V)
        dx = dtable = None
        if ctx.needs_input_grad[0]:
            dx = (dl @ table.float()).to(x2.dtype)[None]
        if ctx.needs_input_grad[1]:
            dtable = (dl.t() @ x2[0].float()).to(table.dtype)
        return dx, dtable


def cross_entropy(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over tokens of ``logsumexp(lg) - lg[label]``, fp32 logits
    (..., V) over the whole (padded) vocab, as the reference's single-device
    loss computes it."""
    picked = torch.gather(lg, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(torch.logsumexp(lg, -1) - picked)


def xent_vocab_parallel(x: torch.Tensor, table: torch.Tensor,
                        labels: torch.Tensor, *, mesh=None,
                        vocab_axis: Optional[str] = None,
                        data_axes: tuple = ()) -> torch.Tensor:
    """Unembed + softmax cross entropy: the mean loss over every token.

    On one device (``mesh=None``): the fp32 logits of :func:`logits` and
    :func:`cross_entropy`, what the reference's ``shard_map`` body computes
    on one shard.  Over a mesh whose ``vocab_axis`` is wider than 1,
    ``table`` is this rank's vocab rows and ``x`` / ``labels`` the rank's
    data block (the same on every rank of the vocab axis):
    :class:`VocabParallelXent`, the reference's function (the rank's fp32
    logits, the max all-reduced with *max* outside the gradient, Σexp
    all-reduced with *sum*, the label logit from the rank that owns the
    label, the mean over the local tokens), never a ``(tokens, V)``
    tensor.  A 1-wide vocab axis takes the single-device function.  Then
    the mean over ``data_axes`` (:func:`~.shard_plan.data_mean`: each
    rank's gradient is its own tokens' mean's; the data-parallel mean of
    the gradients completes it)."""
    if mesh is None:
        return cross_entropy(logits(x, table), labels)
    from .shard_plan import data_mean, model_axis, shard_count
    if vocab_axis is not None and shard_count(mesh, vocab_axis) > 1:
        loss = VocabParallelXent.apply(
            x.reshape(-1, x.shape[-1]), table, labels.reshape(-1),
            model_axis(mesh, vocab_axis, table.device))
    else:
        loss = cross_entropy(logits(x, table), labels)
    return data_mean(loss, [model_axis(mesh, a, table.device)
                            for a in data_axes if shard_count(mesh, a) > 1])


class VocabParallelXent(torch.autograd.Function):
    """The vocab-parallel cross entropy over a model axis (Megatron's),
    with its backward written out.  x2 (N, D) replicated over the axis,
    table (V_r, D) the rank's vocab rows ``[r·V_r, (r+1)·V_r)``, labels
    (N,) global ids -> the mean over the N tokens of ``lse - lg[label]``,
    a () fp32 tensor equal on every rank.

    Forward, in the reference's order: ``lg`` the rank's fp32 logits
    (:func:`logits`' products), ``m`` their row max all-reduced with
    *max* (a constant shift: no gradient reaches it), ``se`` the row sums
    of ``e = exp(lg - m)`` all-reduced, ``lse = m + log(se)``, the label
    logit picked on the rank that owns it (the others add exact zeros)
    and summed over the axis.  Backward: ``dl = g/N · (e / se -
    onehot_r)`` on the rank's columns; ``dx = dl @ table_r`` is the rank's
    partial, summed over the axis in fp32 and rounded once (the entry of
    a column-parallel product, :meth:`~.shard_plan.ModelAxis.sum_grad`);
    ``dtable_r = dl^T @ x``, in fp32, rounded once -- as
    :class:`Bf16Logits` transposes the single device's product.  The
    padded vocab's pad rows stay in the softmax, as in the reference."""

    @staticmethod
    def forward(ctx, x2, table, labels, axis):
        v_local = table.shape[0]
        lg = logits(x2, table)                              # (N, V_r) fp32
        local = labels.to(torch.int64) - axis.rank * v_local
        in_range = (local >= 0) & (local < v_local)
        local = local.clamp(0, v_local - 1)
        picked = torch.gather(lg, -1, local[:, None])[:, 0]
        label_logit = axis.sum(torch.where(in_range, picked, 0.0))
        m = axis.max(lg.amax(-1))
        e = lg.sub_(m[:, None]).exp_()                      # lg's memory
        se = axis.sum(e.sum(-1))
        lse = m + torch.log(se)
        ctx.save_for_backward(x2, table, e, se, local, in_range)
        ctx.axis = axis
        return torch.mean(lse - label_logit)

    @staticmethod
    def backward(ctx, g):
        x2, table, e, se, local, in_range = ctx.saved_tensors
        coef = g / e.shape[0]
        dl = e * (coef / se)[:, None]
        rows = torch.arange(e.shape[0], device=e.device)
        dl[rows, local] -= torch.where(in_range, coef, 0.0)
        dx = dtable = None
        if ctx.needs_input_grad[0]:
            dx = ctx.axis.sum_grad(dl @ table.float(), x2.dtype)
        if ctx.needs_input_grad[1]:
            dtable = (dl.t() @ x2.float()).to(table.dtype)
        return dx, dtable, None, None
