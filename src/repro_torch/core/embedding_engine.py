"""The model-facing embedding lookup and program (counterpart of
``repro/core/embedding_engine.py``; ported so far: :func:`lookup` with the
single-device strategies ``take``, ``one_hot`` and ``pallas``, :func:`logits`
and :func:`model_embedding_program` -- the sharded strategies
(``masked_psum``, ``masked_psum_scatter``) and the vocab-parallel cross
entropy wait for the sharding item, ROADMAP.md Queue 1 item 6)."""
from __future__ import annotations

import torch

from .ops import EmbeddingOp, EmbeddingProgram, single_op_program

SHARDED_STRATEGIES = ("masked_psum", "masked_psum_scatter")


def lookup(table: torch.Tensor, ids: torch.Tensor, *,
           strategy: str = "take") -> torch.Tensor:
    """Embed ``ids (..., S)`` from ``table (V, D)`` -> ``(..., S, D)``.

    ``take``: ``index_select``.  ``one_hot``: a one-hot product (an id
    outside the table gives a zero row, as ``jax.nn.one_hot`` does).
    ``pallas``: the single-device DAE lookup -- the one-gather program
    compiled by emberc (compile-cache backed) and run through
    :mod:`.backend_cuda`: the hand-written block gather on the card, its
    plain version on the CPU."""
    if strategy == "take":
        return table.index_select(0, ids.reshape(-1)).reshape(
            *ids.shape, table.shape[1])
    if strategy == "one_hot":
        rows = torch.arange(table.shape[0], device=ids.device)
        return (ids[..., None] == rows).to(table.dtype) @ table
    if strategy == "pallas":
        return _dae_lookup(table, ids)
    if strategy in SHARDED_STRATEGIES:
        raise NotImplementedError(
            f"lookup strategy {strategy!r} is sharded and not ported yet "
            "(ROADMAP.md, Queue 1 item 6)")
    raise ValueError(strategy)


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
    bf16 x bf16 -> fp32 GEMM."""
    x2 = x.reshape(1, -1, x.shape[-1])
    w = table.t()[None]
    if x.is_cuda and x.dtype == table.dtype == torch.bfloat16:
        out = torch.bmm(x2, w, out_dtype=torch.float32)
    else:
        out = torch.bmm(x2.float(), w.float())
    return out.view(*x.shape[:-1], table.shape[0])
