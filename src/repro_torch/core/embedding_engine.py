"""The model-facing embedding lookup and program (counterpart of
``repro/core/embedding_engine.py``; ported so far: :func:`lookup` with the
``take`` strategy, :func:`logits` and :func:`model_embedding_program` -- the
sharded lookup strategies and the vocab-parallel cross entropy wait for the
sharding item in ROADMAP.md, Queue 1 item 4)."""
from __future__ import annotations

import torch

from .ops import EmbeddingOp, EmbeddingProgram


def lookup(table: torch.Tensor, ids: torch.Tensor, *,
           strategy: str = "take") -> torch.Tensor:
    """Embed ``ids (..., S)`` from ``table (V, D)`` -> ``(..., S, D)``."""
    if strategy != "take":
        raise NotImplementedError(
            f"lookup strategy {strategy!r} is sharded and not ported yet "
            "(ROADMAP.md, Queue 1 item 4)")
    return table.index_select(0, ids.reshape(-1)).reshape(
        *ids.shape, table.shape[1])


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
