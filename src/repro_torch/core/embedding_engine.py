"""The model-facing embedding program (counterpart of
``repro/core/embedding_engine.py``; only :func:`model_embedding_program` is
ported so far -- the JAX lookup strategies stay in ROADMAP.md)."""
from __future__ import annotations

from .ops import EmbeddingOp, EmbeddingProgram


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
