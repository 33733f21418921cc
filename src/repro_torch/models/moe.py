"""Mixture-of-Experts dispatch as an embedding operation (counterpart of
``repro/models/moe.py``; only :func:`dispatch_op` and
:func:`undispatch_program` are ported so far).

MoE dispatch *is* an embedding operation in the paper's taxonomy: tokens are
gathered into per-expert capacity buffers by irregular indices, and the
un-dispatch is a plain irregular gather over the (E·C, D) capacity buffer.
"""
from __future__ import annotations

from ..core.ops import EmbeddingOp, EmbeddingProgram
from .common import ModelConfig


def dispatch_op(cfg: ModelConfig, tokens: int) -> EmbeddingOp:
    """The EP dispatch as a characterized embedding operation: a gather of
    ``tokens · top-k`` rows over the (E·C, D) capacity buffer."""
    e, k = cfg.num_experts, max(cfg.experts_per_tok, 1)
    capacity = int(tokens * k / e * cfg.capacity_factor) + 1
    return EmbeddingOp("gather", num_segments=tokens * k,
                       num_embeddings=e * capacity, emb_len=cfg.d_model)


def undispatch_program(cfg: ModelConfig, tokens: int, name=None):
    """The MoE un-dispatch as a standalone one-op
    :class:`~repro_torch.core.ops.EmbeddingProgram`."""
    return EmbeddingProgram(name or f"{cfg.name}-moe-undispatch",
                            (("moe_undispatch", dispatch_op(cfg, tokens)),))
