"""The LM's embedding program (counterpart of ``repro/models/lm.py``; only
``LM.embedding_program`` is ported so far, as a plain function -- the rest
of the LM substrate is in ROADMAP.md)."""
from __future__ import annotations

from ..core import embedding_engine as ee
from ..core.ops import EmbeddingProgram
from . import moe as moe_mod
from .common import ModelConfig


def embedding_program(cfg: ModelConfig, batch: int,
                      seq: int) -> EmbeddingProgram:
    """All irregular lookups of one (batch, seq) step as one
    :class:`~repro_torch.core.ops.EmbeddingProgram`: token embedding + label
    gather over the shared embed table, plus the MoE dispatch gather for
    models with MoE blocks."""
    tokens = batch * seq
    extra = []
    pattern = tuple(cfg.block_pattern) + tuple(cfg.remainder_pattern)
    if cfg.num_experts and any(k in ("moe", "mla") for k in pattern):
        extra.append(("moe_dispatch", moe_mod.dispatch_op(cfg, tokens)))
    return ee.model_embedding_program(
        vocab_size=cfg.padded_vocab, d_model=cfg.d_model, tokens=tokens,
        extra_ops=tuple(extra), name=f"{cfg.name}-step")
