"""Model configuration (counterpart of ``repro/models/common.py``; only the
:class:`ModelConfig` dataclass is ported so far).

Fields and defaults equal the reference's field by field; ``jdtype`` becomes
:attr:`ModelConfig.torch_dtype`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...] = ("dense",)
    head_dim: Optional[int] = None
    # attention
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0          # chatglm partial rotary
    sliding_window: int = 4096
    attn_chunk: int = 512            # kv/q chunk for blockwise attention
    # moe
    num_experts: int = 0
    experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # mla
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    # ssm / xlstm
    ssm_state: int = 64
    ssm_chunk: int = 256
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500
    # frontends
    modality: str = "text"           # text | audio-stub | vision-stub
    act: str = "silu"                # mlp activation
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # serving
    kv_cache_dtype: str = "model"    # model dtype | "int8" (quantized cache)
    # embedding engine strategy (Ember integration)
    embed_strategy: str = "masked_psum"
    # applicability notes (DESIGN.md §Arch-applicability)
    long_context_ok: bool = False    # sub-quadratic → long_500k runs

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows: vocab padded to a multiple of 256 so the
        vocab dim shards evenly over any mesh model axis ≤256 (standard
        table padding; ids never address the pad rows, decode slices the
        logits back to the logical vocab)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def n_super(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def remainder_pattern(self) -> Tuple[str, ...]:
        r = self.num_layers % len(self.block_pattern)
        return self.block_pattern[:r]
