"""chatglm3-6b [dense] — 2d RoPE (partial rotary), extreme GQA kv=2
[arXiv:2406.12793; hf].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024."""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense",
        num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
        d_ff=13696, vocab_size=65024,
        block_pattern=("dense",), rotary_pct=0.5,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-reduced", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=128, vocab_size=256, block_pattern=("dense",),
        rotary_pct=0.5, attn_chunk=8, dtype="float32",
    )
