"""stablelm-3b [dense] [hf:stabilityai/stablelm-2-1_6b; unverified].

32L d_model=2560 32H (GQA kv=32 = MHA) d_ff=6912 vocab=50304.
Partial rotary (stablelm uses rotary_pct=0.25)."""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b", family="dense",
        num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
        d_ff=6912, vocab_size=50304,
        block_pattern=("dense",), rotary_pct=0.25,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="stablelm-reduced", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, block_pattern=("dense",),
        rotary_pct=0.25, attn_chunk=8, dtype="float32",
    )
