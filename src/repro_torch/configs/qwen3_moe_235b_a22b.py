"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936.
The full model does not fit one card; only ``reduced()`` runs in the port
so far (the CPU tests, and a card test)."""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
        d_ff=0, vocab_size=151936, head_dim=128,
        block_pattern=("moe",),
        num_experts=128, experts_per_tok=8, moe_d_ff=1536,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-reduced", family="moe",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=0, vocab_size=256, block_pattern=("moe",),
        num_experts=8, experts_per_tok=2, moe_d_ff=32,
        attn_chunk=8, dtype="float32",
    )
