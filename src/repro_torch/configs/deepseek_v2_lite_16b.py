"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, shared+routed experts top-6
[arXiv:2405.04434; hf].

27L d_model=2048 16H (kv via MLA latent) expert d_ff=1408 vocab=102400,
64 routed experts top-6 + 2 shared."""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=0, vocab_size=102400, head_dim=128,
        block_pattern=("mla",),
        num_experts=64, experts_per_tok=6, num_shared_experts=2,
        moe_d_ff=1408, kv_lora_rank=512, rope_head_dim=64,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-reduced", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=256, block_pattern=("mla",),
        num_experts=8, experts_per_tok=2, num_shared_experts=1,
        moe_d_ff=32, kv_lora_rank=16, rope_head_dim=8,
        attn_chunk=8, dtype="float32",
    )
