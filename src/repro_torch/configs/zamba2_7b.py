"""zamba2-7b [hybrid] — Mamba2 backbone + SHARED attention block
[arXiv:2411.15242; unverified].

81L d_model=3584 32H d_ff=14336 vocab=32000 ssm_state=64.
Pattern: 5 mamba : 1 shared-attn (one attention weight set reused at every
occurrence — held outside the scanned params).  SSM state is O(1) →
`long_500k` runs; at 500k the shared attention gets a sliding window
(DESIGN.md §4, documented adaptation)."""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
        d_ff=14336, vocab_size=32000, ssm_state=64,
        block_pattern=("mamba", "mamba", "mamba", "mamba", "mamba",
                       "shared_attn"),
        ssm_chunk=256, sliding_window=4096, long_context_ok=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-reduced", family="hybrid",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, ssm_state=8,
        block_pattern=("mamba", "mamba", "shared_attn"),
        ssm_chunk=8, sliding_window=8, attn_chunk=8, dtype="float32",
        long_context_ok=True,
    )
