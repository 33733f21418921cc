"""gemma3-4b [dense] — 5:1 local:global attention, 128k context, 262k vocab
[hf:google/gemma-3-1b-pt; unverified].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
The 262k vocab-sharded table is the flagship Ember embedding case.
`long_500k` skipped: the global layers are full attention."""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="dense",
        num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4,
        d_ff=10240, vocab_size=262144, head_dim=256,
        block_pattern=("dense_local",) * 5 + ("dense",),
        sliding_window=1024, rope_theta=1_000_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-reduced", family="dense",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512,
        block_pattern=("dense_local",) * 5 + ("dense",),
        sliding_window=8, attn_chunk=8, dtype="float32",
    )
