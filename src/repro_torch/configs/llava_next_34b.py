"""llava-next-34b [vlm] — anyres patch tiling (stubbed vision frontend)
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
`input_specs` provides precomputed patch embeddings (the anyres tile gather
is the block-gather embedding op in benchmarks)."""
from ..models.common import ModelConfig

VISION_TOKENS = 576  # one 24×24 anyres base tile


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm",
        num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
        d_ff=20480, vocab_size=64000,
        block_pattern=("dense",), modality="vision-stub",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llava-reduced", family="vlm",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=128, vocab_size=256, block_pattern=("dense",),
        modality="vision-stub", attn_chunk=8, dtype="float32",
    )
