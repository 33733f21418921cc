"""h2o-danube-1.8b [dense] — llama+mistral mix, sliding-window attention
[arXiv:2401.16818; hf].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000."""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense",
        num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
        d_ff=6912, vocab_size=32000,
        block_pattern=("dense_local",), sliding_window=4096,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="danube-reduced", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        block_pattern=("dense_local",), sliding_window=8, attn_chunk=8,
        dtype="float32",
    )
