"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48L d_model=2048 4H d_ff=0 (blocks are self-contained) vocab=50304.
Pattern: 3 mLSTM : 1 sLSTM (the paper's mostly-mLSTM mix).  O(1) recurrent
state → `long_500k` runs for this arch.
"""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        ssm_chunk=256, long_context_ok=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-reduced", family="ssm",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=256,
        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        ssm_chunk=8, dtype="float32", long_context_ok=True,
    )
