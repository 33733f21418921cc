"""whisper-large-v3 [audio] -- enc-dec, conv frontend STUB
[arXiv:2212.04356; unverified].

32L (decoder) + 32L encoder, d_model=1280 20H (MHA) d_ff=5120 vocab=51866.
`input_specs` provides precomputed frame embeddings (conv frontend stubbed);
shapes apply to the decoder backbone, the encoder sees the same frame count.
Full attention both sides -> `long_500k` skipped."""
from ..models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="audio",
        num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
        d_ff=5120, vocab_size=51866,
        block_pattern=("xdec",), enc_layers=32, enc_seq=1500,
        modality="audio-stub", act="gelu",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-reduced", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, block_pattern=("xdec",),
        enc_layers=2, enc_seq=16, modality="audio-stub", act="gelu",
        attn_chunk=8, dtype="float32",
    )
