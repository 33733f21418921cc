"""Model substrate: configuration + shared layer primitives (counterpart of
``repro/models/common.py``).

:class:`ModelConfig` equals the reference's field by field; ``jdtype``
becomes :attr:`ModelConfig.torch_dtype`.  The primitives follow the
reference's casts (fp32 statistics in :func:`rms_norm` and fp32 rotary
arithmetic, one cast back), so bf16 rounds at the same places.  Weights keep
the reference's ``(in, out)`` layout: ``x @ w``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...] = ("dense",)
    head_dim: Optional[int] = None
    # attention
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0          # chatglm partial rotary
    sliding_window: int = 4096
    attn_chunk: int = 512            # kv/q chunk for blockwise attention
    # moe
    num_experts: int = 0
    experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # mla
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    # ssm / xlstm
    ssm_state: int = 64
    ssm_chunk: int = 256
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500
    # frontends
    modality: str = "text"           # text | audio-stub | vision-stub
    act: str = "silu"                # mlp activation
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # serving
    kv_cache_dtype: str = "model"    # model dtype | "int8" (quantized cache)
    # embedding engine strategy (Ember integration)
    embed_strategy: str = "masked_psum"
    # applicability notes (DESIGN.md §Arch-applicability)
    long_context_ok: bool = False    # sub-quadratic → long_500k runs

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows: vocab padded to a multiple of 256 so the
        vocab dim shards evenly over any mesh model axis ≤256 (standard
        table padding; ids never address the pad rows, decode slices the
        logits back to the logical vocab)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def n_super(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def remainder_pattern(self) -> Tuple[str, ...]:
        r = self.num_layers % len(self.block_pattern)
        return self.block_pattern[:r]


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def init_rms(d: int, dtype: torch.dtype, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def dense_init(gen: Optional[torch.Generator], shape: tuple,
               dtype: torch.dtype, device=None,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, fan_in^-1/2) in fp32 from ``gen``, cast to ``dtype``.  The
    numbers differ from the reference's ``jax.random`` ones (tests carry the
    reference's weights across with ``repro_torch.convert``).  On the
    ``meta`` device only the shape is made."""
    if torch.device(device if device is not None else "cpu").type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    s = scale if scale is not None else shape[0] ** -0.5
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * s).to(dtype)


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float,
               rotary_pct: float = 1.0) -> tuple:
    """positions (..., S) -> (cos, sin) of shape (..., S, rot/2)."""
    rot = int(head_dim * rotary_pct) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=positions.device) / rot))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (..., S, rot/2): interleaved pairs over the
    first ``rotary_pct`` of the head, in fp32, cast back once."""
    d = x.shape[-1]
    rot = int(d * rotary_pct) // 2 * 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    c = cos[..., None, :]
    s = sin[..., None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < d else out


# jax.nn.gelu is the tanh approximation by default
_ACTS = {"silu": F.silu,
         "gelu": lambda t: F.gelu(t, approximate="tanh"),
         "relu": F.relu}


def pick_chunk(s: int, preferred: int) -> int:
    """Largest chunk <= preferred that divides s (gcd fallback)."""
    return preferred if s % preferred == 0 else math.gcd(s, preferred)


def gated_mlp(x: torch.Tensor, p, act: str = "silu") -> torch.Tensor:
    h = _ACTS[act](x @ p["wi_gate"]) * (x @ p["wi_up"])
    return h @ p["wo"]


def init_mlp(gen: Optional[torch.Generator], d_model: int, d_ff: int,
             dtype: torch.dtype, device=None) -> dict:
    return {
        "wi_gate": dense_init(gen, (d_model, d_ff), dtype, device),
        "wi_up": dense_init(gen, (d_model, d_ff), dtype, device),
        "wo": dense_init(gen, (d_ff, d_model), dtype, device),
    }
