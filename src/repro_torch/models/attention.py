"""GQA attention layer (counterpart of
``repro/models/attention.py``; ported so far: :func:`blockwise_attention`,
:func:`init_attn` and :func:`attn_forward`).

:func:`blockwise_attention` is the reference's online-softmax attention over
KV chunks.  Here it is one call to ``kernels.ops.attention``: the
hand-written flash kernel on CUDA tensors, its plain version (the same
recurrence, chunk by chunk) on CPU tensors.  Decode with a cache, MLA and
the sliding-window band are still to port (ROADMAP.md, Queue 1 item 5).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import ops as kops
from .common import ModelConfig, apply_rope, dense_init, pick_chunk, \
    rope_freqs


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        chunk: int = 512) -> torch.Tensor:
    """q (B,Sq,H,D); k,v (B,Sk,Hkv,D); GQA via head grouping -> (B,Sq,H,D).

    ``chunk`` sets the plain version's KV chunk (its fp32 summation order);
    the kernel tiles by itself.  On CUDA a ``window`` raises
    ``NotImplementedError`` (no kernel for the band yet)."""
    return kops.attention(q, k, v, causal=causal, window=window, chunk=chunk)


def init_attn(gen: Optional[torch.Generator], cfg: ModelConfig,
              dtype: torch.dtype, device=None) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return {
        "wq": dense_init(gen, (d, h * hd), dtype, device),
        "wk": dense_init(gen, (d, hkv * hd), dtype, device),
        "wv": dense_init(gen, (d, hkv * hd), dtype, device),
        "wo": dense_init(gen, (h * hd, d), dtype, device),
    }


def attn_forward(p, x: torch.Tensor, cfg: ModelConfig, *,
                 positions: torch.Tensor, causal: bool = True,
                 window: Optional[int] = None,
                 kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D).  ``kv`` overrides the K/V source
    (cross-attention, no rotary); on CUDA it raises: the flash kernel is
    held against its plain version on self-attention only."""
    if kv is not None and x.is_cuda:
        raise NotImplementedError(
            "cross-attention (kv=) has no checked Hopper path yet "
            "(ROADMAP.md, Queue 1 item 5: the xdec block kind)")
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    src = kv if kv is not None else x
    sk = src.shape[1]
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (src @ p["wk"]).reshape(b, sk, hkv, hd)
    v = (src @ p["wv"]).reshape(b, sk, hkv, hd)
    if kv is None:  # self-attention: rotary
        cos, sin = rope_freqs(positions, hd, cfg.rope_theta, cfg.rotary_pct)
        q = apply_rope(q, cos, sin, cfg.rotary_pct)
        k = apply_rope(k, cos, sin, cfg.rotary_pct)
    chunk = pick_chunk(math.gcd(s, sk), min(cfg.attn_chunk, s))
    o = blockwise_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal and kv is None, window=window,
                            chunk=chunk)
    return o.reshape(b, s, h * hd) @ p["wo"]
