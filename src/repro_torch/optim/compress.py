"""Gradient compression with error feedback (counterpart of
``repro/optim/compress.py``).

Each gradient, plus the residual carried from the last step, is quantized to
int8 in blocks of 256 values, each block scaled by its largest magnitude /
127 (floored at 1e-12), rounding half to even; what enters the optimizer is
the dequantized gradient, and the quantization error is kept for the next
step (EF-SGD / EF21).  In the reference this prepares the cross-pod
all-reduce; on one card it changes the gradients exactly as there.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

BLOCK = 256


def quantize(g32: torch.Tensor) -> tuple:
    """(int8 codes (n_blocks, 256), fp32 scales (n_blocks, 1), pad)."""
    flat = g32.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    blocks = F.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def dequantize(q: torch.Tensor, scale: torch.Tensor, pad: int,
               shape) -> torch.Tensor:
    deq = (q.float() * scale).reshape(-1)
    if pad:
        deq = deq[:-pad]
    return deq.reshape(shape)


def error_feedback_init(params: Mapping) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compress_gradients(grads: Mapping, ef_state: Mapping) -> tuple:
    """(dequantized gradients in their dtype -- what the optimizer sees --,
    the new fp32 residuals)."""
    out, ef = {}, {}
    for k, g in grads.items():
        g32 = g.float() + ef_state[k]
        q, scale, pad = quantize(g32)
        deq = dequantize(q, scale, pad, g32.shape)
        out[k], ef[k] = deq.to(g.dtype), g32 - deq
    return out, ef
