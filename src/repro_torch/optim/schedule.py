"""LR schedules (counterpart of ``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    floor: float = 0.1):
    """lr(step): linear warm-up to ``peak_lr``, then a cosine down to
    ``floor * peak_lr`` at ``total_steps``; a () fp32 tensor."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr
