"""AdamW (counterpart of ``repro/optim/adamw.py``).

The reference's arithmetic in its order: gradients clipped by their global
norm in fp32 and cast back to their dtype; the moments mu and nu in fp32
whatever the parameter's dtype; the update computed in fp32, cast to the
parameter's dtype and then added in that dtype (the reference's
``apply_updates``).  There are no fp32 master weights.  Trees are dicts of
tensors keyed by parameter name.  The reference's functional ``update`` +
``apply_updates`` become one in-place step, :meth:`AdamW.apply_`, leaf by
leaf, so a full-size model never holds a second copy of its parameters or
moments.  ZeRO-1 sharding of the moments waits for the sharding item
(ROADMAP.md, Queue 1 item 6c).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: object = 3e-4            # float or callable(step) -> float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for k, p in params.items()}
        dev = next(iter(params.values())).device if params else None
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          zeros, {k: z.clone() for k, z in zeros.items()})

    @torch.no_grad()
    def apply_(self, params: Mapping, grads: Mapping,
               state: AdamWState) -> AdamWState:
        """One step: the reference's ``update`` then ``apply_updates``,
        writing mu, nu and the parameters where they lie.  Returns the
        state with the new step."""
        step = state.step + 1
        if self.grad_clip:
            grads = clip_by_global_norm(grads, self.grad_clip)
        t = step.float()
        lr = self.lr(step) if callable(self.lr) else self.lr
        mu_hat = 1.0 / (1 - torch.pow(self.b1, t))
        nu_hat = 1.0 / (1 - torch.pow(self.b2, t))
        for k, p in params.items():
            g32 = grads[k].float()
            m = self.b1 * state.mu[k] + (1 - self.b1) * g32
            v = self.b2 * state.nu[k] + (1 - self.b2) * torch.square(g32)
            u = (m * mu_hat) / (torch.sqrt(v * nu_hat) + self.eps)
            u = u + self.weight_decay * p.float()
            state.mu[k].copy_(m)
            state.nu[k].copy_(v)
            p.add_((-lr * u).to(p.dtype))      # added in p's dtype
            del g32, m, v, u
        return AdamWState(step, state.mu, state.nu)


def adamw(**kw) -> AdamW:
    return AdamW(**kw)


def clip_by_global_norm(grads: Mapping, max_norm: float) -> dict:
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-9))``, the
    norm over all leaves in fp32; each scaled in fp32 and cast back to its
    dtype."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}
