"""AdamW (counterpart of ``repro/optim/adamw.py``).

The reference's arithmetic in its order: gradients clipped by their global
norm in fp32 and cast back to their dtype; the moments mu and nu in fp32
whatever the parameter's dtype; the update computed in fp32, cast to the
parameter's dtype and then added in that dtype (the reference's
``apply_updates``).  There are no fp32 master weights.  Trees are dicts of
tensors keyed by parameter name.  The reference's functional ``update`` +
``apply_updates`` become one in-place step, :meth:`AdamW.apply_`, leaf by
leaf, so a full-size model never holds a second copy of its parameters or
moments.

Over a mesh (model-parallel training) each rank steps its own slices, as
:class:`Shards` says: the clipping norm is the *global* gradient's (the
squares of the leaves split over the model axis summed over it, each
replicated leaf, each KV copy of the head plan and a mamba layer's copied
B | C columns counted once), and a
ZeRO-1 leaf's moments are only this
data rank's rows of it (:func:`repro_torch.launch.sharding.zero1_specs`):
the rank updates those rows of the parameter in fp32 as above, then the
updated rows are all-gathered over the data axis.  The update is
elementwise, so the result is the unsharded update's bits.
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
class Shards:
    """How this rank holds the trees it steps: ``model`` the model axis
    (a :class:`~repro_torch.core.shard_plan.ModelAxis`, None on one
    device) and ``split`` the leaves split over it, of which ``repeat``
    are those whose slice an earlier rank holds too (a KV copy of the head
    plan: its first holder counts it in the norm) and ``counted`` those
    the rank counts only in part -- ``{name: (dim, ((lo, hi), ...))}``,
    the spans of its slice it holds first (a mamba layer's ``w_in`` off
    rank 0: its own columns, not its copy of B | C); ``data`` the data
    axis and ``zero1`` the leaves whose moments are this data rank's
    block of rows (dim 0 cut evenly over the axis)."""
    model: object = None
    split: frozenset = frozenset()
    data: object = None
    zero1: frozenset = frozenset()
    repeat: frozenset = frozenset()
    counted: dict = dataclasses.field(default_factory=dict)

    def rows(self, name: str, n: int) -> tuple:
        """``[lo, hi)`` of dim 0 (``n`` rows) whose moments this rank keeps:
        its block for a ZeRO-1 leaf, all of them otherwise."""
        if name not in self.zero1:
            return 0, n
        step = n // self.data.size
        return self.data.rank * step, (self.data.rank + 1) * step


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: object = 3e-4            # float or callable(step) -> float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: Mapping[str, torch.Tensor],
             shards: Shards = None) -> AdamWState:
        """Zero moments in fp32: of every leaf, or under ``shards`` of this
        rank's rows of a ZeRO-1 leaf."""
        def shape(k, p):
            if shards is None or k not in shards.zero1:
                return p.shape
            lo, hi = shards.rows(k, p.shape[0])
            return (hi - lo,) + tuple(p.shape[1:])
        zeros = {k: torch.zeros(shape(k, p), dtype=torch.float32,
                                device=p.device) for k, p in params.items()}
        dev = next(iter(params.values())).device if params else None
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          zeros, {k: z.clone() for k, z in zeros.items()})

    @torch.no_grad()
    def apply_(self, params: Mapping, grads: Mapping,
               state: AdamWState, shards: Shards = None) -> AdamWState:
        """One step: the reference's ``update`` then ``apply_updates``,
        writing mu, nu and the parameters where they lie (this rank's
        slices under ``shards``).  Returns the state with the new step."""
        step = state.step + 1
        if self.grad_clip:
            grads = clip_by_global_norm(grads, self.grad_clip, shards)
        t = step.float()
        lr = self.lr(step) if callable(self.lr) else self.lr
        mu_hat = 1.0 / (1 - torch.pow(self.b1, t))
        nu_hat = 1.0 / (1 - torch.pow(self.b2, t))
        for k, p in params.items():
            g = grads[k]
            rows = None
            if shards is not None and k in shards.zero1:
                lo, hi = shards.rows(k, p.shape[0])
                g, rows = g[lo:hi], p[lo:hi]
            w = p if rows is None else rows
            g32 = g.float()
            m = self.b1 * state.mu[k] + (1 - self.b1) * g32
            v = self.b2 * state.nu[k] + (1 - self.b2) * torch.square(g32)
            u = (m * mu_hat) / (torch.sqrt(v * nu_hat) + self.eps)
            u = u + self.weight_decay * w.float()
            state.mu[k].copy_(m)
            state.nu[k].copy_(v)
            w.add_((-lr * u).to(p.dtype))      # added in p's dtype
            if rows is not None:               # every data rank's rows
                p.copy_(shards.data.gather(rows.contiguous(), 0))
            del g32, m, v, u
        return AdamWState(step, state.mu, state.nu)


def adamw(**kw) -> AdamW:
    return AdamW(**kw)


def clip_by_global_norm(grads: Mapping, max_norm: float,
                        shards: Shards = None) -> dict:
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-9))``, the
    norm over all leaves in fp32; each scaled in fp32 and cast back to its
    dtype.  Under ``shards`` the norm is the global gradient's: the squares
    of the leaves split over the model axis summed there (one all-reduce;
    a slice in ``shards.repeat``, or a copied span of one in
    ``shards.counted``, left to its first holder), plus each
    replicated leaf's once."""
    gn = torch.sqrt(global_sq_norm(grads, shards))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}


def global_sq_norm(grads: Mapping, shards: Shards = None) -> torch.Tensor:
    """The fp32 sum of squares of the global gradient (see
    :func:`clip_by_global_norm`), the same on every rank."""
    if shards is None or shards.model is None:
        return sum(torch.sum(torch.square(g.float()))
                   for g in grads.values())
    def part(k: str, g: torch.Tensor) -> torch.Tensor:
        if k not in shards.counted:
            return torch.sum(torch.square(g.float()))
        dim, spans = shards.counted[k]
        return sum(torch.sum(torch.square(g.narrow(dim, lo, hi - lo)
                                          .float())) for lo, hi in spans)

    def sq(split: bool) -> torch.Tensor:
        zero = torch.zeros((), device=next(iter(grads.values())).device)
        return sum((part(k, g) for k, g in grads.items()
                    if (k in shards.split) == split and
                    k not in shards.repeat), zero)
    return shards.model.coll.all_reduce(sq(True).reshape(1), "add")[0] + \
        sq(False)
