"""Mamba2 (SSD) block -- the chunked state-space scan (counterpart of
``repro/models/ssm.py``).

The forward runs the SSD recurrence chunk-parallel through the shared
gated-linear core (:func:`.linear_scan.gated_linear_scan`; B and C are one
group, broadcast over the heads); the decode step updates the (H, P, N)
state and the window of the last three conv inputs.  Parameters keep the
reference's names and dtypes: ``w_in`` (d, 2·d_inner + 2n + h) -- the
in-projection split ``x | z | B | C | dt`` --, ``conv_w`` (4, d_inner),
``w_out`` (d_inner, d) and ``norm_z`` (d_inner,) in the model's dtype, and
``A_log``, ``D``, ``dt_bias`` (h,) in fp32 whatever the model's dtype.
``norm_z`` is initialised and read nowhere, as in the reference; it is kept
so the parameter trees match (its gradient is zero).

The cache is ``{"state": (B, H, P, N), "conv": (B, 3, d_inner)}`` in the
model's dtype and the reference's layout (unlike the KV caches it is not
reordered).  :func:`mamba_decode` writes it in place and, under an
``active`` mask, leaves the inactive slots' leaves as they were, bit for
bit; it reads nothing back to the host and allocates nothing whose size
depends on values, so a served micro-step can be captured in a CUDA graph.

**Over a model axis** (``tp``, a :class:`~repro_torch.core.shard_plan
.ModelAxis`) a rank holds whole SSM heads
(:func:`repro_torch.launch.sharding.ssm_plan`): ``w_in``'s columns are its
x, its z, the whole B | C block and its dt, in the reference's order at
the rank's widths; ``conv_w``, ``A_log``, ``D``, ``dt_bias`` and ``w_out``'s
rows are its heads'.  The sizes come from the leaves (:func:`ssm_heads`).
Each rank runs the scan on its heads, and ``w_out`` is row-parallel (fp32
partials, one all-reduce, one rounding: :func:`.common.row_parallel`) --
the forward's one collective.  Under autograd the layer's input and the
B | C columns enter the rank together (:meth:`~repro_torch.core.shard_plan
.ModelAxis.enter_all`): every rank computes B and C whole but only its
heads read them, so both gradients are the rank's partials, summed over
the axis in one fp32 all-reduce and rounded once.  A decode step writes
the rank's heads of ``state`` and its columns of ``conv``.

The reference's ``unroll`` (``mamba_forward`` and ``_ssd_chunked``, its
roofline's cost mode) is not taken: the port's chunk loop is eager, and
the dry run counts every iteration of it (:mod:`.linear_scan`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .common import (ModelConfig, dense_init, pick_chunk, row_parallel,
                     update_cache)
from .linear_scan import gated_linear_scan


def init_mamba(gen: Optional[torch.Generator], cfg: ModelConfig,
               dtype: torch.dtype, device=None) -> dict:
    d, n, h = cfg.d_model, cfg.ssm_state, cfg.num_heads
    d_inner = 2 * d
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # in_proj: x, z(gate), B, C, dt
        "w_in": dense_init(gen, (d, d_inner * 2 + 2 * n + h), dtype, device),
        "conv_w": dense_init(gen, (4, d_inner), dtype, device, scale=0.5),
        "A_log": torch.log(torch.arange(1, h + 1, **f32)),
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "w_out": dense_init(gen, (d_inner, d), dtype, device),
        "norm_z": torch.ones((d_inner,), dtype=dtype, device=device),
    }


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    """The chunked SSD scan through the shared gated-linear core: x
    (b,s,h,p); dt (b,s,h); A (h,) < 0; B, C (b,s,n) (one group, shared by
    the heads: the reference broadcasts it to every head, the core takes
    its one head)."""
    a = dt * A[None, None, :]
    y, _ = gated_linear_scan(x, a, dt, B[:, :, None, :], C[:, :, None, :],
                             chunk)
    return y


def _silu(t: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s steps, ``t * (1 / (1 + exp(-t)))``, each rounded to
    t's dtype as the reference rounds a bf16 input at every step
    (``F.silu`` rounds once, which moves a bf16 result by a step in about a
    third of the elements)."""
    return t * (1 / (1 + torch.exp(-t)))


def _split_proj(proj: torch.Tensor, d_inner: int, n: int) -> tuple:
    """The in-projection's ``x | z | B | C | dt`` columns."""
    xi, z = proj[..., :d_inner], proj[..., d_inner:2 * d_inner]
    rest = proj[..., 2 * d_inner:]
    return xi, z, rest[..., :n], rest[..., n:2 * n], rest[..., 2 * n:]


def ssm_heads(p, cfg: ModelConfig) -> tuple:
    """(heads, head width, inner width) of the mamba leaves ``p``: the
    config's, or on a rank of a model axis its own heads (``A_log``'s
    length)."""
    per = 2 * cfg.d_model // cfg.num_heads
    h = p["A_log"].shape[0]
    return h, per, h * per


def _in_proj(p, x: torch.Tensor, d_inner: int, n: int, tp) -> torch.Tensor:
    """``x @ w_in``; on a rank under autograd, ``x`` and the B | C columns
    enter the rank together first (module docstring)."""
    w = p["w_in"]
    if tp is not None:
        bc = w[:, 2 * d_inner:2 * d_inner + 2 * n]
        x, bc_in = tp.enter_all((x, bc))
        if bc_in is not bc:
            w = torch.cat([w[:, :2 * d_inner], bc_in,
                           w[:, 2 * d_inner + 2 * n:]], dim=1)
    return x @ w


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig,
                  tp=None) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D): the in-projection, the causal depthwise conv of
    width 4 (summed tap by tap in x's dtype, as the reference's Python
    ``sum``), silu, ``dt = softplus(dt + dt_bias)`` and ``A = -exp(A_log)``
    in fp32, the SSD scan over chunks of ``pick_chunk(S, min(ssm_chunk,
    S))`` with B and C in fp32, the D skip, the silu(z) gate and the
    out-projection.  On a rank of ``tp`` (module docstring) the rank's
    heads, the out-projection summed over the axis; a rank without heads
    runs no scan and adds zeros."""
    b, s, d = x.shape
    n = cfg.ssm_state
    h, per, d_inner = ssm_heads(p, cfg)
    xi, z, Bm, Cm, dt = _split_proj(_in_proj(p, x, d_inner, n, tp),
                                    d_inner, n)
    xpad = F.pad(xi, (0, 0, 3, 0))
    conv_w = p["conv_w"]
    xconv = xpad[:, 0:s] * conv_w[0]
    for i in range(1, 4):
        xconv = xconv + xpad[:, i:i + s] * conv_w[i]
    xconv = _silu(xconv)
    if h == 0:      # a rank without heads (the plan): nothing to scan
        return row_parallel(xconv * z, p["w_out"], tp)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xconv.reshape(b, s, h, per)
    chunk = pick_chunk(s, min(cfg.ssm_chunk, s))
    y = _ssd_chunked(xh, dt, A, Bm.float(), Cm.float(), chunk)
    y = y + xh * p["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(b, s, d_inner) * _silu(z)
    return row_parallel(y, p["w_out"], tp)


def mamba_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: dict, *,
                 active: Optional[torch.Tensor] = None,
                 tp=None) -> torch.Tensor:
    """One step of the recurrence: x (B,1,D) -> (B,1,D), ``cache`` updated
    in place (see the module docstring).  The conv is the window of the
    cache's three inputs and this one, its four products summed in fp32
    and rounded once (the reference's einsum); the state decays by
    ``exp(dt A)`` rounded to x's dtype and gains ``dt x ⊗ B``, all in x's
    dtype (B and C are not widened here, as in the reference).  With an
    ``active`` mask (B,) bool, the inactive slots' state and conv window
    keep their bits (the reference's ``where(active, new, old)``).  On a
    rank of ``tp`` the rank's heads of the state and columns of the
    window, the out-projection summed over the axis."""
    b, _, d = x.shape
    n = cfg.ssm_state
    h, per, d_inner = ssm_heads(p, cfg)
    xi, z, Bm, Cm, dt = _split_proj(x[:, 0] @ p["w_in"], d_inner, n)
    conv_in = torch.cat([cache["conv"], xi[:, None]], dim=1)   # (b,4,di)
    xconv = (conv_in.float() * p["conv_w"].float()).sum(1).to(x.dtype)
    xconv = _silu(xconv)
    dt = F.softplus(dt.float() + p["dt_bias"])                  # (b,h)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A[None, :])                          # (b,h)
    xh = xconv.reshape(b, h, per)
    dtx = dt.to(x.dtype)
    S = cache["state"] * decay[:, :, None, None].to(x.dtype) + \
        dtx[:, :, None, None] * xh[:, :, :, None] * Bm[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", Cm, S) + \
        xh * p["D"][None, :, None].to(x.dtype)
    y = y.reshape(b, d_inner) * _silu(z)
    update_cache(cache, {"state": S, "conv": conv_in[:, 1:]}, active)
    return row_parallel(y, p["w_out"], tp)[:, None]


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device=None, heads: Optional[int] = None) -> dict:
    """One mamba layer's empty cache (the reference's layout), of
    ``heads`` heads (a rank's; the config's by default)."""
    h = cfg.num_heads if heads is None else heads
    per = 2 * cfg.d_model // cfg.num_heads
    return {"state": torch.zeros((batch, h, per, cfg.ssm_state),
                                 dtype=dtype, device=device),
            "conv": torch.zeros((batch, 3, h * per), dtype=dtype,
                                device=device)}
