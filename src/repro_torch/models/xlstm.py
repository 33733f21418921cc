"""xLSTM blocks (arXiv:2405.04517) -- mLSTM (matrix memory, chunk-parallel)
and sLSTM (scalar memory, recurrent) -- counterpart of
``repro/models/xlstm.py``.

mLSTM is the gated-linear recurrence

    C_t = f_t · C_{t-1} + i_t · v_t k_tᵀ ;   n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t · q_t|, 1)

through :func:`.linear_scan.gated_linear_scan` (the denominator runs through
the same scan with p = 1), its gates in log space.  sLSTM keeps per-head
scalar cells with exponential gating and a block-diagonal recurrent matrix:
a Python loop over time here, where the reference runs a ``lax.scan``.  Both
blocks own their projections (``cfg.d_ff == 0``).

Parameters keep the reference's names and dtypes: the mLSTM's ``wq``,
``wk``, ``wv``, ``w_gate``, ``wo`` (d, d) in the model's dtype and ``w_if``
(d, 2h), ``b_i``, ``b_f`` (h,) in fp32; the sLSTM's ``w_in`` (d, 4d), ``r``
(h, hd, 4hd), ``wo`` (d, d) in the model's dtype and ``b`` (4d,) in fp32.
The rounding points are the reference's: q and k scaled by ``hd ** -0.5``
rounded to x's dtype first (``jnp``'s weak-typed scalar), the gates'
product and ``log_sigmoid`` in fp32, ``num / max(|den|, 1)`` in x's dtype,
the gate through :func:`.ssm._silu`; in the sLSTM cell ``wx_t + rh`` added
in x's dtype, then widened and added to ``b``, the carry ``h`` stored in
x's dtype and ``c``, ``n``, ``m`` in fp32.

The sLSTM's gate layout is the reference's function, copied as it is: the
recurrent product is taken per head, (b, h, 4·hd), and reshaped to (b, 4d)
head-major before it is added to ``wx_t``, which splits gate-major into
``z | i | f | o``.

The caches are ``{"C": (B, H, hd, hd), "n": (B, H, 1, hd)}`` (mLSTM, the
cache dtype) and ``{"h": (B, d)`` in the cache dtype, ``"c", "n", "m": (B,
d)`` in fp32``}`` (sLSTM; the stabiliser ``m`` starts at 0, as in the
reference).  The decodes write them in place and, under an ``active``
mask, leave the inactive slots' leaves as they were, bit for bit; they
read nothing back to the host, so a served micro-step can be captured in a
CUDA graph.  The reference's roofline lowering options: the sLSTM's
``cost_mode`` (:func:`slstm_forward`) takes :func:`_slstm_flops_equivalent`,
so the dry run's cost pass counts one batched stand-in for the S-step loop
(its FLOPs, not its values); the mLSTM scan's ``unroll`` has nothing to
stand for, as the eager chunk loop is counted a chunk at a time
(:mod:`.linear_scan`).

No kernel runs here: the reference computes both recurrences with ``jnp``
operations, not a Pallas kernel, and so does the port with torch ones.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from .common import ModelConfig, dense_init, pick_chunk, update_cache
from .linear_scan import gated_linear_scan, gated_linear_step
from .ssm import _silu


def _scaled(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t * c`` with ``c`` rounded to t's dtype first, as ``jnp`` rounds a
    Python scalar to a bf16 operand's dtype (``hd ** -0.5`` is not a bf16
    number at hd = 512); the rounded constant is a Python float, so a
    captured decode copies nothing to the card."""
    return t * torch.tensor(c, dtype=t.dtype).item()


@contextlib.contextmanager
def _ieee_fp32(device: torch.device):
    """fp32 products at fp32 precision on the card whatever the caller set
    (``allow_tf32`` would round the operands to TF32's 10-bit mantissa)."""
    if device.type != "cuda":
        yield
        return
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen: Optional[torch.Generator], cfg: ModelConfig,
               dtype: torch.dtype, device=None) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wq": dense_init(gen, (d, d), dtype, device),
        "wk": dense_init(gen, (d, d), dtype, device),
        "wv": dense_init(gen, (d, d), dtype, device),
        "w_if": dense_init(gen, (d, 2 * h), torch.float32, device,
                           scale=0.02),
        "b_i": torch.full((h,), -3.0, **f32),    # small initial write
        "b_f": torch.full((h,), 3.0, **f32),     # long initial memory
        "w_gate": dense_init(gen, (d, d), dtype, device),
        "wo": dense_init(gen, (d, d), dtype, device),
    }


def _mlstm_gates(p, x: torch.Tensor) -> tuple:
    """(log input gate, log forget gate), each (..., h) fp32, from x cast
    to fp32 (``w_if``, the biases and ``log_sigmoid`` in fp32)."""
    with _ieee_fp32(x.device):
        g = x.float() @ p["w_if"]
    h = p["b_i"].shape[0]
    log_i = g[..., :h] + p["b_i"]
    log_f = F.logsigmoid(g[..., h:] + p["b_f"])
    return log_i, log_f


def _qkv(p, x: torch.Tensor, cfg: ModelConfig) -> tuple:
    """q and k scaled by ``hd ** -0.5``, v; each (..., h, hd)."""
    h = cfg.num_heads
    hd = cfg.d_model // h
    shape = x.shape[:-1] + (h, hd)
    q = _scaled((x @ p["wq"]).reshape(shape), hd ** -0.5)
    k = _scaled((x @ p["wk"]).reshape(shape), hd ** -0.5)
    return q, k, (x @ p["wv"]).reshape(shape)


def mlstm_forward(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D): the two scans over chunks of
    ``pick_chunk(S, min(ssm_chunk, S))`` (the numerator over v, the
    denominator over ones of width 1 in x's dtype), the write scale
    ``exp(min(log_i, 4))``, ``num / max(|den|, 1)``, the silu gate and the
    out-projection."""
    b, s, d = x.shape
    q, k, v = _qkv(p, x, cfg)
    log_i, log_f = _mlstm_gates(p, x)
    # the input-gate bias starts at -3, so exp(log_i) stays small; the
    # max(|n·q|, 1) denominator does the rest (the paper's appendix A)
    scale = torch.exp(log_i.clamp_max(4.0))
    chunk = pick_chunk(s, min(cfg.ssm_chunk, s))
    num, _ = gated_linear_scan(v, log_f, scale, k, q, chunk)
    ones = torch.ones((b, s, cfg.num_heads, 1), dtype=x.dtype,
                      device=x.device)
    den, _ = gated_linear_scan(ones, log_f, scale, k, q, chunk)
    y = num / den.abs().clamp_min(1.0)
    y = y.reshape(b, s, d) * _silu(x @ p["w_gate"])
    return y @ p["wo"]


def mlstm_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: dict, *,
                 active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step of the recurrence: x (B,1,D) -> (B,1,D); ``cache`` (``C``,
    ``n``) updated in place, an inactive slot's leaves kept under
    ``active``."""
    b, _, d = x.shape
    xt = x[:, 0]
    q, k, v = _qkv(p, xt, cfg)
    log_i, log_f = _mlstm_gates(p, xt)
    scale = torch.exp(log_i.clamp_max(4.0))
    num, C = gated_linear_step(cache["C"], v, log_f, scale, k, q)
    ones = torch.ones((b, cfg.num_heads, 1), dtype=x.dtype, device=x.device)
    den, n = gated_linear_step(cache["n"], ones, log_f, scale, k, q)
    y = num / den.abs().clamp_min(1.0)
    y = y.reshape(b, d) * _silu(xt @ p["w_gate"])
    update_cache(cache, {"C": C, "n": n}, active)
    return (y @ p["wo"])[:, None]


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device=None) -> dict:
    """One mLSTM layer's empty cache: the matrix memory and the normaliser
    (O(1) in the sequence length)."""
    h = cfg.num_heads
    hd = cfg.d_model // h
    return {"C": torch.zeros((batch, h, hd, hd), dtype=dtype, device=device),
            "n": torch.zeros((batch, h, 1, hd), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen: Optional[torch.Generator], cfg: ModelConfig,
               dtype: torch.dtype, device=None) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": dense_init(gen, (d, 4 * d), dtype, device),   # z,i,f,o
        "r": dense_init(gen, (h, hd, 4 * hd), dtype, device,
                        scale=0.3 * hd ** -0.5),
        "b": torch.cat([torch.zeros((2 * d,), **f32),
                        torch.full((d,), 3.0, **f32),
                        torch.zeros((d,), **f32)]),
        "wo": dense_init(gen, (d, d), dtype, device),
    }


def _slstm_cell(p, cfg: ModelConfig, carry: tuple,
                wx_t: torch.Tensor) -> tuple:
    """One sLSTM step: carry ``(h (b,d) in wx_t's dtype, c, n, m (b,d)
    fp32)`` and the input pre-activations ``wx_t`` (b, 4d) -> the next
    carry (its ``h`` is the step's output)."""
    d, nh = cfg.d_model, cfg.num_heads
    h_prev, c, n, m = carry
    b = h_prev.shape[0]
    rh = torch.bmm(h_prev.reshape(b, nh, d // nh).transpose(0, 1), p["r"])
    rh = rh.transpose(0, 1).reshape(b, 4 * d)        # head-major, as is
    pre = (wx_t + rh).float() + p["b"]
    z, i_t, f_t, o = pre.chunk(4, dim=-1)
    log_f = F.logsigmoid(f_t)
    lfm = log_f + m
    m_new = torch.maximum(lfm, i_t)                   # the stabiliser
    i_s = torch.exp(i_t - m_new)
    f_s = torch.exp(lfm - m_new)
    c_new = f_s * c + i_s * torch.tanh(z)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(o) * c_new / n_new.clamp_min(1.0)
    return h_new.to(wx_t.dtype), c_new, n_new, m_new


def _slstm_scan(p, cfg: ModelConfig, wx: torch.Tensor) -> tuple:
    """The recurrence over time from a zero carry: wx (B,S,4D) -> (the
    outputs h (B,S,D) in wx's dtype, the final carry ``(h, c, n, m)``), as
    :func:`.linear_scan.gated_linear_scan` returns its final state.  Each
    step keeps (B, D)- and (B, 4D)-sized tensors for autograd, nothing
    larger."""
    b, s, _ = wx.shape
    d = cfg.d_model
    h = torch.zeros((b, d), dtype=wx.dtype, device=wx.device)
    c = n = m = torch.zeros((b, d), dtype=torch.float32, device=wx.device)
    hs = []
    for t in range(s):
        h, c, n, m = _slstm_cell(p, cfg, (h, c, n, m), wx[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c, n, m)


def slstm_forward(p, x: torch.Tensor, cfg: ModelConfig,
                  cost_mode: bool = False) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D): the input projection, the recurrence step by
    step, the out-projection; under ``cost_mode`` the recurrence is
    :func:`_slstm_flops_equivalent`'s stand-in."""
    wx = x @ p["w_in"]
    if cost_mode:
        return _slstm_flops_equivalent(p, x, wx, cfg)
    hs, _ = _slstm_scan(p, cfg, wx)
    return hs @ p["wo"]


def _slstm_flops_equivalent(p, x: torch.Tensor, wx: torch.Tensor,
                            cfg: ModelConfig) -> torch.Tensor:
    """COST MODE ONLY (the reference's function): numerically not the
    sLSTM, but FLOP-identical to its loop -- the per-head recurrent
    product and the gate arithmetic run once for every step, batched over
    S, on x standing in for the carried h -- so the dry run's cost pass
    counts S steps without dispatching S cell steps a layer."""
    b, s, d = x.shape
    nh = cfg.num_heads
    h_fake = x.reshape(b, s, nh, d // nh)
    rh = torch.einsum("bshd,hde->bshe", h_fake, p["r"]).reshape(b, s, 4 * d)
    pre = (wx + rh).float() + p["b"]
    z, i_t, f_t, o = pre.chunk(4, dim=-1)
    log_f = F.logsigmoid(f_t)
    m = torch.maximum(log_f, i_t)
    c = torch.exp(log_f + m) + torch.exp(i_t - m) * torch.tanh(z)
    n = torch.exp(log_f) + torch.exp(i_t - m)
    y = (torch.sigmoid(o) * c / n.clamp_min(1.0)).to(x.dtype)
    return y @ p["wo"]


def slstm_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: dict, *,
                 active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step: x (B,1,D) -> (B,1,D); ``cache`` (``h``, ``c``, ``n``,
    ``m``) updated in place, an inactive slot's leaves kept under
    ``active``."""
    carry = _slstm_cell(p, cfg, (cache["h"], cache["c"], cache["n"],
                                 cache["m"]), x[:, 0] @ p["w_in"])
    update_cache(cache, dict(zip("hcnm", carry)), active)
    return (carry[0].to(x.dtype) @ p["wo"])[:, None]


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device=None) -> dict:
    """One sLSTM layer's empty cache: ``h`` in ``dtype``, the cell ``c``,
    the normaliser ``n`` and the stabiliser ``m`` in fp32, all zeros."""
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, d), dtype=dtype, device=device),
            "c": torch.zeros((batch, d), **f32),
            "n": torch.zeros((batch, d), **f32),
            "m": torch.zeros((batch, d), **f32)}
