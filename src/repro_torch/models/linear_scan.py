"""The chunked gated-linear recurrence (counterpart of
``repro/models/linear_scan.py``), shared by Mamba2's SSD
(:mod:`.ssm`) and xLSTM's mLSTM:

    S_t = exp(a_t) · S_{t-1} + scale_t · x_t ⊗ B_t          (state (h,p,n))
    y_t = (C_t · S_t)                                        (readout)

evaluated chunk-parallel: within a chunk the masked (L, L) contraction,
across chunks a carry of S.  The reference runs the chunks one after the
other in a ``lax.scan``; here the chunk-local parts (the decay matrix, the
intra-chunk output, each chunk's own state contribution) are computed for
every chunk at once, and only the carry -- one multiply-add of S a chunk --
runs in a Python loop, so a long prefill issues a few large operations
instead of a few per chunk.  The rounding points are the reference's:
``jnp.einsum`` promotes mixed operands to the wider type, and the factors it
rounds to the input's dtype first (``exp(acs)``, ``tail``, the carry's
decay, the intra-chunk weights) are rounded here too before the product is
taken in the promoted type (:func:`_matmul`, :func:`_einsum`); the carry is
stored in x's dtype after every chunk.

No kernel runs here: the reference computes the recurrence with ``jnp``
operations, not a Pallas kernel, and so does the port with torch ones.

The reference's ``unroll`` (its roofline's cost mode unrolls the chunk
scan, because XLA's cost analysis counts a loop body once) has nothing to
stand for: the carry's eager loop dispatches, and the dry run's counters
count, every iteration.
"""
from __future__ import annotations

from typing import Optional

import torch


def _wide(*dtypes: torch.dtype) -> torch.dtype:
    out = dtypes[0]
    for d in dtypes[1:]:
        out = torch.promote_types(out, d)
    return out


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the operands' common dtype (``jnp.einsum``'s promotion)."""
    dtype = _wide(a.dtype, b.dtype)
    return torch.matmul(a.to(dtype), b.to(dtype))


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` on operands promoted to their common dtype, as
    ``jnp.einsum`` promotes mixed ones (bf16 with fp32 -> fp32); operands
    of one dtype stay in it."""
    dtype = _wide(*(t.dtype for t in ops))
    return torch.einsum(eq, *(t.to(dtype) for t in ops))


def gated_linear_scan(x: torch.Tensor, a: torch.Tensor, scale: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, chunk: int,
                      state0: Optional[torch.Tensor] = None) -> tuple:
    """x (b,s,h,p); a, scale (b,s,h); B, C (b,s,h,n), or (b,s,1,n) for one
    group shared by the heads (the SSD block's); ``s`` a multiple of
    ``chunk``.  Returns ``(y (b,s,h,p) in x's dtype, S_final (b,h,p,n))``,
    S starting from ``state0`` (zeros in x's dtype if None).  (The
    reference's ``unroll``, a ``lax.scan`` lowering option, has no
    counterpart.)

    The (L, L) tensors are laid out head-major, (b, chunks, h, L, L), so
    each product is one batched matmul with no copy of them; a shared
    group's C.B^T is taken once, not once a head."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    dt = x.dtype

    def heads_first(t: torch.Tensor) -> torch.Tensor:   # (b,c,h,L,...)
        return t.reshape(b, nc, chunk, *t.shape[2:]).transpose(2, 3)
    xc, Bc, Cc = heads_first(x), heads_first(B), heads_first(C)
    sc = heads_first(scale)                                      # (b,c,h,L)
    acs = torch.cumsum(heads_first(a), dim=-1)                   # (b,c,h,L)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    # decay[i, j] = exp(acs_i - acs_j) for j <= i, else 0 (the exponent is
    # masked before exp: the reference's where() after it gives the same
    # values, but an overflow there would turn a gradient into NaN)
    decay = torch.exp((acs[..., :, None] - acs[..., None, :])
                      .masked_fill(~tri, float("-inf")))
    cb = _matmul(Cc, Bc.transpose(-1, -2))
    w = cb * decay * sc[..., None, :]
    y_intra = _matmul(w.to(dt), xc)                              # (b,c,h,L,p)
    tail = torch.exp(acs[..., -1:] - acs) * sc                   # (b,c,h,L)
    s_new = _matmul((tail.to(dt)[..., None] * xc.to(_wide(dt, B.dtype)))
                    .transpose(-1, -2), Bc)                      # (b,c,h,p,n)
    cd = torch.exp(acs[..., -1]).to(dt)                          # (b,c,h)
    S = state0 if state0 is not None else \
        torch.zeros((b, h, p, n), dtype=dt, device=x.device)
    starts = []
    for c in range(nc):
        starts.append(S)
        S = (S * cd[:, c, :, None, None] + s_new[:, c]).to(dt)
    y_inter = _matmul(Cc, torch.stack(starts, dim=1).transpose(-1, -2)) * \
        torch.exp(acs).to(dt)[..., None]
    y = (y_intra + y_inter).to(dt)
    return y.transpose(2, 3).reshape(b, s, h, p), S


def gated_linear_step(S_prev: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                      scale: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor) -> tuple:
    """Single-token recurrence (decode): x (b,h,p); a, scale (b,h); B, C
    (b,h,n); S_prev (b,h,p,n).  Returns ``(y (b,h,p), S)``."""
    decay = torch.exp(a)[:, :, None, None].to(x.dtype)
    S = S_prev * decay + _einsum("bh,bhp,bhn->bhpn", scale.to(x.dtype), x, B)
    return _einsum("bhn,bhpn->bhp", C, S), S
