"""Plain PyTorch versions of the Hopper kernels.

The kernel wrappers (:mod:`.sls`, :mod:`.gather`, :mod:`.fusedmm`,
:mod:`.flash_attention`) run these for tensors on the CPU; the tests hold
them against the JAX package, and ``chip_smoke.py`` holds each kernel against
them on the card.  They repeat the kernels' arithmetic (fp32 accumulation,
one cast to the input's dtype at the end) and are no yardstick of speed.

Unlike the reference's oracles, CSR input is taken as ``ptrs`` directly (no
segment-id form): ``idxs`` may be longer than ``ptrs[-1]`` (the executor's
capacity padding), and the tail is never read.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def sls(table: torch.Tensor, ptrs: torch.Tensor, idxs: torch.Tensor,
        weights: Optional[torch.Tensor] = None, *, num_segments: int,
        add_op: str = "add", mul_op: str = "mul",
        seg_base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SLS / EmbeddingBag over CSR segments:
    ``out[b] = (+)_{p in [ptrs[b], ptrs[b+1])} w_p (x) T[idxs[p] + seg_base[b]]``
    with (+) in {add, max, min} and (x) in {mul, add}; an empty segment is 0
    under every (+).  Reads ``ptrs[-1]`` on the host."""
    dev = table.device
    emb_len = table.shape[1]
    p64 = ptrs.to(torch.int64)
    nnz = int(p64[-1])
    seg = torch.repeat_interleave(torch.arange(num_segments, device=dev),
                                  p64[1:] - p64[:-1], output_size=nnz)
    rows = idxs[:nnz].to(torch.int64)
    if seg_base is not None:
        rows = rows + seg_base.to(torch.int64)[seg]
    vals = table.index_select(0, rows).float()
    if weights is not None:
        w = weights[:nnz].float()[:, None]
        vals = vals * w if mul_op == "mul" else vals + w
    out = torch.zeros((num_segments, emb_len), dtype=torch.float32,
                      device=dev)
    if add_op == "add":
        out.index_add_(0, seg, vals)
    else:
        # include_self=False: rows no lookup reaches keep their 0
        out.scatter_reduce_(0, seg[:, None].expand(-1, emb_len), vals,
                            reduce={"max": "amax", "min": "amin"}[add_op],
                            include_self=False)
    return out.to(table.dtype)


def block_gather(table: torch.Tensor, idxs: torch.Tensor, *,
                 block_rows: int = 1,
                 roff: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block gather: ``out[g, r] = T[(idxs[g] + roff[g]) * R + r]``."""
    blk = idxs.to(torch.int64)
    if roff is not None:
        blk = blk + roff.to(torch.int64)
    rows = (blk[:, None] * block_rows +
            torch.arange(block_rows, device=table.device)[None, :])
    return table.index_select(0, rows.reshape(-1)).reshape(
        idxs.shape[0], block_rows, table.shape[1])


def block_gather_backward(dout: torch.Tensor, idxs: torch.Tensor,
                          num_rows: int, *, block_rows: int = 1,
                          roff: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The block gather's gradient: ``dtable[r] = sum over the lookups g
    that read row r of dout[g]``, an ``index_add_`` into ``num_rows`` fp32
    rows, cast to dout's dtype once.  dout (G, block_rows, E)."""
    blk = idxs.to(torch.int64)
    if roff is not None:
        blk = blk + roff.to(torch.int64)
    rows = (blk[:, None] * block_rows +
            torch.arange(block_rows, device=dout.device)[None, :])
    emb_len = dout.shape[-1]
    out = torch.zeros((num_rows, emb_len), dtype=torch.float32,
                      device=dout.device)
    out.index_add_(0, rows.reshape(-1), dout.reshape(-1, emb_len).float())
    return out.to(dout.dtype)


def transposed_lookups(idxs: torch.Tensor, roff: Optional[torch.Tensor],
                       n_tbl: int) -> tuple:
    """The block gather's lookups as CSR over the table's ``n_tbl`` blocks:
    ``(order, ptrs)``, the lookups sorted stably by block id ``idxs[g] +
    roff[g]`` (int32) and each block's segment offsets, from a bincount
    (int32, ``n_tbl + 1``)."""
    blk = idxs.to(torch.int64)
    if roff is not None:
        blk = blk + roff.to(torch.int64)
    order = torch.argsort(blk, stable=True).to(torch.int32)
    ptrs = torch.zeros(n_tbl + 1, dtype=torch.int32, device=idxs.device)
    torch.cumsum(torch.bincount(blk, minlength=n_tbl), 0, out=ptrs[1:])
    return order, ptrs


def fusedmm(x: torch.Tensor, ptrs: torch.Tensor, idxs: torch.Tensor, *,
            num_segments: int, fn: str = "identity",
            first_segment: int = 0) -> torch.Tensor:
    """FusedMM (message passing), SDDMM + SpMM in one pass:
    ``out[i] = sum_{p in [ptrs[i], ptrs[i+1])} f(<x[i], x[idxs[p]]>) *
    x[idxs[p]]`` with f in {identity, relu}; an empty segment is 0.

    ``first_segment`` computes the rows ``first_segment + i`` of a slice of
    the segments (``ptrs`` is then that slice of the offsets, whose first
    entry need not be 0), so a caller can check a large graph in chunks.
    Reads ``ptrs[0]`` and ``ptrs[-1]`` on the host."""
    p64 = ptrs.to(torch.int64)
    lo, hi = int(p64[0]), int(p64[-1])
    seg = torch.repeat_interleave(
        torch.arange(num_segments, device=x.device), p64[1:] - p64[:-1],
        output_size=hi - lo)
    xj = x.index_select(0, idxs[lo:hi].to(torch.int64)).float()
    xi = x[first_segment:first_segment + num_segments].float()
    s = (xi.index_select(0, seg) * xj).sum(-1)
    if fn == "relu":
        s = s.clamp_min(0.0)
    out = torch.zeros((num_segments, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, seg, s[:, None] * xj)
    return out.to(x.dtype)


NEG_INF = -1e30

_INV_LN2 = 1.44269504088896338700e+00
#: ln 2 in two parts (fdlibm's): k * _LN2_HI is exact for |k| < 2^11
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
#: 1/n! for n = 13..0: Horner's coefficients of exp on |r| <= ln2 / 2
_EXP_COEFFS = tuple(1.0 / math.factorial(n) for n in range(13, -1, -1))


def _exp(x: torch.Tensor) -> torch.Tensor:
    """exp of a CPU fp64 tensor from additions, multiplications and a
    rounding alone (``2^k exp(r)``, r = x - k ln2, a degree-13 Taylor
    polynomial; within two fp64 steps of exp), as numpy's single-threaded
    elementwise operations, each one IEEE rounding: the same bits on every
    host, code path and run.  ``torch.exp`` is not: on the CPU it may run
    MKL's vector math, whose bits changed from run to run.  Inputs below
    -708 give exp(-708), zero in fp32.  Not differentiable."""
    a = np.maximum(x.detach().numpy(), -708.0)
    k = np.round(a * _INV_LN2)
    r = (a - k * _LN2_HI) - k * _LN2_LO
    acc = np.full_like(r, _EXP_COEFFS[0])
    for c in _EXP_COEFFS[1:]:
        acc *= r
        acc += c
    # 2^k from the exponent bits, exactly
    return torch.from_numpy(acc * ((k.astype(np.int64) + 1023) << 52)
                            .view(np.float64))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              chunk: int = 512, return_lse: bool = False):
    """Blockwise (flash) attention in the JAX package's layout: q (B,Sq,H,D),
    k (B,Sk,Hkv,D), v (B,Sk,Hkv,Dv), GQA by head groups -> (B,Sq,H,Dv).

    The online-softmax recurrence of the reference's ``blockwise_attention``
    over KV chunks of ``chunk`` rows (the last may be short): scores, m, l
    and the accumulator in fp32, masked scores at -1e30 (causal: key
    position <= query position; ``window``: query - key < window), p cast to
    v's dtype before the PV product, the denominator clamped at 1e-30.

    Both products are the reference's ``preferred_element_type=float32``
    dots: exact products summed in fp32.  bf16 operands on the card go
    through cuBLAS's bf16 x bf16 -> fp32 GEMM (batched over batch and KV
    head, the group's query rows stacked), whose tensor cores sum the
    products as the kernel's wgmma does, so a score near a bf16 rounding
    boundary of p lands on the kernel's side of it; f32 operands on the
    card are summed in fp32.  On the CPU the two products, the
    exponentials and the row sums of p are taken in fp64 and rounded to
    fp32 once (exact for bf16 operands): an fp32 sum there takes the
    order of the host's BLAS and vector code path (MKL's AVX2 and AVX-512
    kernels, ATen's vectorized or scalar reductions), so its bits would
    change from one machine to the next.  The exponentials there come from
    :func:`_exp`, whose bits do not change from run to run, as
    ``torch.exp``'s did.

    With ``return_lse``, ``(out, lse)``: lse (B,H,Sq) fp32 is each row's
    log-sum-exp ``m + log(max(l, 1e-30))``, what the kernel saves for the
    backward (:func:`attention_backward`)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    scale = d ** -0.5
    tensor_cores = q.is_cuda and q.dtype == k.dtype == v.dtype == \
        torch.bfloat16
    # the width of the products and sums (see above): fp64 on the CPU
    wide = torch.float32 if q.is_cuda else torch.float64
    exp = torch.exp if q.is_cuda else _exp
    qg = q.reshape(b, sq, hkv, g, d)
    if tensor_cores:
        # (b, sq, hkv, g, d) -> (b * hkv, g * sq, d)
        q3 = qg.permute(0, 2, 3, 1, 4).reshape(b * hkv, g * sq, d)
    else:
        qg = qg.to(wide)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, sk, chunk):
        kblk = k[:, k0:k0 + chunk]
        vblk = v[:, k0:k0 + chunk]
        kc = kblk.shape[1]
        if tensor_cores:
            s = torch.bmm(q3, kblk.permute(0, 2, 3, 1).reshape(b * hkv, d, kc),
                          out_dtype=torch.float32).view(b, hkv, g, sq, kc)
        else:
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                             kblk.to(wide)).float()
        s = s * scale
        k_pos = torch.arange(k0, k0 + kc, device=q.device)[None]
        mask = torch.ones((sq, kc), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos >= k_pos
        if window is not None:
            mask &= q_pos - k_pos < window
        s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(-1))
        p = exp((s - m_new[..., None]).to(wide)).float()
        alpha = exp((m - m_new).to(wide)).float()
        l = l * alpha + p.to(wide).sum(-1).float()
        if tensor_cores:
            pv = torch.bmm(
                p.to(v.dtype).reshape(b * hkv, g * sq, kc),
                vblk.permute(0, 2, 1, 3).reshape(b * hkv, kc, dv),
                out_dtype=torch.float32).view(b, hkv, g, sq, dv)
        else:
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).to(wide),
                              vblk.to(wide)).float()
        acc = acc * alpha[..., None] + pv
        m = m_new
    denom = torch.clamp(l, min=1e-30)
    out = acc / denom[..., None]
    # (b, hkv, g, sq, dv) -> (b, sq, h, dv)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(
        q.dtype).contiguous()
    if return_lse:
        return out, (m + torch.log(denom)).reshape(b, h, sq)
    return out


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                       *, causal: bool = True, window: Optional[int] = None,
                       chunk: int = 1024, tensor_cores: bool = False) -> tuple:
    """The gradients (dq, dk, dv) of :func:`attention` from its output ``o``,
    the cotangent ``dout`` (both (B,Sq,H,Dv)) and the saved ``lse``
    (B,H,Sq): the FlashAttention-2 recurrence the backward kernels compute,
    written out (not autograd through :func:`attention`) --
    ``P = exp(scale * q k^T - lse)`` under the masks, ``delta =
    rowsum(dout * o)``, ``dS = P (dout v^T - delta)``, ``dq = scale dS k``,
    ``dk = scale dS^T q`` and ``dv = P^T dout``, the GQA group's query heads
    summed into their KV head -- over query chunks of ``chunk`` rows so a
    long sequence never holds a whole (Sq, Sk) score matrix; each gradient
    cast to its input's dtype once.

    Every product is exact and summed in fp32 (on the card
    ``torch.backends.cuda.matmul.allow_tf32`` must be off).  P and dS stay
    fp32 -- the SIMT kernels' arithmetic -- unless ``tensor_cores``, the
    wgmma kernels' (bf16 inputs only): P and dS are rounded to bf16 before
    the products that take them
    (dV = P^T dO, dQ = dS K, dK = dS^T Q), as the tensor cores take them,
    and on the card every product of bf16 operands goes through cuBLAS's
    bf16 x bf16 -> fp32 GEMM (``torch.bmm(..., out_dtype=torch.float32)``),
    whose tensor cores sum as wgmma sums, so S and dP are summed as the
    kernels sum them.  P is ``exp(S * scale - lse)`` in both modes, the
    kernels' fp32 steps and their ``expf``; delta is summed in the rows
    kernel's order (:func:`_rows_delta`); the keys are padded with zeros
    to a multiple of 8, masked, so cuBLAS takes the same tensor-core path
    at every length (at a ragged key count it takes another, whose sums
    of S and dP round differently)."""
    if tensor_cores and not q.dtype == k.dtype == v.dtype == dout.dtype == \
            torch.bfloat16:
        raise ValueError(f"tensor_cores: the wgmma backward takes bf16, got "
                         f"{q.dtype}")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    scale = d ** -0.5
    on_tc = tensor_cores and q.is_cuda

    def mm(x, y):         # (n, i, j) @ (n, j, l) -> fp32 (n, i, l)
        if on_tc:
            return torch.bmm(x, y, out_dtype=torch.float32)
        return torch.bmm(x.float(), y.float())

    def heads_first(t, width):    # (b, s, h, e) -> (b, hkv, g, s, e)
        return t.reshape(b, t.shape[1], hkv, g, width).permute(0, 2, 3, 1, 4)

    def keys_padded(t, width):    # (b, sk, hkv, e) -> (b * hkv, skp, e)
        out = t.new_zeros((b * hkv, skp, width))
        out[:, :sk] = t.permute(0, 2, 1, 3).reshape(b * hkv, sk, width)
        return out
    skp = -(-sk // 8) * 8
    qh, doh = heads_first(q, d), heads_first(dout, dv)
    kh, vh = keys_padded(k, d), keys_padded(v, dv)
    lse_g = lse.float().reshape(b, hkv, g, sq)
    delta = _rows_delta(o, dout).reshape(b, sq, hkv, g).permute(0, 2, 3, 1)
    dq = torch.empty((b, hkv, g, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b * hkv, skp, d), dtype=torch.float32, device=q.device)
    dvv = torch.zeros((b * hkv, skp, dv), dtype=torch.float32,
                      device=q.device)
    k_pos = torch.arange(skp, device=q.device)[None]
    for q0 in range(0, sq, chunk):
        c = min(chunk, sq - q0)
        qc = qh[:, :, :, q0:q0 + c].reshape(b * hkv, g * c, d)
        doc = doh[:, :, :, q0:q0 + c].reshape(b * hkv, g * c, dv)
        q_pos = torch.arange(q0, q0 + c, device=q.device)[:, None]
        mask = (k_pos < sk).expand(c, skp).clone()
        if causal:
            mask &= q_pos >= k_pos
        if window is not None:
            mask &= q_pos - k_pos < window
        s = mm(qc, kh.transpose(1, 2)).view(b, hkv, g, c, skp) * scale
        p = torch.where(mask, torch.exp(s - lse_g[..., q0:q0 + c, None]),
                        0.0)
        dp = mm(doc, vh.transpose(1, 2)).view(b, hkv, g, c, skp)
        ds = p * (dp - delta[..., q0:q0 + c, None])
        if tensor_cores:
            p, ds = p.to(q.dtype), ds.to(q.dtype)
        p = p.reshape(b * hkv, g * c, skp)
        ds = ds.reshape(b * hkv, g * c, skp)
        dq[:, :, :, q0:q0 + c] = (mm(ds, kh) * scale).view(b, hkv, g, c, d)
        dk += mm(ds.transpose(1, 2), qc)
        dvv += mm(p.transpose(1, 2), doc)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    dk = (dk[:, :sk] * scale).view(b, hkv, sk, d).permute(0, 2, 1, 3)
    dvv = dvv[:, :sk].reshape(b, hkv, sk, dv).permute(0, 2, 1, 3)
    return dq, dk.to(k.dtype), dvv.to(v.dtype)


def _rows_delta(o: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dout * o)`` (B, Sq, H) in fp32, summed in the order
    of the backward's rows kernel: lane ``j`` of a warp adds the products
    at ``j, j + 32, ...`` in turn, then the 32 lanes meet in a butterfly
    (``acc += acc[lane ^ off]`` for off = 16, 8, 4, 2, 1).  For bf16
    inputs these are the kernel's bits (its ``fmaf`` adds an exact
    product); for fp32 ones the kernel rounds each step once less."""
    b, sq, h, dv = o.shape
    width = -(-dv // 32) * 32
    x = torch.zeros((b, sq, h, width), dtype=torch.float32, device=o.device)
    x[..., :dv] = o.float() * dout.float()
    x = x.view(b, sq, h, width // 32, 32)
    acc = x[..., 0, :]
    for j in range(1, width // 32):
        acc = acc + x[..., j, :]
    lanes = torch.arange(32, device=o.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ off]
    return acc[..., 0]
