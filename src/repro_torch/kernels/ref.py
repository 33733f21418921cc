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

from typing import Optional

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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              chunk: int = 512) -> torch.Tensor:
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
    boundary of p lands on the kernel's side of it; elsewhere the operands
    are cast to fp32."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    scale = d ** -0.5
    tensor_cores = q.is_cuda and q.dtype == k.dtype == v.dtype == \
        torch.bfloat16
    qg = q.reshape(b, sq, hkv, g, d)
    if tensor_cores:
        # (b, sq, hkv, g, d) -> (b * hkv, g * sq, d)
        q3 = qg.permute(0, 2, 3, 1, 4).reshape(b * hkv, g * sq, d)
    else:
        qg = qg.float()
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
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kblk.float())
        s = s * scale
        k_pos = torch.arange(k0, k0 + kc, device=q.device)[None]
        mask = torch.ones((sq, kc), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos >= k_pos
        if window is not None:
            mask &= q_pos - k_pos < window
        s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        if tensor_cores:
            pv = torch.bmm(
                p.to(v.dtype).reshape(b * hkv, g * sq, kc),
                vblk.permute(0, 2, 1, 3).reshape(b * hkv, kc, dv),
                out_dtype=torch.float32).view(b, hkv, g, sq, dv)
        else:
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(),
                              vblk.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    # (b, hkv, g, sq, dv) -> (b, sq, h, dv)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)
