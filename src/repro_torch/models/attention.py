"""Attention layers (counterpart of ``repro/models/attention.py``; ported
so far: :func:`blockwise_attention`, :func:`init_attn`, :func:`attn_forward`,
decode with a KV cache -- :func:`decode_attention`, :func:`slot_update`,
:func:`attn_decode`, :func:`init_kv_cache` and the int8 cache's
:func:`_quant_kv` / :func:`_dequant_kv` -- and DeepSeek's multi-head latent
attention: :func:`init_mla`, :func:`mla_forward`, :func:`mla_decode` and
:func:`init_mla_cache`).

:func:`blockwise_attention` is the reference's online-softmax attention over
KV chunks.  Here it is one call to ``kernels.ops.attention``: the
hand-written flash kernel on CUDA tensors, its plain version (the same
recurrence, chunk by chunk) on CPU tensors.

Decode attention is a stock-op product in the reference too (an einsum, no
Pallas kernel); here it is two batched products whose bf16 operands are
summed in fp32 on the card (``torch.bmm(..., out_dtype=torch.float32)``),
as the reference's ``preferred_element_type=float32`` dots are.

**Cache layout.**  A layer's cache is a dict of tensors ``k``, ``v``
(B, Hkv, Smax, hd) -- head-major, so each head's keys are one matrix for
the batched products -- and ``len`` (B,) int32; the int8 cache adds
``k_scale``, ``v_scale`` (B, Hkv, Smax) fp32.  The reference's layout is
(B, Smax, Hkv, hd); ``repro_torch.convert.caches_to_reference`` /
``caches_from_reference`` map one onto the other.  Decode writes the cache
in place (:func:`slot_update`) instead of rebuilding it.

An MLA layer's cache is the latent ``c`` (B, Smax, r) and the shared rotary
key ``kr`` (B, Smax, rd), in the reference's own layout, and ``len`` (B,);
:func:`mla_decode` writes it in place too (:func:`_seq_rows`).  MLA's
prefill runs the flash kernel with q/k width ``hd + rd`` (192 in
DeepSeek-V2-Lite) and v width ``hd`` (128).

The sliding-window band is still to port (ROADMAP.md, Queue 1 item 3).

Decode issues no host read, builds no tensor from host data and allocates
nothing whose size depends on values, so a served micro-step can be
captured in a CUDA graph (``runtime.server.WaveGraph``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import ops as kops
from .common import ModelConfig, apply_rope, dense_init, pick_chunk, \
    rope_freqs

NEG_INF = -1e30


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


# ---------------------------------------------------------------------------
# Decode with a KV cache
# ---------------------------------------------------------------------------

def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product of exact operand products summed in fp32: bf16 on
    the card through cuBLAS's bf16 x bf16 -> fp32 GEMM, anything else in
    fp32."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """q (B,1,H,D); caches (B,Hkv,Smax,D) (head-major); cache_len (B,) the
    per-slot valid lengths including the new token -> (B,1,H,D).

    Scores and the PV sum in fp32, p cast to the cache's dtype before the
    PV product, one cast to q's dtype at the end -- the reference's
    ``decode_attention`` (which takes (B,Smax,Hkv,D) caches)."""
    b, _, h, d = q.shape
    hkv, smax = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    # query heads kv * g + j share KV head kv: (b*hkv, g, d)
    qg = q.reshape(b * hkv, g, d)
    s = _bmm_f32(qg, k_cache.reshape(b * hkv, smax, d).transpose(1, 2))
    s = s.view(b, hkv, g, smax) * d ** -0.5
    cl = cache_len.to(torch.int64).expand(b)
    pos = torch.arange(smax, device=q.device)
    mask = pos[None, :] < cl[:, None]
    if window is not None:
        mask &= pos[None, :] >= cl[:, None] - window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = _bmm_f32(p.to(v_cache.dtype).view(b * hkv, g, smax),
                   v_cache.reshape(b * hkv, smax, d))
    return out.view(b, 1, h, d).to(q.dtype)


def _slot_rows(cache: torch.Tensor, pos: torch.Tensor) -> tuple:
    """Index pair addressing row ``pos[b]`` of slot b in a (B, Hkv, Smax,
    ...) cache; a position past the end addresses the last row, as the
    reference's ``dynamic_update_slice`` clamps its start."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    return rows, pos.to(torch.int64).clamp(max=cache.shape[2] - 1)


def slot_update(cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """Per-slot cache write, in place: ``new`` (B, Hkv, ...) lands in row
    ``pos[b]`` of slot b of ``cache`` (B, Hkv, Smax, ...).  Returns
    ``cache``."""
    rows, at = _slot_rows(cache, pos)
    cache[rows, :, at] = new.to(cache.dtype)
    return cache


def attn_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: dict, *,
                window: Optional[int] = None,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B,1,D) -> (B,1,D), updating ``cache`` in place (see the module
    docstring): row ``len[b]`` of slot b gets the new K/V, and ``len`` grows
    by one.

    With an ``active`` mask (B,) bool, only the active slots keep the new
    row and advance ``len``: the inactive slots' rows are saved before the
    write and put back after the attention has read the cache.  That is
    the reference's ``jnp.where(active, new, old)`` over the whole cache,
    one row per slot, and every slot's output -- the inactive ones' too --
    is the reference's."""
    b = x.shape[0]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    pos = cache["len"].expand(b)
    q = (x @ p["wq"]).reshape(b, 1, h, hd)
    k = (x @ p["wk"]).reshape(b, 1, hkv, hd)
    v = (x @ p["wv"]).reshape(b, 1, hkv, hd)
    cos, sin = rope_freqs(pos[:, None].float(), hd, cfg.rope_theta,
                          cfg.rotary_pct)
    q = apply_rope(q, cos, sin, cfg.rotary_pct)
    k = apply_rope(k, cos, sin, cfg.rotary_pct)[:, 0]    # (B, Hkv, hd)
    v = v[:, 0]
    if "k_scale" in cache:   # int8 quantized cache
        new = dict(zip(("k", "k_scale"), _quant_kv(k)))
        new.update(zip(("v", "v_scale"), _quant_kv(v)))
    else:
        new = {"k": k, "v": v}
    rows, at = _slot_rows(cache["k"], pos)
    old = ({n: cache[n][rows, :, at] for n in new}
           if active is not None else None)
    for n, t in new.items():
        cache[n][rows, :, at] = t.to(cache[n].dtype)
    if "k_scale" in cache:
        kd = _dequant_kv(cache["k"], cache["k_scale"], x.dtype)
        vd = _dequant_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        kd, vd = cache["k"], cache["v"]
    o = decode_attention(q, kd, vd, pos + 1, window=window)
    if active is None:
        cache["len"] += 1
    else:
        for n, t in new.items():
            keep = active.view((b,) + (1,) * (t.dim() - 1))
            cache[n][rows, :, at] = torch.where(keep, t.to(cache[n].dtype),
                                                old[n])
        cache["len"] += active.to(cache["len"].dtype)
    return o.reshape(b, 1, h * hd) @ p["wo"]


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device=None) -> dict:
    """One layer's empty cache; ``len`` is per slot, so the serving loop
    admits and retires requests slot by slot."""
    hkv, hd = cfg.num_kv_heads, cfg.hd
    shape = (batch, hkv, max_len, hd)
    cache = {"len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.kv_cache_dtype == "int8":
        # per-(token, head) block-scaled int8 K/V
        cache.update(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:3], dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(shape[:3], dtype=torch.float32,
                                device=device))
    else:
        cache.update(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))
    return cache


def _quant_kv(x: torch.Tensor):
    """x (..., hd) -> int8 values + a per-(token, head) fp32 scale."""
    xf = x.float()
    scale = (xf.abs().amax(-1) / 127.0).clamp_min(1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dequant_kv(q: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# DeepSeek MLA (multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(gen: Optional[torch.Generator], cfg: ModelConfig,
             dtype: torch.dtype, device=None) -> dict:
    d, h, hd, r = cfg.d_model, cfg.num_heads, cfg.hd, cfg.kv_lora_rank
    rd = cfg.rope_head_dim
    return {
        "wq": dense_init(gen, (d, h * (hd + rd)), dtype, device),
        "w_dkv": dense_init(gen, (d, r), dtype, device),
        "w_uk": dense_init(gen, (r, h * hd), dtype, device),
        "w_uv": dense_init(gen, (r, h * hd), dtype, device),
        "w_kr": dense_init(gen, (d, rd), dtype, device),
        "wo": dense_init(gen, (h * hd, d), dtype, device),
    }


def mla_forward(p, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D): queries of ``hd`` no-rotary and ``rd`` rotary
    columns per head; keys and values expanded from the latent ``c = x
    W_dkv``, the rotary key ``kr`` shared by every head; causal attention
    with q/k width ``hd + rd``, v width ``hd`` and scale (hd + rd)^-1/2."""
    b, s, _ = x.shape
    h, hd, rd = cfg.num_heads, cfg.hd, cfg.rope_head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd + rd)
    qn, qr = q[..., :hd], q[..., hd:]
    c = x @ p["w_dkv"]                                 # (b,s,r) latent KV
    kn = (c @ p["w_uk"]).reshape(b, s, h, hd)
    v = (c @ p["w_uv"]).reshape(b, s, h, hd)
    kr = (x @ p["w_kr"]).reshape(b, s, 1, rd)
    cos, sin = rope_freqs(positions, rd, cfg.rope_theta)
    qr = apply_rope(qr, cos, sin)
    kr = apply_rope(kr, cos, sin)
    qf = torch.cat([qn, qr], dim=-1)
    kf = torch.cat([kn, kr.expand(b, s, h, rd)], dim=-1)
    chunk = pick_chunk(s, min(cfg.attn_chunk, s))
    o = blockwise_attention(qf, kf, v.contiguous(), causal=True, chunk=chunk)
    return o.reshape(b, s, h * hd) @ p["wo"]


def _seq_rows(cache: torch.Tensor, pos: torch.Tensor) -> tuple:
    """Index pair addressing row ``pos[b]`` of slot b in a (B, Smax, ...)
    cache (the reference's layout, which MLA's latent cache keeps); a
    position past the end addresses the last row, as the reference's
    ``dynamic_update_slice`` clamps its start."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    return rows, pos.to(torch.int64).clamp(max=cache.shape[1] - 1)


def mla_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: dict, *,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B,1,D) -> (B,1,D), updating the latent cache in place: row
    ``len[b]`` of slot b gets the new ``c`` and ``kr``, and ``len`` grows by
    one (only for the active slots under an ``active`` mask, whose inactive
    rows are put back after the attention has read them, as
    :func:`attn_decode` does).

    The reference's order of products: ``kn = c W_uk`` and ``v = c W_uv``
    over the whole cache, scores ``(qn·kn + qr·kr)·(hd + rd)^-1/2`` in x's
    dtype, masked at -1e30 past each slot's length, softmax in fp32, the
    probabilities cast to v's dtype for the PV product."""
    b = x.shape[0]
    h, hd, rd, r = cfg.num_heads, cfg.hd, cfg.rope_head_dim, \
        cfg.kv_lora_rank
    pos = cache["len"].expand(b)
    q = (x @ p["wq"]).reshape(b, 1, h, hd + rd)
    qn, qr = q[..., :hd], q[..., hd:]
    c = x @ p["w_dkv"]
    kr = (x @ p["w_kr"]).reshape(b, 1, 1, rd)
    cos, sin = rope_freqs(pos[:, None].float(), rd, cfg.rope_theta)
    qr = apply_rope(qr, cos, sin)
    kr = apply_rope(kr, cos, sin)
    new = {"c": c.reshape(b, r), "kr": kr.reshape(b, rd)}
    rows, at = _seq_rows(cache["c"], pos)
    old = ({n: cache[n][rows, at] for n in new}
           if active is not None else None)
    for n, t in new.items():
        cache[n][rows, at] = t.to(cache[n].dtype)
    c_cache, kr_cache = cache["c"], cache["kr"]
    smax = c_cache.shape[1]
    kn = torch.einsum("bsr,rhd->bshd", c_cache, p["w_uk"].reshape(r, h, hd))
    sc = (torch.einsum("bqhd,bshd->bhqs", qn, kn) +
          torch.einsum("bqhd,bsd->bhqs", qr, kr_cache)) * (hd + rd) ** -0.5
    mask = torch.arange(smax, device=x.device)[None, :] <= pos[:, None]
    sc = torch.where(mask[:, None, None, :], sc, NEG_INF)
    pr = torch.softmax(sc.float(), dim=-1)
    v = torch.einsum("bsr,rhd->bshd", c_cache, p["w_uv"].reshape(r, h, hd))
    o = torch.einsum("bhqs,bshd->bqhd", pr.to(v.dtype), v)
    if active is None:
        cache["len"] += 1
    else:
        for n, t in new.items():
            keep = active.view((b,) + (1,) * (t.dim() - 1))
            cache[n][rows, at] = torch.where(keep, t.to(cache[n].dtype),
                                             old[n])
        cache["len"] += active.to(cache["len"].dtype)
    return o.reshape(b, 1, h * hd) @ p["wo"]


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype, device=None) -> dict:
    """One MLA layer's empty latent cache: ``c`` (B, Smax, r), ``kr`` (B,
    Smax, rd) and the per-slot ``len``."""
    return {"c": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                             dtype=dtype, device=device),
            "kr": torch.zeros((batch, max_len, cfg.rope_head_dim),
                              dtype=dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
