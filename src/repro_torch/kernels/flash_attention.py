"""Flash attention on Hopper: the wrapper of ``ember_flash_attention``
(``csrc/ember_flash_attention.cu``), which replaces the TPU kernel
``flash_attention`` / ``_flash_kernel`` of
``src/repro/kernels/flash_attention.py`` and computes the reference's
``blockwise_attention`` (``src/repro/models/attention.py``).

Layout as in the JAX package: q (B,Sq,H,D), k (B,Sk,Hkv,D) and v
(B,Sk,Hkv,Dv), GQA by head groups; Dv = D except in DeepSeek's MLA prefill
(D = 192: 128 no-rotary and 64 rotary columns; Dv = 128).  A call whose
tensors lie on the CPU runs the plain version
(:func:`repro_torch.kernels.ref.attention`); a CUDA call launches the kernel
or raises -- nothing falls back.  The dtype picks the kernel: bf16 runs the
tensor-core kernel (wgmma fed by TMA, 128-key tiles), f32 the scalar fp32
kernel (64-key tiles).  ``flash_attention_cuda.launches`` counts the kernel
launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref
from .sls import DTYPES, one_device

#: the (q/k width, v width) pairs with a kernel; (80, 80) runs the (128, 128)
#: kernel on zero-padded columns (csrc/ember_flash_attention.cu)
HEAD_DIMS = ((64, 64), (80, 80), (128, 128), (192, 128))
#: each kernel's KV tile: kBK and kF32BK in csrc/ember_flash_attention.cu,
#: which the built library reports (``ember_flash_kv_tile``); the checks on
#: the card hold the two equal (chip_smoke.py phase 2, test_torch_cuda.py)
_KV_TILES = {torch.bfloat16: 128, torch.float32: 64}


def kv_tile(dtype: torch.dtype) -> int:
    """The KV tile of the kernel that runs ``dtype``: the plain version with
    ``chunk=kv_tile(dtype)`` rounds p against the same running max."""
    if dtype not in _KV_TILES:
        raise ValueError(f"no flash kernel for {dtype}")
    return _KV_TILES[dtype]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         chunk: int = 512) -> torch.Tensor:
    """softmax(q k^T * D^-1/2, causal) v per head, KV head ``h // (H/Hkv)``
    for query head h -> (B,Sq,H,Dv) in q's dtype.

    ``chunk`` is the KV chunk of the plain version's recurrence (it decides
    only the fp32 summation order); the kernel streams its own
    :func:`kv_tile` rows.  On the card, a sliding ``window`` has no kernel
    yet (ROADMAP.md, Queue 1 item 3) and raises, as does a (D, Dv) pair
    outside :data:`HEAD_DIMS`; bf16 tensors must be 16-byte aligned (TMA
    reads them)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or t.dtype not in DTYPES or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D float32 or "
                             f"bfloat16 tensor, got {t.dtype} of shape "
                             f"{tuple(t.shape)}")
    b, sq, h, d = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d or \
            k.shape[2] == 0 or h % k.shape[2] or \
            not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} ({q.dtype}, {k.dtype}, "
                         f"{v.dtype}) are not one GQA attention")
    dev = one_device(q, k, v)
    if dev.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window,
                             chunk=chunk)
    if window is not None:
        raise NotImplementedError(
            "sliding-window attention has no Hopper kernel yet (ROADMAP.md, "
            "Queue 1 item 3: the dense_local block kind)")
    dv = v.shape[3]
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"head dims (q/k {d}, v {dv}) not among the "
                         f"kernel's {HEAD_DIMS}")
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=dev)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v, out)):
        raise ValueError("bf16 flash attention reads q, k and v by TMA: "
                         "their data must be 16-byte aligned")
    if out.numel() == 0:
        return out
    sk, hkv = k.shape[1], k.shape[2]
    with torch.cuda.device(dev):
        err = _build.library().ember_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, h, hkv, d, dv, DTYPES[q.dtype], int(causal), d ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ember_flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
