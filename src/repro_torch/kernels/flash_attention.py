"""Flash attention on Hopper: the wrapper of ``ember_flash_attention``
(``csrc/ember_flash_attention.cu``), which replaces the TPU kernel
``flash_attention`` / ``_flash_kernel`` of
``src/repro/kernels/flash_attention.py`` and computes the reference's
``blockwise_attention`` (``src/repro/models/attention.py``), its sliding
window band included.

Layout as in the JAX package: q (B,Sq,H,D), k (B,Sk,Hkv,D) and v
(B,Sk,Hkv,Dv), GQA by head groups; Dv = D except in DeepSeek's MLA prefill
(D = 192: 128 no-rotary and 64 rotary columns; Dv = 128).  A call whose
tensors lie on the CPU runs the plain version
(:func:`repro_torch.kernels.ref.attention`); a CUDA call launches the kernel
or raises -- nothing falls back; a call on meta tensors (the dry run) makes
the outputs' shapes after the kernel's own checks and reports its bytes
(:func:`.sls.meta_launch`).  The dtype picks the kernel: bf16 runs the
tensor-core kernel (wgmma fed by TMA; 128-key tiles, 64 at D = 256), f32
the scalar fp32 kernel (64-key tiles).  ``flash_attention_cuda.launches``
counts the kernel launches and ``flash_attention_cuda.instances`` the same
launches by dtype, widths, causal and window (:func:`instance`).

The backward (``ember_flash_attention_bwd``, ``csrc/ember_flash_backward.cu``)
has no TPU counterpart: the reference differentiates ``blockwise_attention``
with ``jax.grad``.  :class:`FlashAttention` pairs the forward, which then
also saves each row's log-sum-exp, with :func:`flash_attention_bwd_cuda`;
:func:`flash_attention` (``kernels.ops.attention``) goes through it whenever
q, k or v need a gradient.  Called directly under autograd, the kernel
wrappers raise: their outputs carry no ``grad_fn``.  The backward has two
variants, chosen from the dtype and widths by :func:`backward_variant`:
``wgmma`` (bf16 at (64, 64), (80, 80), (128, 128): tensor cores fed by TMA,
P and dS taken as bf16) and ``simt`` (scalar fp32, everything else but
(112, 112), whose backward is not written: ROADMAP.md, K1); each has its
plain version (:func:`plain_backward`).
"""
from __future__ import annotations

import collections
from typing import Optional

import torch

from . import _build, ref
from .sls import DTYPES, meta_launch, one_device, refuse_autograd

#: the (q/k width, v width) pairs with a kernel; (80, 80) and (112, 112) run
#: the (128, 128) kernel on zero-padded columns (csrc/ember_flash_attention.cu)
HEAD_DIMS = ((64, 64), (80, 80), (112, 112), (128, 128), (192, 128),
             (256, 256))
#: the pairs whose backward is not written yet (ROADMAP.md, K1): the
#: backward refuses them before any launch
NO_BACKWARD_DIMS = ((112, 112),)
#: the f32 kernel's KV tile (kF32BK), and the bf16 kernel's (wg_kv_tile):
#: 128 keys, 64 at q/k width 256; the built library reports them
#: (``ember_flash_kv_tile``), and the checks on the card hold the two equal
#: (chip_smoke.py phase 2, test_torch_cuda.py)
_F32_KV_TILE = 64
#: the (q/k, v) widths of the backward's wgmma variant (bf16); the others,
#: and f32, run the SIMT variant, whose two fp32 accumulators of the full
#: width would not fit a warpgroup's registers at (192, 128) and (256, 256)
WGMMA_BACKWARD_DIMS = ((64, 64), (80, 80), (128, 128))
#: the C entry's variant codes
_BACKWARD_VARIANTS = {"simt": 0, "wgmma": 1}


def kv_tile(dtype: torch.dtype, head_dim: int) -> int:
    """The KV tile of the kernel that runs ``dtype`` at q/k width
    ``head_dim``: the plain version with ``chunk=kv_tile(dtype, head_dim)``
    rounds p against the same running max."""
    if dtype not in DTYPES:
        raise ValueError(f"no flash kernel for {dtype}")
    if head_dim not in {d for d, _ in HEAD_DIMS}:
        raise ValueError(f"no flash kernel at q/k width {head_dim}")
    if dtype == torch.float32:
        return _F32_KV_TILE
    return 64 if head_dim == 256 else 128


def instance(q: torch.Tensor, v: torch.Tensor, causal: bool,
             window: Optional[int]) -> str:
    """The key of a launch in ``flash_attention_cuda.instances``: dtype,
    (q/k, v) widths, causal or not, and the window if the kernel masks
    one, e.g. ``"bfloat16 256/256 causal window 1024"``."""
    key = f"{str(q.dtype).split('.')[-1]} {q.shape[3]}/{v.shape[3]}"
    if causal:
        key += " causal"
    if window:
        key += f" window {window}"
    return key


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: Optional[int]) -> None:
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
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


def _kernel_window(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: Optional[int]) -> int:
    """The window the kernels take (0: none; a window of Sq or more masks
    nothing, q - k <= Sq - 1), after the checks only the kernels need:
    every query row keeps a key, and (D, Dv) is one of :data:`HEAD_DIMS`."""
    sq, sk = q.shape[1], k.shape[1]
    win = window if window is not None and window < sq else 0
    if win and sq - win >= sk:
        raise ValueError(f"window {win}: query rows past {sk + win - 1} "
                         f"keep no key of {sk}")
    if (q.shape[3], v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"head dims (q/k {q.shape[3]}, v {v.shape[3]}) not "
                         f"among the kernel's {HEAD_DIMS}")
    return win


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         chunk: int = 512, return_lse: bool = False):
    """softmax(q k^T * D^-1/2, causal) v per head, KV head ``h // (H/Hkv)``
    for query head h -> (B,Sq,H,Dv) in q's dtype.

    A ``window`` keeps the keys with ``q - k < window`` (the reference's
    band); it must be positive, and on the card every query row must keep a
    key (``Sq - window < Sk``); a window of Sq or more masks nothing and
    runs as none.  ``chunk`` is the KV chunk of the plain version's
    recurrence (it decides only the fp32 summation order); the kernel
    streams its own :func:`kv_tile` rows.  On the card a (D, Dv) pair
    outside :data:`HEAD_DIMS` raises; bf16 tensors must be 16-byte aligned
    (TMA reads them).

    With ``return_lse``, ``(out, lse)``: lse (B,H,Sq) fp32, each row's
    log-sum-exp, for :func:`flash_attention_bwd_cuda`; without it the
    kernel writes no lse (the serving path).  On the card it raises under
    autograd where q, k or v need a gradient (:func:`flash_attention`
    takes that path)."""
    _check_qkv(q, k, v, window)
    b, sq, h, d = q.shape
    dev = one_device(q, k, v, meta=True)
    if dev.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window,
                             chunk=chunk, return_lse=return_lse)
    refuse_autograd("ember_flash_attention", q, k, v)
    sk = k.shape[1]
    win = _kernel_window(q, k, v, window)
    dv = v.shape[3]
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=dev)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    if dev.type == "meta":
        meta_launch("flash_attention", (q, k, v), (out, lse))
        return (out, lse) if return_lse else out
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v, out)):
        raise ValueError("bf16 flash attention reads q, k and v by TMA: "
                         "their data must be 16-byte aligned")
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    hkv = k.shape[2]
    with torch.cuda.device(dev):
        err = _build.library().ember_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, h, hkv, d, dv, DTYPES[q.dtype], int(causal), win, d ** -0.5,
            None if lse is None else lse.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ember_flash_attention")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.instances[instance(q, v, causal, win)] += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0
flash_attention_cuda.instances = collections.Counter()


def backward_variant(dtype: torch.dtype, head_dim: int,
                     v_head_dim: int) -> str:
    """Which backward kernels run ``dtype`` at (q/k, v) widths (``head_dim``,
    ``v_head_dim``): "wgmma" for bf16 at :data:`WGMMA_BACKWARD_DIMS`, else
    "simt".  The one place the variant is decided, from the shapes, before
    the launch: a wrapper never switches variant after a build or launch
    error.  Raises NotImplementedError at :data:`NO_BACKWARD_DIMS`, on the
    card and on the CPU alike."""
    if (head_dim, v_head_dim) in NO_BACKWARD_DIMS:
        raise NotImplementedError(
            f"the flash backward at head dims ({head_dim}, {v_head_dim}) is "
            f"not written yet (ROADMAP.md, K1: the forward runs them on the "
            f"padded (128, 128) kernel, the backward has no variant there)")
    if dtype == torch.bfloat16 and (head_dim, v_head_dim) in \
            WGMMA_BACKWARD_DIMS:
        return "wgmma"
    return "simt"


def plain_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
                   causal: bool = True, window: Optional[int] = None,
                   variant: Optional[str] = None) -> tuple:
    """The plain version of the backward ``variant`` (by default the one
    :func:`backward_variant` picks for these tensors):
    :func:`repro_torch.kernels.ref.attention_backward`, with P and dS
    rounded to bf16 as the tensor cores take them for "wgmma"."""
    variant = variant or backward_variant(q.dtype, q.shape[3], v.shape[3])
    if variant not in _BACKWARD_VARIANTS:
        raise ValueError(f"no flash backward variant {variant!r}")
    return ref.attention_backward(q, k, v, o, dout, lse, causal=causal,
                                  window=window,
                                  tensor_cores=variant == "wgmma")


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None) -> tuple:
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention_cuda` at
    q, k, v, from its output ``o``, the cotangent ``dout`` (both
    (B,Sq,H,Dv), in q's dtype) and the ``lse`` it saved (B,H,Sq) fp32.

    CPU tensors run the plain version of the variant the card would run
    (:func:`plain_backward`); CUDA tensors launch
    ``ember_flash_attention_bwd``'s :func:`backward_variant` (three passes:
    the lse/delta rows, dK/dV, dQ; deterministic) or raise -- for the
    wgmma variant, also where q, k, v or dout are not 16-byte aligned (TMA
    reads them).  ``flash_attention_bwd_cuda.launches`` counts the calls
    that launched, ``.variants`` the same by variant and ``.instances`` by
    :func:`instance`."""
    _check_qkv(q, k, v, window)
    b, sq, h, d = q.shape
    dv = v.shape[3]
    for name, t, shape, dtype in (("o", o, (b, sq, h, dv), q.dtype),
                                  ("dout", dout, (b, sq, h, dv), q.dtype),
                                  ("lse", lse, (b, h, sq), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                             f"shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    dev = one_device(q, k, v, o, dout, lse, meta=True)
    variant = backward_variant(q.dtype, d, dv)
    if dev.type == "cpu":
        return plain_backward(q, k, v, o, dout, lse, causal=causal,
                              window=window, variant=variant)
    refuse_autograd("ember_flash_attention_bwd", q, k, v, o, dout)
    win = _kernel_window(q, k, v, window)
    if dev.type == "meta":
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        meta_launch("flash_attention_bwd", (q, k, v, o, dout, lse), grads)
        return grads
    if variant == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v, dout)):
        raise ValueError("the wgmma flash backward reads q, k, v and dout by "
                         "TMA: their data must be 16-byte aligned")
    dq, dk, dvv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0 or dk.numel() == 0:
        return dq, dk.zero_(), dvv.zero_()
    launch_backward(variant, q, k, v, o, dout, lse, (dq, dk, dvv),
                    causal=causal, window=win)
    return dq, dk, dvv


def launch_backward(variant: str, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, o: torch.Tensor, dout: torch.Tensor,
                    lse: torch.Tensor, grads: tuple, *, causal: bool,
                    window: int) -> None:
    """Launch the backward's ``variant`` ("wgmma" or "simt") into ``grads``
    = (dq, dk, dv) on the current stream, and count it.  The one launch
    path of :func:`flash_attention_bwd_cuda`, which has checked the
    arguments, chosen the variant and resolved the kernels' ``window`` (0:
    none); called directly only to time one variant against the other on
    the same inputs.  Raises on a build or launch error, and where the
    variant does not take the arguments."""
    if variant not in _BACKWARD_VARIANTS:
        raise ValueError(f"no flash backward variant {variant!r}")
    b, sq, h, d = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    dq, dk, dvv = grads
    lib = _build.library()
    with torch.cuda.device(q.device):
        # per (b, h): a row of lse and one of delta, padded (C entry)
        rows = torch.empty((b, h, 2, lib.ember_flash_bwd_rows(sq)),
                           dtype=torch.float32, device=q.device)
        err = lib.ember_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), rows.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dvv.data_ptr(), b, sq, sk, h, hkv, d, dv,
            DTYPES[q.dtype], int(causal), window, d ** -0.5,
            _BACKWARD_VARIANTS[variant],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"ember_flash_attention_bwd ({variant})")
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.variants[variant] += 1
    flash_attention_bwd_cuda.instances[instance(q, v, causal, window)] += 1


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.variants = dict.fromkeys(_BACKWARD_VARIANTS, 0)
flash_attention_bwd_cuda.instances = collections.Counter()


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward kernel saving each
    row's log-sum-exp, :func:`flash_attention_bwd_cuda` for the gradients
    of q, k and v (the plain versions of both on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                chunk: int):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, chunk=chunk,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    chunk: int = 512) -> torch.Tensor:
    """:func:`flash_attention_cuda`'s function, differentiable: through
    :class:`FlashAttention` where grad mode is on and q, k or v need a
    gradient, else the forward alone (no lse; the serving path, whose bits
    this leaves as they were).  Widths without a backward
    (:data:`NO_BACKWARD_DIMS`) raise there before the forward runs."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        backward_variant(q.dtype, q.shape[3], v.shape[3])
        return FlashAttention.apply(q, k, v, causal, window, chunk)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                chunk=chunk)
