"""How closely a kernel's bf16 output must agree with its plain version.

A hand-written kernel and its plain version (:mod:`.ref`) do the same fp32
arithmetic and differ only in the order of their fp32 sums.  (For attention
that holds when the plain version's KV chunk is the kernel's tile,
:func:`.flash_attention.kv_tile`, so both round p to bf16 against the same
running max, and when both sum the bf16 products of the scores on the
tensor cores, as the plain version does on the card, so both round the
same p: a score summed in another order can round a p across a bf16 step,
which moves a few-key row's output by several steps.)  Each rounds its
fp32 result to bf16 once.  So:

* an element may differ by one bf16 step, 2^-7 of its size; ``atol`` covers
  results that cancel to near 0;
* few elements differ at all: at most 1 %;
* the relative L2 error stays below 2^-9, less than rounding every element
  to bf16 once more would add.

A fault that moves each result by less than a bf16 step -- p left
unrounded, a key tile dropped late in a long row -- changes far more
elements than that and fails the last two bounds, where a tolerance of the
size of the output itself would pass it.
"""
from __future__ import annotations

import torch

BF16_RTOL = 2 ** -7
BF16_ATOL = 2e-3
BF16_MAX_SHARE_DIFFERING = 0.01
BF16_MAX_REL_L2 = 2 ** -9


def bf16_agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """``max_abs`` error; ``worst`` = the largest error over its elementwise
    tolerance (``<= 1`` passes); ``share_differing`` = the share of elements
    not bit-equal; ``rel_l2`` = ||got - want|| / ||want||."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if diff.numel() == 0:
        return {"max_abs": 0.0, "worst": 0.0, "share_differing": 0.0,
                "rel_l2": 0.0}
    return {"max_abs": float(diff.max()),
            "worst": float((diff / (BF16_ATOL + BF16_RTOL * w.abs())).max()),
            "share_differing": float((diff != 0).sum()) / diff.numel(),
            "rel_l2": float(diff.norm() / w.norm().clamp_min(1e-30))}


def check_bf16(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    """Raise ``AssertionError`` unless ``got`` agrees with ``want`` within
    the three bounds above (same shape and dtype, finite); returns
    :func:`bf16_agreement`."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    a = bf16_agreement(got, want)
    if (a["worst"] > 1 or a["share_differing"] > BF16_MAX_SHARE_DIFFERING
            or a["rel_l2"] > BF16_MAX_REL_L2):
        raise AssertionError(
            f"{what}: max abs err {a['max_abs']:.3g} ({a['worst']:.3g} x "
            f"rtol 2^-7 + atol {BF16_ATOL}), {100 * a['share_differing']:.3g}"
            f"% of elements differ (limit "
            f"{100 * BF16_MAX_SHARE_DIFFERING:g}%), relative L2 "
            f"{a['rel_l2']:.3g} (limit 2^-9)")
    return a
