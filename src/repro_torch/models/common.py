"""Model substrate: configuration + shared layer primitives (counterpart of
``repro/models/common.py``).

:class:`ModelConfig` equals the reference's field by field; ``jdtype``
becomes :attr:`ModelConfig.torch_dtype`.  The primitives follow the
reference's casts (fp32 statistics in :func:`rms_norm` and fp32 rotary
arithmetic, one cast back), so bf16 rounds at the same places.  Weights keep
the reference's ``(in, out)`` layout: ``x @ w``.
"""
from __future__ import annotations

import contextvars
import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...] = ("dense",)
    head_dim: Optional[int] = None
    # attention
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0          # chatglm partial rotary
    sliding_window: int = 4096
    attn_chunk: int = 512            # kv/q chunk for blockwise attention
    # moe
    num_experts: int = 0
    experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # mla
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    # ssm / xlstm
    ssm_state: int = 64
    ssm_chunk: int = 256
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500
    # frontends
    modality: str = "text"           # text | audio-stub | vision-stub
    act: str = "silu"                # mlp activation
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # serving
    kv_cache_dtype: str = "model"    # model dtype | "int8" (quantized cache)
    # embedding engine strategy (Ember integration)
    embed_strategy: str = "masked_psum"
    # applicability notes (DESIGN.md §Arch-applicability)
    long_context_ok: bool = False    # sub-quadratic → long_500k runs

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows: vocab padded to a multiple of 256 so the
        vocab dim shards evenly over any mesh model axis ≤256 (standard
        table padding; ids never address the pad rows, decode slices the
        logits back to the logical vocab)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def n_super(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def remainder_pattern(self) -> Tuple[str, ...]:
        r = self.num_layers % len(self.block_pattern)
        return self.block_pattern[:r]


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def init_rms(d: int, dtype: torch.dtype, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def dense_init(gen: Optional[torch.Generator], shape: tuple,
               dtype: torch.dtype, device=None,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, fan_in^-1/2) in fp32 from ``gen``, cast to ``dtype``.  The
    numbers differ from the reference's ``jax.random`` ones (tests carry the
    reference's weights across with ``repro_torch.convert``).  On the
    ``meta`` device only the shape is made."""
    if torch.device(device if device is not None else "cpu").type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    s = scale if scale is not None else shape[0] ** -0.5
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * s).to(dtype)


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float,
               rotary_pct: float = 1.0) -> tuple:
    """positions (..., S) -> (cos, sin) of shape (..., S, rot/2)."""
    rot = int(head_dim * rotary_pct) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=positions.device) / rot))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (..., S, rot/2): interleaved pairs over the
    first ``rotary_pct`` of the head, in fp32, cast back once."""
    d = x.shape[-1]
    rot = int(d * rotary_pct) // 2 * 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    c = cos[..., None, :]
    s = sin[..., None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < d else out


# jax.nn.gelu is the tanh approximation by default
_ACTS = {"silu": F.silu,
         "gelu": lambda t: F.gelu(t, approximate="tanh"),
         "relu": F.relu}


def pick_chunk(s: int, preferred: int) -> int:
    """Largest chunk <= preferred that divides s (gcd fallback)."""
    return preferred if s % preferred == 0 else math.gcd(s, preferred)


def update_cache(cache: dict, new: dict, active=None) -> None:
    """Write a recurrent layer's ``new`` leaves into ``cache`` in place; with
    an ``active`` mask (B,) bool, an inactive slot's leaves keep their bits
    (the reference's ``where(active, new, old)``)."""
    for key, t in new.items():
        if active is None:
            cache[key].copy_(t)
        else:
            keep = active.view((-1,) + (1,) * (t.dim() - 1))
            cache[key].copy_(torch.where(keep, t, cache[key]))


def gated_mlp(x: torch.Tensor, p, act: str = "silu",
              tp=None) -> torch.Tensor:
    """``act(x W_gate) * (x W_up) W_o``.  Under tensor parallelism (``tp``,
    a :class:`~repro_torch.core.shard_plan.ModelAxis`) the rank holds its
    columns of ``wi_gate`` / ``wi_up`` and its rows of ``wo``, and the
    partial products are summed over the axis (:func:`row_parallel`)."""
    h = _ACTS[act](x @ p["wi_gate"]) * (x @ p["wi_up"])
    return row_parallel(h, p["wo"], tp)


def row_parallel(h: torch.Tensor, w: torch.Tensor, tp=None) -> torch.Tensor:
    """``h @ w`` where ``h`` holds this rank's columns and ``w`` its rows
    (a row-parallel product): each rank's partial product of exact operand
    products summed in fp32 (bf16 on the card through cuBLAS's bf16 x bf16
    -> fp32 GEMM), the partials summed over ``tp`` in fp32 and rounded to
    h's dtype once -- as the single device's GEMM sums in fp32 and rounds
    once.  The fp32 sum doubles a bf16 model's all-reduce bytes.  Without
    ``tp`` (or on a 1-wide axis) it is ``h @ w``.  Under autograd it runs
    through :class:`RowParallel`, whose backward is written out."""
    if tp is None or tp.size == 1:
        return h @ w
    h2 = h.reshape(math.prod(h.shape[:-1]), h.shape[-1])
    if torch.is_grad_enabled() and (h.requires_grad or w.requires_grad):
        out = RowParallel.apply(h2, w, tp)
    else:
        out = tp.sum(_f32_product(h2, w)).to(h.dtype)
    return out.view(*h.shape[:-1], w.shape[1])


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N) fp32: exact operand products summed in
    fp32 (bf16 on the card through cuBLAS's bf16 x bf16 -> fp32 GEMM;
    meta tensors take the card's path, which the dry run counts)."""
    if a.device.type in ("cuda", "meta") and \
            a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a[None], b[None], out_dtype=torch.float32)[0]
    return torch.bmm(a[None].float(), b[None].float())[0]


class RowOutputs:
    """The outputs of a block's :class:`RowParallel` products, kept by
    ``ShardCtx.remat="dots"`` (``models.lm.remat_block``): the block's
    first run appends each product's reduced output; a recompute of the
    block in the backward takes them back in order instead of running the
    product and its all-reduce again.  A row-parallel product is one
    matrix product without batch dims split over the model axis, whose
    output "dots" saves (as ``dots_with_no_batch_dims_saveable`` saves the
    reference's, after the all-reduce the partitioner puts behind it)."""

    def __init__(self):
        self.outs: list = []
        self.replay = False
        self._next = 0

    def run(self, fn, *args):
        """``fn(*args)`` with this record current: the first call records,
        every later one (the checkpoint's recompute) replays from the
        first output."""
        self._next = 0
        token = _ROW_OUTPUTS.set(self)
        try:
            return fn(*args)
        finally:
            _ROW_OUTPUTS.reset(token)
            self.replay = True

    def take(self) -> torch.Tensor:
        out = self.outs[self._next]
        self._next += 1
        return out


#: the :class:`RowOutputs` of the block being run under "dots" (None
#: elsewhere); a context variable, since a checkpoint's recompute runs in
#: the backward's thread
_ROW_OUTPUTS: contextvars.ContextVar = contextvars.ContextVar(
    "row_outputs", default=None)


class RowParallel(torch.autograd.Function):
    """The row-parallel product with its transpose written out (autograd's
    own formula for ``bmm(..., out_dtype=)`` is not relied on).  The
    output is replicated, so the cotangent of the fp32 partial is the
    incoming cotangent on every rank: ``dh = dout @ w_r^T`` and ``dw_r =
    h_r^T @ dout``, each summed in fp32 and rounded once to its operand's
    dtype, as the single device's GEMM does.  h2 (N, K_r), w (K_r, M) ->
    (N, M) in h's dtype.  Under a :class:`RowOutputs` record the output is
    kept, and taken back (neither product nor all-reduce run) when the
    block is recomputed."""

    @staticmethod
    def forward(ctx, h2, w, tp):
        ctx.save_for_backward(h2, w)
        rec = _ROW_OUTPUTS.get()
        if rec is not None and rec.replay:
            return rec.take().detach()
        out = tp.coll.all_reduce(_f32_product(h2, w), "add").to(h2.dtype)
        if rec is not None:
            rec.outs.append(out)
        return out

    @staticmethod
    def backward(ctx, dout):
        h2, w = ctx.saved_tensors
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = _f32_product(dout, w.t()).to(h2.dtype)
        if ctx.needs_input_grad[1]:
            dw = _f32_product(h2.t(), dout).to(w.dtype)
        return dh, dw, None


def init_mlp(gen: Optional[torch.Generator], d_model: int, d_ff: int,
             dtype: torch.dtype, device=None) -> dict:
    return {
        "wi_gate": dense_init(gen, (d_model, d_ff), dtype, device),
        "wi_up": dense_init(gen, (d_model, d_ff), dtype, device),
        "wo": dense_init(gen, (d_ff, d_model), dtype, device),
    }
