"""Roofline terms of a dry-run step (counterpart of
``repro/roofline/analysis.py``).

    compute term    = FLOPs       / (chips × peak_FLOP/s)
    memory term     = bytes       / (chips × HBM_bw)
    collective term = coll_bytes  / (chips × link_bw)

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` of the
compiled step and parses the collectives out of its HLO.  The port has no
compiler to ask: the dry run (``repro_torch.launch.dryrun``) runs one
rank's step on the ``meta`` device -- no storage, no kernel -- under a
:class:`StepCounter`, which counts what the step dispatches:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, by aten op
  (:func:`flop_counter`: the products with an ``out_dtype`` too).  The
  hand-written kernels are calls into the library, which no counter sees
  (on the card either): the attention's FLOPs are counted in the cost pass,
  where the model runs :func:`repro_torch.models.attention.dense_attention`.
* bytes: every aten op's tensor inputs and outputs (views and ``empty``
  excluded), plus what each hand-written kernel reads and writes
  (:func:`repro_torch.kernels.sls.meta_launch`).  That is eager, unfused
  traffic, every intermediate written and read back: an upper bound, where
  XLA's figure is after fusion.
* collective bytes: the result bytes of every collective, counted by the
  port's own ``Collectives`` (``stats["result_bytes"]``), where the
  reference parses the same quantity from the HLO
  (:func:`collective_bytes_from_stats`).
* memory: the argument bytes (the rank's parameters, optimizer state,
  batch and caches: exact, from their local shapes), the output bytes (what
  the step returns beyond its arguments) and the peak of the bytes created
  during the step and still alive -- each storage from the op that made it
  until the storage is freed (a weak reference's finaliser), the caching
  allocator's rounding aside.

:func:`analytic_flops`, :func:`model_flops`, :func:`active_params`,
:func:`analytic_bytes_per_device` and :func:`roofline_terms` are the
reference's arithmetic, unchanged.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch


@dataclasses.dataclass(frozen=True)
class HW:
    """One NVIDIA H100 SXM, from NVIDIA's H100 datasheet (dense rates, no
    sparsity, at the 700 W power limit): 989 TFLOP/s in bf16 on the tensor
    cores, 3.35 TB/s of HBM3, and NVLink 4 at 900 GB/s bidirectional, 450
    GB/s a direction, for the link term.  The field names are the
    reference's, so its values can be passed in."""
    peak_flops: float = 989e12        # bf16 FLOP/s
    hbm_bw: float = 3.35e12           # B/s
    ici_bw: float = 450e9             # B/s a direction (NVLink 4)


def collective_bytes_from_stats(stats) -> float:
    """The counterpart of the reference's ``collective_bytes_from_hlo``:
    there is no HLO to read, so the collectives are counted where they are
    made.  ``stats`` are the ``Collectives.stats`` dicts of every axis the
    step used (``ModelAxis.stats``); the sum of their ``result_bytes`` --
    each collective's result size, the reference's convention (an
    all-reduce counts its payload, an all-gather the gathered result)."""
    return float(sum(s.get("result_bytes", 0) for s in stats))


def roofline_terms(*, flops: float, bytes_accessed: float,
                   collective_bytes: float, n_chips: int,
                   hw: HW = HW()) -> dict:
    compute_s = flops / (n_chips * hw.peak_flops)
    memory_s = bytes_accessed / (n_chips * hw.hbm_bw)
    coll_s = collective_bytes / (n_chips * hw.ici_bw)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    bound = max(compute_s, memory_s, coll_s)
    return {**terms, "bottleneck": dom.replace("_s", ""),
            "step_lower_bound_s": bound,
            "roofline_fraction_compute": compute_s / bound if bound else 0.0}


def analytic_flops(cfg, seq: int, batch: int, kind: str) -> float:
    """MODEL_FLOPS + attention/linear-scan terms -- the fallback compute
    estimate for cells without a cost pass."""
    base = model_flops(cfg, seq, batch, kind)
    if kind == "decode":
        return base
    mult = 3.0 if kind == "train" else 1.0   # fwd+bwd vs fwd
    b, s = batch, seq
    attn = 0.0
    for k in (cfg.block_pattern * cfg.n_super) + cfg.remainder_pattern:
        if k in ("dense", "moe", "mla", "shared_attn", "enc_dense", "xdec"):
            attn += 4.0 * b * s * s * cfg.num_heads * cfg.hd
            if k == "xdec":
                attn += 4.0 * b * s * s * cfg.num_heads * cfg.hd
        elif k == "dense_local":
            w = min(cfg.sliding_window, s)
            attn += 4.0 * b * s * w * cfg.num_heads * cfg.hd
        elif k in ("mamba", "mlstm"):
            L = cfg.ssm_chunk
            p_h = (2 * cfg.d_model // cfg.num_heads if k == "mamba"
                   else cfg.d_model // cfg.num_heads)
            attn += b * s * cfg.num_heads * (2 * L * p_h +
                                             4 * p_h * cfg.ssm_state)
    if cfg.enc_layers:
        attn += cfg.enc_layers * 4.0 * b * s * s * cfg.num_heads * cfg.hd
    return base + mult * attn


def model_flops(cfg, seq: int, batch: int, kind: str) -> float:
    """MODEL_FLOPS = 6·N_active·D tokens (train) or 2·N_active·D (fwd)."""
    n_active = active_params(cfg)
    tokens = seq * batch if kind != "decode" else batch
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens


def active_params(cfg) -> float:
    """Active (per-token) parameter count of a ModelConfig."""
    d, v = cfg.d_model, cfg.vocab_size
    total = v * d  # embedding (tied unembedding counted once for lookups)
    hd = cfg.hd
    for kind in (cfg.block_pattern * cfg.n_super) + cfg.remainder_pattern:
        attn = d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd \
            + cfg.num_heads * hd * d
        mlp = 3 * d * cfg.d_ff
        if kind in ("dense", "dense_local", "enc_dense"):
            n = attn + mlp
        elif kind == "moe":
            n = attn + 3 * d * cfg.moe_d_ff * cfg.experts_per_tok \
                + 3 * d * cfg.moe_d_ff * cfg.num_shared_experts
        elif kind == "mla":
            r, rd = cfg.kv_lora_rank, cfg.rope_head_dim
            n = (d * cfg.num_heads * (hd + rd) + d * r +
                 r * 2 * cfg.num_heads * hd + d * rd +
                 cfg.num_heads * hd * d)
            n += 3 * d * cfg.moe_d_ff * (cfg.experts_per_tok +
                                         cfg.num_shared_experts)
        elif kind == "mamba":
            di = 2 * d
            n = d * (2 * di + 2 * cfg.ssm_state + cfg.num_heads) + di * d
        elif kind == "mlstm":
            n = 5 * d * d
        elif kind == "slstm":
            n = 4 * d * d + d * d + cfg.num_heads * (d // cfg.num_heads) ** 2 * 4
        elif kind == "shared_attn":
            n = attn + mlp  # shared weights but active per occurrence
        elif kind == "xdec":
            n = 2 * attn + mlp
        else:
            n = 0
        total += n
    if cfg.enc_layers:
        attn = 4 * d * cfg.num_heads * hd
        total += cfg.enc_layers * (attn + 3 * d * cfg.d_ff)
    return float(total)


def analytic_bytes_per_device(cfg, seq: int, batch: int, kind: str,
                              n_data: int = 16, n_model: int = 16) -> float:
    """Production-path HBM traffic estimate per device per step: the
    companion of the counted bytes, which hold every unfused intermediate
    (and, in the cost pass, the dense attention's S² scores) that the
    production path keeps out of HBM."""
    P_loc = active_params(cfg) / n_model
    tok_loc = seq * batch / n_data if kind != "decode" else batch / n_data
    d = cfg.d_model
    if kind == "train":
        param_io = P_loc * 2 * 4            # read fwd+bwd, grad w, update rw
        opt_io = P_loc * 4 * 4              # two fp32 moments, read+write
        act_io = 14 * tok_loc * d * 2 * (cfg.num_layers + cfg.enc_layers)
        return param_io + opt_io + act_io
    if kind == "prefill":
        return P_loc * 2 + 8 * tok_loc * d * 2 * cfg.num_layers
    # decode: params once + KV/state cache traffic
    cache = 0.0
    for k in (cfg.block_pattern * cfg.n_super) + cfg.remainder_pattern:
        if k in ("dense", "moe", "shared_attn", "xdec", "enc_dense"):
            cache += 2 * seq * cfg.num_kv_heads * cfg.hd * 2
        elif k == "dense_local":
            cache += 2 * min(seq, cfg.sliding_window) * \
                cfg.num_kv_heads * cfg.hd * 2
        elif k == "mla":
            cache += seq * (cfg.kv_lora_rank + cfg.rope_head_dim) * 2
        elif k == "mamba":
            cache += cfg.num_heads * (2 * d // cfg.num_heads) * \
                cfg.ssm_state * 2 * 2
        elif k == "mlstm":
            cache += cfg.num_heads * (d // cfg.num_heads) ** 2 * 2 * 2
        elif k == "slstm":
            cache += 4 * d * 4
    cache_loc = cache * batch / (n_data * n_model)
    return P_loc * 2 + cache_loc


# ---------------------------------------------------------------------------
# Counting a step
# ---------------------------------------------------------------------------

#: the aten ops of matrix products: what ``remat="dots"`` saves and what the
#: dry run's count is held to on the card (``chip_smoke.py`` phase 21)
MM_OPS = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm")


def _product_flops(formula):
    """``formula`` (torch's ``mm_flop`` / ``bmm_flop``) for the ``.dtype``
    overloads too, whose ``out_dtype`` arrives as a third positional
    argument (``bmm(..., out_dtype=torch.float32)``: the fp32-summed bf16
    products of the logits, the row-parallel partials and decode
    attention); torch's formulas take only the two shapes."""
    def flops(a_shape, b_shape, *_, out_shape=None, **__):
        return formula(a_shape, b_shape)
    return flops


def flop_counter():
    """A ``FlopCounterMode`` (no display) that counts the products with an
    ``out_dtype`` as their plain overloads: what the dry run counts on
    meta tensors and what ``chip_smoke.py`` counts on the card."""
    from torch.utils import flop_counter as fc
    aten = torch.ops.aten
    return fc.FlopCounterMode(display=False, custom_mapping={
        aten.mm: _product_flops(fc.mm_flop),
        aten.bmm: _product_flops(fc.bmm_flop)})


def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """The bytes ``t`` addresses: its elements, at most its storage (a
    broadcast view reads its storage's bytes, not its shape's)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class _Traffic(torch.utils._python_dispatch.TorchDispatchMode):
    """Bytes by aten op and the lifetimes of the storages the step makes
    (:class:`StepCounter`)."""

    _FREE = frozenset(("aten.empty", "aten.empty_strided",
                       "aten.empty_like", "aten.detach", "aten.alias",
                       "aten.lift_fresh"))

    def __init__(self, counter: "StepCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        c = self.counter
        outs = [t for t in _tensors(out) if t.device == c.device]
        if not func.is_view and \
                str(func.overloadpacket) not in self._FREE:
            c.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))
                           if t.device == c.device)
            c.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            c._made(t.untyped_storage())
        return out


class StepCounter:
    """What one step dispatches on ``device`` (the meta device in the dry
    run): FLOPs by aten op, bytes (aten ops and the hand-written kernels),
    and memory (module docstring).  ``arguments`` are the tensors the step
    takes (its parameters, optimizer state, batch and caches): their bytes
    are the argument bytes, never temporaries.  Use as a context manager
    around the step; then :meth:`outputs` with what the step returned, and
    :meth:`record`."""

    def __init__(self, arguments=(), device="meta"):
        self.device = torch.device(device)
        self.bytes = 0
        self.kernel_bytes: dict = {}
        self.output_bytes = 0
        self._flops = flop_counter()
        self._traffic = _Traffic(self)
        self._args: dict = {}
        for t in _tensors(arguments):
            st = t.untyped_storage()
            self._args.setdefault(st._cdata, st.nbytes())
        self.argument_bytes = sum(self._args.values())
        self._live: dict = {}               # storage -> bytes, made here
        self.live = self.peak = 0

    def _made(self, st) -> None:
        key = st._cdata
        if key in self._args or key in self._live:
            return
        self._live[key] = n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._freed, key)

    def _freed(self, key) -> None:
        self.live -= self._live.pop(key, 0)

    def kernel(self, name: str, reads: tuple, writes: tuple) -> None:
        """A hand-written kernel's traffic (``kernels.sls.meta_launch``)."""
        n = sum(_nbytes(t) for t in (*reads, *writes) if t is not None)
        self.kernel_bytes[name] = self.kernel_bytes.get(name, 0) + n

    def __enter__(self):
        from ..kernels.sls import META_COUNTERS
        self._flops.__enter__()
        self._traffic.__enter__()
        META_COUNTERS.append(self)
        return self

    def __exit__(self, *exc):
        from ..kernels.sls import META_COUNTERS
        META_COUNTERS.remove(self)
        self._traffic.__exit__(*exc)
        self._flops.__exit__(*exc)
        return False

    def outputs(self, out) -> None:
        """Count the bytes of what the step returned (each storage once,
        its arguments' excluded: a leaf updated in place is an argument)."""
        seen = set()
        for t in _tensors(out):
            st = t.untyped_storage()
            if st._cdata not in self._args and st._cdata not in seen:
                seen.add(st._cdata)
                self.output_bytes += st.nbytes()

    @property
    def flops_by_op(self) -> dict:
        return {str(op): int(n) for op, n in
                self._flops.get_flop_counts().get("Global", {}).items()}

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_op.values()))

    @property
    def mm_flops(self) -> float:
        """The FLOPs of the matrix products (:data:`MM_OPS`)."""
        return float(sum(n for op, n in self.flops_by_op.items()
                         if op in MM_OPS))

    def record(self) -> dict:
        """The counts as a dry-run record's fields."""
        return {"flops": self.flops, "flops_by_op": self.flops_by_op,
                "mm_flops": self.mm_flops,
                "bytes": float(self.bytes + sum(self.kernel_bytes.values())),
                "kernel_bytes": dict(self.kernel_bytes),
                "memory": {"argument_size_in_bytes": self.argument_bytes,
                           "output_size_in_bytes": self.output_bytes,
                           "temp_size_in_bytes": self.peak}}
