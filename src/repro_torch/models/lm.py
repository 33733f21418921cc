"""LM assembly (counterpart of ``repro/models/lm.py``).

Ported so far: the ``dense`` block kind (GQA attention with partial rotary +
gated MLP), :meth:`LM.forward` and :meth:`LM.prefill`, and the LM's
embedding program (:func:`embedding_program`).  The reference folds depth
into a ``jax.lax.scan`` over super-blocks; here the layers are an
``nn.ModuleList`` run in order (scan super-blocks first, then the
remainder, as the reference does).  Decode with caches, the other block
kinds, the loss and training are still to port (ROADMAP.md, Queue 1).

Parameters carry the reference's names (``embed``, ``final_norm``,
``blocks.<layer>.{norm1,attn.{wq,wk,wv,wo},norm2,mlp.{wi_gate,wi_up,wo}}``)
and layout, so :func:`repro_torch.convert.lm_params_from_reference` can load
the reference's weights.  They do not require gradients: the attention
kernel has no backward yet.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import embedding_engine as ee
from ..core.executor import resolve_device
from ..core.ops import EmbeddingProgram
from . import moe as moe_mod
from .attention import attn_forward, init_attn
from .common import ModelConfig, gated_mlp, init_mlp, init_rms, rms_norm

PORTED_KINDS = ("dense",)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DenseBlock(nn.Module):
    """``dense``: causal GQA attention (+RoPE/partial RoPE) + gated MLP,
    pre-norm residual."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.norm1 = _frozen(init_rms(cfg.d_model, dtype, device))
        self.attn = nn.ParameterDict({
            k: _frozen(v) for k, v in init_attn(gen, cfg, dtype,
                                                device).items()})
        self.norm2 = _frozen(init_rms(cfg.d_model, dtype, device))
        self.mlp = nn.ParameterDict({
            k: _frozen(v) for k, v in init_mlp(gen, cfg.d_model, cfg.d_ff,
                                               dtype, device).items()})

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        eps = self.cfg.norm_eps
        h = rms_norm(x, self.norm1, eps)
        x = x + attn_forward(self.attn, h, self.cfg, positions=positions,
                             causal=True)
        h = rms_norm(x, self.norm2, eps)
        return x + gated_mlp(h, self.mlp, self.cfg.act)


class LM(nn.Module):
    """The decoder stack of a config whose blocks are all ``dense``.

    Built on ``device`` (the CUDA card unless ``device="cpu"``; ``"meta"``
    builds the module tree without memory) and initialised there from
    ``seed`` with an explicit :class:`torch.Generator`: embed N(0, 0.02),
    norms 1, weights N(0, fan_in^-1/2), in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__()
        kinds = tuple(cfg.block_pattern) + tuple(cfg.remainder_pattern)
        missing = sorted(set(kinds) - set(PORTED_KINDS))
        if missing:
            raise NotImplementedError(
                f"block kinds {missing} of {cfg.name} are not ported yet "
                "(ROADMAP.md, Queue 1 item 5); ported: "
                f"{list(PORTED_KINDS)}")
        self.cfg = cfg
        meta = device is not None and torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else resolve_device(device)
        gen = None if meta else torch.Generator(device=dev).manual_seed(seed)
        dtype = cfg.torch_dtype
        if meta:
            embed = torch.empty((cfg.padded_vocab, cfg.d_model), dtype=dtype,
                                device=dev)
        else:
            embed = (torch.randn((cfg.padded_vocab, cfg.d_model),
                                 generator=gen, dtype=torch.float32,
                                 device=dev) * 0.02).to(dtype)
        self.embed = _frozen(embed)
        self.final_norm = _frozen(init_rms(cfg.d_model, dtype, dev))
        self.blocks = nn.ModuleList(DenseBlock(cfg, gen, dtype, dev)
                                    for _ in range(cfg.num_layers))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B,S) int -> hidden states (B,S,D) after the final norm
        (the reference's ``forward(params, {"tokens": ...})[0]``; the
        auxiliary loss of a dense stack is 0)."""
        b, s = tokens.shape
        x = ee.lookup(self.embed, tokens, strategy="take")
        positions = torch.arange(s, dtype=torch.float32,
                                 device=tokens.device)[None].expand(b, s)
        for blk in self.blocks:
            x = blk(x, positions)
        return rms_norm(x, self.final_norm, self.cfg.norm_eps)

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        """The serving prefill step: the full-sequence forward, returning
        the last position's hidden state (B,1,D)."""
        return self.forward(tokens)[:, -1:]


def embedding_program(cfg: ModelConfig, batch: int,
                      seq: int) -> EmbeddingProgram:
    """All irregular lookups of one (batch, seq) step as one
    :class:`~repro_torch.core.ops.EmbeddingProgram`: token embedding + label
    gather over the shared embed table, plus the MoE dispatch gather for
    models with MoE blocks."""
    tokens = batch * seq
    extra = []
    pattern = tuple(cfg.block_pattern) + tuple(cfg.remainder_pattern)
    if cfg.num_experts and any(k in ("moe", "mla") for k in pattern):
        extra.append(("moe_dispatch", moe_mod.dispatch_op(cfg, tokens)))
    return ee.model_embedding_program(
        vocab_size=cfg.padded_vocab, d_model=cfg.d_model, tokens=tokens,
        extra_ops=tuple(extra), name=f"{cfg.name}-step")
