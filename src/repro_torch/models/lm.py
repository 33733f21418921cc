"""LM assembly (counterpart of ``repro/models/lm.py``).

Ported so far: the ``dense`` block kind (GQA attention with partial rotary +
gated MLP), ``dense_local`` (the same with the sliding-window band of
``cfg.sliding_window``), the ``moe`` kind (GQA attention + the MoE FFN),
the ``mla`` kind (DeepSeek's latent attention + the MoE FFN),
whisper's encoder-decoder kinds: ``enc_dense`` (the encoder's blocks:
non-causal self-attention + MLP) and ``xdec`` (causal self-attention,
cross-attention over the encoder's output, MLP), and zamba2's hybrid kinds:
``mamba`` (the Mamba2 SSD block, :mod:`.ssm`) and ``shared_attn`` (causal
attention + MLP from one weight set, :attr:`LM.shared`, shared by every
occurrence; only its two norms are the layer's own);
:meth:`LM.forward` (the MoE layers' auxiliary loss summed beside it; the
``vision-stub`` front end's ``frontend_embeds`` spliced over the first
positions; the ``audio-stub`` front end's ``enc_embeds`` through the
encoder, :meth:`LM._encode`), :meth:`LM.loss` (the training objective) and
:meth:`LM.prefill`, the serving methods
(:meth:`LM.init_caches`, :meth:`LM.decode_step` with the ``active`` mask
and the encoder context ``batch_ctx``, :meth:`LM.wave_step`,
:meth:`LM.reset_slots`), and the LM's embedding
programs and executors (:func:`embedding_program`,
:meth:`LM.decode_embed_program`, :meth:`LM.embedding_pipeline`,
:meth:`LM.embedding_executor` without a mesh).  The reference folds depth
into a ``jax.lax.scan`` over super-blocks; here the layers are an
``nn.ModuleList`` run in order (scan super-blocks first, then the
remainder, as the reference does), and a wave is a Python loop of masked
micro-steps (which the server replays as CUDA graphs on the card:
:class:`repro_torch.runtime.server.WaveGraph`).  Still to port (ROADMAP.md,
Queue 1): xLSTM's ``mlstm`` and ``slstm`` kinds (item 5c) and the sharded
embedding executor and loss (item 6).

A block's ``forward`` and ``decode`` take a context dict beside their
input, as the reference's ``block_apply`` / ``block_decode`` take
``ctx``: ``{"enc_out": (B, Sf, D)}`` for an encoder-decoder model (the
``xdec`` layers read the encoder's output from it, never from a cache),
``{"shared": LM.shared, "shared_window": ...}`` for a model with
``shared_attn`` layers (the reference's ``shared_params`` and
``shared_window``), None otherwise.

Parameters carry the reference's names (``embed``, ``final_norm``,
``frontend_proj`` where ``cfg.modality`` is not ``"text"``,
``blocks.<layer>.{norm1,attn.{wq,wk,wv,wo},norm2,mlp.{wi_gate,wi_up,wo}}``;
an ``xdec`` layer's ``norm_x`` and ``xattn.{wq,wk,wv,wo}`` besides; the
encoder's ``enc_blocks.<layer>.*`` (``enc_dense`` layers) and
``enc_norm``; a ``mamba`` layer's ``norm1`` and
``mamba.{w_in,conv_w,A_log,D,dt_bias,w_out,norm_z}``, a ``shared_attn``
layer's ``norm1`` and ``norm2``, and the shared set
``shared.{attn.{wq,wk,wv,wo},mlp.{wi_gate,wi_up,wo}}``, registered once, so
``parameters()``, ``state_dict()``, the trainer and the checkpoints see
each shared tensor once and its gradient sums over the occurrences;
MLA's ``attn.{wq,w_dkv,w_uk,w_uv,w_kr,wo}``; the MoE kinds'
``moe.{router,wi_gate,wi_up,wo,shared.{wi_gate,wi_up,wo}}``) and layout, so
:func:`repro_torch.convert.lm_params_from_reference` can load the
reference's weights.  They are built frozen; ``lm.requires_grad_(True)``
makes them trainable (the trainer does so), and then the kernels on the
way -- flash attention, the MoE un-dispatch gather -- run through their
autograd Functions, whose backward is a kernel too.  Serving runs under
``torch.inference_mode`` either way.  The weights stay inside the module,
so the serving and loss methods take no ``params`` argument; caches are a list with one
dict per layer, in layer order (:mod:`.attention` gives the layout;
``repro_torch.convert.caches_to_reference`` maps them to the reference's
tree).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core import embedding_engine as ee
from ..core.executor import resolve_device
from ..core.ops import EmbeddingProgram
from . import moe as moe_mod
from . import ssm as ssm_mod
from .attention import (attn_decode, attn_forward, init_attn, init_kv_cache,
                        init_mla, init_mla_cache, mla_decode, mla_forward)
from .common import ModelConfig, gated_mlp, init_mlp, init_rms, rms_norm

PORTED_KINDS = ("dense", "dense_local", "moe", "mla", "enc_dense", "xdec",
                "mamba", "shared_attn")
#: the ROADMAP.md Queue 1 item that ports each other block kind
KIND_ITEMS = {"mlstm": "5c", "slstm": "5c"}
#: the block kinds with an MoE FFN (the reference's ``moe_mod`` users)
MOE_KINDS = ("moe", "mla")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class ParamTree(nn.Module):
    """Frozen parameters under the reference's nested names
    (``moe.router``, ``moe.shared.wi_gate``), read as a mapping:
    ``p["router"]``, ``"shared" in p``."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, _frozen(v))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


class DenseBlock(nn.Module):
    """``dense``: causal GQA attention (+RoPE/partial RoPE) + gated MLP,
    pre-norm residual.  The MoE kinds below change the attention or the
    FFN; ``forward`` returns ``(x, aux)``, aux None where the FFN has no
    auxiliary loss."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.norm1 = _frozen(init_rms(cfg.d_model, dtype, device))
        self.attn = nn.ParameterDict({
            k: _frozen(v) for k, v in self._init_attn(gen, cfg, dtype,
                                                      device).items()})
        self.norm2 = _frozen(init_rms(cfg.d_model, dtype, device))
        self._init_ffn(gen, cfg, dtype, device)

    _init_attn = staticmethod(init_attn)

    def _init_ffn(self, gen, cfg, dtype, device) -> None:
        self.mlp = nn.ParameterDict({
            k: _frozen(v) for k, v in init_mlp(gen, cfg.d_model, cfg.d_ff,
                                               dtype, device).items()})

    def _attend(self, h: torch.Tensor, positions: torch.Tensor):
        return attn_forward(self.attn, h, self.cfg, positions=positions,
                            causal=True)

    def _attend_decode(self, h: torch.Tensor, cache: dict, active):
        return attn_decode(self.attn, h, self.cfg, cache, active=active)

    def _ffn(self, h: torch.Tensor) -> tuple:
        return gated_mlp(h, self.mlp, self.cfg.act), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                ctx: Optional[dict] = None) -> tuple:
        eps = self.cfg.norm_eps
        x = x + self._attend(rms_norm(x, self.norm1, eps), positions)
        h, aux = self._ffn(rms_norm(x, self.norm2, eps))
        return x + h, aux

    def decode(self, x: torch.Tensor, cache: dict,
               active: Optional[torch.Tensor] = None,
               ctx: Optional[dict] = None) -> torch.Tensor:
        """One decode micro-step (the reference's ``block_decode``): x
        (B,1,D), ``cache`` updated in place."""
        eps = self.cfg.norm_eps
        x = x + self._attend_decode(rms_norm(x, self.norm1, eps), cache,
                                    active)
        h, _ = self._ffn(rms_norm(x, self.norm2, eps))
        return x + h


class LocalBlock(DenseBlock):
    """``dense_local``: :class:`DenseBlock` with the sliding-window band --
    a query at position q attends to the keys with ``q - k <
    cfg.sliding_window`` in the prefill, and a decode step to the last
    ``sliding_window`` positions of its cache (the reference's
    ``block_apply`` / ``block_decode``).  Its cache is ``max_len`` long,
    as the reference allocates it."""

    def _attend(self, h: torch.Tensor, positions: torch.Tensor):
        return attn_forward(self.attn, h, self.cfg, positions=positions,
                            causal=True, window=self.cfg.sliding_window)

    def _attend_decode(self, h: torch.Tensor, cache: dict, active):
        return attn_decode(self.attn, h, self.cfg, cache,
                           window=self.cfg.sliding_window, active=active)


class MoeBlock(DenseBlock):
    """``moe``: causal GQA attention + the MoE FFN (routed experts, and the
    shared ones where the config has them), pre-norm residual."""

    def _init_ffn(self, gen, cfg, dtype, device) -> None:
        self.moe = ParamTree(moe_mod.init_moe(gen, cfg, dtype, device))

    def _ffn(self, h: torch.Tensor) -> tuple:
        return moe_mod.moe_ffn(self.moe, h, self.cfg)


class MlaBlock(MoeBlock):
    """``mla``: DeepSeek's multi-head latent attention + the MoE FFN,
    pre-norm residual; its cache is the latent one
    (:func:`.attention.init_mla_cache`)."""

    _init_attn = staticmethod(init_mla)

    def _attend(self, h: torch.Tensor, positions: torch.Tensor):
        return mla_forward(self.attn, h, self.cfg, positions=positions)

    def _attend_decode(self, h: torch.Tensor, cache: dict, active):
        return mla_decode(self.attn, h, self.cfg, cache, active=active)


class EncBlock(DenseBlock):
    """``enc_dense``: :class:`DenseBlock` with non-causal self-attention --
    whisper's encoder block (the reference's ``block_apply`` with ``causal
    = kind != "enc_dense"``).  It runs only in :meth:`LM._encode`, never in
    decode."""

    def _attend(self, h: torch.Tensor, positions: torch.Tensor):
        return attn_forward(self.attn, h, self.cfg, positions=positions,
                            causal=False)


class XdecBlock(DenseBlock):
    """``xdec``: whisper's decoder block, pre-norm residual -- causal
    self-attention (``norm1``, ``attn``), cross-attention over the
    encoder's output ``ctx["enc_out"]`` (``norm_x``, ``xattn``: no rotary,
    not causal, K and V projected from ``enc_out`` at every call), the
    MLP (``norm2``, ``mlp``).  Its cache is the self-attention's K/V
    (:func:`.attention.init_kv_cache`); the encoder's output comes from the
    context, never from the cache."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device):
        super().__init__(cfg, gen, dtype, device)
        self.norm_x = _frozen(init_rms(cfg.d_model, dtype, device))
        self.xattn = nn.ParameterDict({
            k: _frozen(v) for k, v in init_attn(gen, cfg, dtype,
                                                device).items()})

    def _cross(self, x: torch.Tensor, ctx: Optional[dict]) -> torch.Tensor:
        h = rms_norm(x, self.norm_x, self.cfg.norm_eps)
        return x + attn_forward(self.xattn, h, self.cfg, positions=None,
                                causal=False, kv=ctx["enc_out"])

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                ctx: Optional[dict] = None) -> tuple:
        eps = self.cfg.norm_eps
        x = x + self._attend(rms_norm(x, self.norm1, eps), positions)
        x = self._cross(x, ctx)
        h, aux = self._ffn(rms_norm(x, self.norm2, eps))
        return x + h, aux

    def decode(self, x: torch.Tensor, cache: dict,
               active: Optional[torch.Tensor] = None,
               ctx: Optional[dict] = None) -> torch.Tensor:
        """One decode micro-step: the self-attention over the cache
        (updated in place, masked by ``active``), then the cross-attention
        of every slot's one query over its ``enc_out`` rows."""
        eps = self.cfg.norm_eps
        x = x + self._attend_decode(rms_norm(x, self.norm1, eps), cache,
                                    active)
        x = self._cross(x, ctx)
        h, _ = self._ffn(rms_norm(x, self.norm2, eps))
        return x + h


class MambaBlock(nn.Module):
    """``mamba``: the Mamba2 SSD block, pre-norm residual (``norm1``,
    ``mamba.*``; :mod:`.ssm`).  Its cache is ``{state, conv}``
    (:func:`.ssm.init_mamba_cache`), which :meth:`decode` updates in place,
    an inactive slot's leaves kept bit for bit under ``active``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.norm1 = _frozen(init_rms(cfg.d_model, dtype, device))
        self.mamba = nn.ParameterDict({
            k: _frozen(v) for k, v in ssm_mod.init_mamba(
                gen, cfg, dtype, device).items()})

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                ctx: Optional[dict] = None) -> tuple:
        h = rms_norm(x, self.norm1, self.cfg.norm_eps)
        return x + ssm_mod.mamba_forward(self.mamba, h, self.cfg), None

    def decode(self, x: torch.Tensor, cache: dict,
               active: Optional[torch.Tensor] = None,
               ctx: Optional[dict] = None) -> torch.Tensor:
        h = rms_norm(x, self.norm1, self.cfg.norm_eps)
        return x + ssm_mod.mamba_decode(self.mamba, h, self.cfg, cache,
                                        active=active)


class SharedAttnBlock(nn.Module):
    """``shared_attn``: causal attention + gated MLP, pre-norm residual,
    whose weights are the model's one shared set ``ctx["shared"]``
    (``attn.*``, ``mlp.*``; :attr:`LM.shared`); the layer's own parameters
    are its two norms.  The attention's window is ``ctx["shared_window"]``
    (the reference's: a window only for a hybrid model that is not
    ``long_context_ok``).  Its cache is a KV cache
    (:func:`.attention.init_kv_cache`)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.norm1 = _frozen(init_rms(cfg.d_model, dtype, device))
        self.norm2 = _frozen(init_rms(cfg.d_model, dtype, device))

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                ctx: Optional[dict] = None) -> tuple:
        cfg, sp = self.cfg, ctx["shared"]
        h = rms_norm(x, self.norm1, cfg.norm_eps)
        x = x + attn_forward(sp["attn"], h, cfg, positions=positions,
                             causal=True, window=ctx["shared_window"])
        h = rms_norm(x, self.norm2, cfg.norm_eps)
        return x + gated_mlp(h, sp["mlp"], cfg.act), None

    def decode(self, x: torch.Tensor, cache: dict,
               active: Optional[torch.Tensor] = None,
               ctx: Optional[dict] = None) -> torch.Tensor:
        cfg, sp = self.cfg, ctx["shared"]
        h = rms_norm(x, self.norm1, cfg.norm_eps)
        x = x + attn_decode(sp["attn"], h, cfg, cache,
                            window=ctx["shared_window"], active=active)
        h = rms_norm(x, self.norm2, cfg.norm_eps)
        return x + gated_mlp(h, sp["mlp"], cfg.act)


BLOCKS = {"dense": DenseBlock, "dense_local": LocalBlock, "moe": MoeBlock,
          "mla": MlaBlock, "enc_dense": EncBlock, "xdec": XdecBlock,
          "mamba": MambaBlock, "shared_attn": SharedAttnBlock}


def layer_kinds(cfg: ModelConfig) -> tuple:
    """Each layer's block kind, in layer order: the pattern once per
    super-block, then the remainder (the reference's scan order)."""
    return tuple(cfg.block_pattern) * cfg.n_super + \
        tuple(cfg.remainder_pattern)


def shared_window(cfg: ModelConfig) -> Optional[int]:
    """The window of the ``shared_attn`` layers (the reference's
    ``LM._ctx``): ``cfg.sliding_window`` for a hybrid model that is not
    ``long_context_ok``, else None (zamba2-7b: global and causal)."""
    if cfg.family == "hybrid" and not cfg.long_context_ok:
        return cfg.sliding_window
    return None


class LM(nn.Module):
    """The decoder stack of a config whose blocks are ``dense``,
    ``dense_local``, ``moe``, ``mla``, ``xdec``, ``mamba`` or
    ``shared_attn``, for an encoder-decoder config (``cfg.enc_layers``) its
    encoder: ``enc_layers`` ``enc_dense`` blocks and ``enc_norm``, and for a
    config with ``shared_attn`` layers the one weight set they share,
    :attr:`shared`.

    Built on ``device`` (the CUDA card unless ``device="cpu"``; ``"meta"``
    builds the module tree without memory) and initialised there from
    ``seed`` with an explicit :class:`torch.Generator`: embed N(0, 0.02),
    norms 1, weights N(0, fan_in^-1/2), in ``cfg.dtype``; a front end's
    ``frontend_proj`` is the identity, as the reference's."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__()
        kinds = tuple(cfg.block_pattern) + tuple(cfg.remainder_pattern)
        missing = sorted(set(kinds) - set(PORTED_KINDS))
        if missing:
            items = sorted({KIND_ITEMS[k] for k in missing})
            raise NotImplementedError(
                f"block kinds {missing} of {cfg.name} are not ported yet "
                f"(ROADMAP.md, Queue 1 item {' and '.join(items)})"
                f"; ported: {list(PORTED_KINDS)}")
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
        if cfg.modality != "text":
            self.frontend_proj = _frozen(torch.eye(cfg.d_model, dtype=dtype,
                                                   device=dev))
        self.blocks = nn.ModuleList(BLOCKS[kind](cfg, gen, dtype, dev)
                                    for kind in layer_kinds(cfg))
        if "shared_attn" in kinds:
            self.shared = ParamTree({
                "attn": init_attn(gen, cfg, dtype, dev),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, dev)})
        if cfg.enc_layers:
            self.enc_blocks = nn.ModuleList(
                EncBlock(cfg, gen, dtype, dev)
                for _ in range(cfg.enc_layers))
            self.enc_norm = _frozen(init_rms(cfg.d_model, dtype, dev))

    def _encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder (the reference's ``LM._encode``): enc_embeds
        (B,Sf,D), the ``audio-stub`` front end's frame embeddings in the
        model's dtype, through ``frontend_proj``, the ``enc_dense`` blocks
        and ``enc_norm`` -> enc_out (B,Sf,D).  The self-attention's rotary
        runs at positions 0..Sf-1: the reference's reads the decoder's
        positions, which :meth:`forward` requires to be the same."""
        if enc_embeds.dim() != 3 or enc_embeds.shape[2] != self.cfg.d_model \
                or enc_embeds.dtype != self.embed.dtype:
            raise ValueError(
                f"enc_embeds must be (B, frames, {self.cfg.d_model}) in the "
                f"model's dtype {self.embed.dtype}, got {enc_embeds.dtype}"
                f"{tuple(enc_embeds.shape)}")
        b, sf, _ = enc_embeds.shape
        x = enc_embeds @ self.frontend_proj
        positions = torch.arange(sf, dtype=torch.float32,
                                 device=x.device)[None].expand(b, sf)
        for blk in self.enc_blocks:
            x, _ = blk(x, positions)
        return rms_norm(x, self.enc_norm, self.cfg.norm_eps)

    def _shared_ctx(self) -> Optional[dict]:
        """The shared set and its window for the ``shared_attn`` layers
        (the reference's ``shared_params`` and ``shared_window``), None for
        a model without them."""
        if not hasattr(self, "shared"):
            return None
        return {"shared": self.shared,
                "shared_window": shared_window(self.cfg)}

    def _forward_ctx(self, enc_embeds: Optional[torch.Tensor],
                     s: int) -> Optional[dict]:
        """The blocks' context for a forward over ``s`` positions: the
        encoder's output for an encoder-decoder model, the shared set for a
        model with ``shared_attn`` layers, else None (a model without an
        encoder ignores ``enc_embeds``, as the reference does)."""
        if not self.cfg.enc_layers:
            return self._shared_ctx()
        if enc_embeds is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder model: "
                             f"its forward needs enc_embeds (B, {s}, "
                             f"{self.cfg.d_model})")
        if enc_embeds.dim() == 3 and enc_embeds.shape[1] != s:
            raise ValueError(
                f"enc_embeds has {enc_embeds.shape[1]} frames for {s} "
                f"tokens: the encoder runs its rotary at the decoder's "
                f"positions, so the frame count must equal the token count "
                f"(the reference's rule: the encoder sees the same frame "
                f"count)")
        return {"enc_out": self._encode(enc_embeds)}

    def forward(self, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None, *,
                enc_embeds: Optional[torch.Tensor] = None,
                with_aux: bool = False):
        """tokens (B,S) int -> hidden states (B,S,D) after the final norm
        (the reference's ``forward(params, {"tokens": ...})[0]``).

        ``frontend_embeds`` (B,Sf,D), in the model's dtype, are a
        ``vision-stub`` model's patch embeddings: projected by
        ``frontend_proj``, they replace the token embeddings of the first
        Sf positions (the reference's splice; a text model ignores them, as
        the reference does).  ``enc_embeds`` (B,S,D), in the model's dtype,
        are an encoder-decoder model's frame embeddings, which it requires:
        the encoder (:meth:`_encode`) turns them into the ``xdec`` layers'
        cross-attention source; their frame count must equal S (the
        encoder's rotary reads the decoder's positions, as in the
        reference).  With ``with_aux``, ``(hidden, aux)``: the sum
        of the MoE layers' load-balance losses, fp32 (0 for a dense stack),
        which the reference's ``forward`` returns beside the hidden states
        for its loss."""
        b, s = tokens.shape
        x = ee.lookup(self.embed, tokens, strategy="take")
        if self.cfg.modality == "vision-stub" and frontend_embeds is not None:
            if frontend_embeds.dtype != x.dtype or \
                    frontend_embeds.shape[1] > s:
                raise ValueError(
                    f"frontend_embeds {frontend_embeds.dtype}"
                    f"{tuple(frontend_embeds.shape)} do not splice into "
                    f"{s} positions of {x.dtype}")
            fe = frontend_embeds @ self.frontend_proj
            x = torch.cat([fe, x[:, fe.shape[1]:]], dim=1)
        positions = torch.arange(s, dtype=torch.float32,
                                 device=tokens.device)[None].expand(b, s)
        ctx = self._forward_ctx(enc_embeds, s)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for blk in self.blocks:
            x, a = blk(x, positions, ctx)
            if a is not None:
                aux = aux + a
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return (x, aux) if with_aux else x

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor,
             frontend_embeds: Optional[torch.Tensor] = None,
             enc_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The training objective, the reference's single-device
        ``LM.loss``: the mean over tokens of ``logsumexp(logits) -
        logits[label]``, the fp32 logits over the padded vocab (pad rows
        included, as the reference computes them), plus ``0.01 * aux``, the
        MoE load-balance loss.  tokens, labels (B,S) int; a () fp32
        tensor."""
        x, aux = self.forward(tokens, frontend_embeds,
                              enc_embeds=enc_embeds, with_aux=True)
        return ee.xent_vocab_parallel(x, self.embed, labels) + 0.01 * aux

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None,
                enc_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The serving prefill step: the full-sequence forward (with the
        front end's embeddings, if given), returning the last position's
        hidden state (B,1,D)."""
        return self.forward(tokens, frontend_embeds,
                            enc_embeds=enc_embeds)[:, -1:]

    # ---- serving ----
    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.inference_mode()
    def init_caches(self, batch: int, max_len: int,
                    dtype: Optional[torch.dtype] = None) -> list:
        """Empty caches for ``batch`` slots of ``max_len`` positions: one
        dict per layer, in layer order (:func:`.attention.init_kv_cache`;
        :func:`.attention.init_mla_cache` for ``mla`` layers,
        :func:`.ssm.init_mamba_cache` for ``mamba`` layers, which hold no
        positions)."""
        dtype = dtype or self.cfg.torch_dtype
        cfg, dev = self.cfg, self.device
        return [ssm_mod.init_mamba_cache(cfg, batch, dtype, dev)
                if kind == "mamba" else
                (init_mla_cache if kind == "mla" else init_kv_cache)(
                    cfg, batch, max_len, dtype, dev)
                for kind in layer_kinds(cfg)]

    @torch.inference_mode()
    def decode_step(self, tokens_new: torch.Tensor, caches: list,
                    active: Optional[torch.Tensor] = None,
                    batch_ctx: Optional[dict] = None):
        """tokens_new (B,1) -> (logits (B,1,vocab) fp32, caches), the caches
        updated in place.

        An encoder-decoder model needs ``batch_ctx={"enc_out": (B, Sf,
        D)}``, each slot's encoder output (:meth:`_encode`; any Sf), which
        every ``xdec`` layer's cross-attention reads; other models ignore
        it.

        ``active`` (B,) bool masks the continuous-batching batch: inactive
        slots feed token 0 and keep their caches (``len`` included)
        unchanged -- what makes prompt-chunked prefill equal whole-prompt
        prefill however a wave's slots are staggered.  In an MoE layer the
        inactive slots' token-0 rows still take expert capacity, as in the
        reference, so there the tokens depend on how prompts are chunked
        (ROADMAP.md, reference caveat (c))."""
        ctx = self._decode_ctx(batch_ctx, tokens_new.shape[0])
        if active is not None:
            tokens_new = torch.where(active[:, None], tokens_new, 0)
        x = ee.lookup(self.embed, tokens_new, strategy="take")
        for blk, cache in zip(self.blocks, caches):
            x = blk.decode(x, cache, active, ctx)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return ee.logits(x, self.embed)[..., :self.cfg.vocab_size], caches

    def _decode_ctx(self, batch_ctx: Optional[dict],
                    b: int) -> Optional[dict]:
        """The blocks' context for a decode over ``b`` slots: ``batch_ctx``
        checked for an encoder-decoder model, the shared set for a model
        with ``shared_attn`` layers, None for the others."""
        if not self.cfg.enc_layers:
            return self._shared_ctx()
        enc = None if batch_ctx is None else batch_ctx.get("enc_out")
        if enc is None or enc.dim() != 3 or enc.shape[0] != b or \
                enc.shape[2] != self.cfg.d_model or \
                enc.dtype != self.embed.dtype:
            got = None if enc is None else f"{enc.dtype}{tuple(enc.shape)}"
            raise ValueError(
                f"{self.cfg.name} is an encoder-decoder model: its decode "
                f"needs batch_ctx={{'enc_out': ({b}, frames, "
                f"{self.cfg.d_model})}} in {self.embed.dtype}, got {got}")
        return {"enc_out": enc}

    @torch.inference_mode()
    def wave_step(self, tokens, lens, caches: list,
                  batch_ctx: Optional[dict] = None):
        """One serving wave: ``tokens.shape[1]`` masked decode micro-steps.
        ``tokens`` (B,C) ragged-right with per-slot valid counts ``lens``
        (B,) (host arrays or tensors); slot b consumes ``tokens[b, :lens[b]]``
        and idles (caches untouched) afterwards.

        Because each micro-step is :meth:`decode_step` with the
        ``active = t < lens`` mask, splitting a prompt across waves of any
        chunk size replays the same micro-step sequence as one big wave.
        Tokens and lens reach the card in one copy; micro-steps where no
        slot is active change nothing and are skipped, and one where every
        slot is active runs unmasked (the same function).

        ``batch_ctx`` is :meth:`decode_step`'s, for every micro-step.

        Returns ``(logits (B,1,vocab) fp32 at each slot's last valid token,
        caches)`` -- zeros for a slot with ``lens == 0``.  The loop is
        :class:`StaticWave`'s, the one the server's CUDA graphs replay."""
        return StaticWave(self, caches)(tokens, lens, caches, batch_ctx)

    @torch.inference_mode()
    def reset_slots(self, caches: list, keep) -> list:
        """Zero the cache state of retired slots (``keep`` (B,) bool False),
        in place, so a recycled slot starts from position 0 with no stale
        K/V.  Returns ``caches``."""
        keep = torch.as_tensor(np.asarray(keep.cpu() if isinstance(
            keep, torch.Tensor) else keep, bool)).to(self.device)
        zero_slots(caches, keep)
        return caches

    # ---- Ember program compilation ----
    def embedding_program(self, batch: int, seq: int) -> EmbeddingProgram:
        """All irregular lookups of one (batch, seq) step
        (:func:`embedding_program`)."""
        return embedding_program(self.cfg, batch, seq)

    def decode_embed_program(self, batch: int,
                             seq: int = 1) -> EmbeddingProgram:
        """The embed side of one decode wave as its own program (token
        embed + label gather over the shared table, no MoE op): the first
        member of the serving pipeline group."""
        cfg = self.cfg
        return ee.model_embedding_program(
            vocab_size=cfg.padded_vocab, d_model=cfg.d_model,
            tokens=batch * seq, name=f"{cfg.name}-decode-embed")

    def embedding_pipeline(self, batch: int, seq: int = 1,
                           opt_level: str = "O3", depth: int = 2, **kw):
        """The serving :class:`~repro_torch.core.executor.PipelineGroup`:
        the decode-embed program on the model's device and, for MoE models,
        the un-dispatch program (:func:`.moe.undispatch_program` of the
        wave's ``batch * seq`` tokens), as in the reference.

        Defaults to ``backend="cuda"``, the hand-written block gather.  This
        differs from the reference on purpose: the reference defaults to
        ``"jax"`` because only that path rides its jitted wave executable,
        which has no counterpart here; ``"cuda"`` keeps the hand-written
        kernel on the served path.  ``backend="torch"`` (stock
        ``index_select``, one packed copy per wave) stays selectable and
        gives the same bits: a gather is a copy."""
        from ..core.executor import executor_for, pipeline_group
        kw.setdefault("backend", "cuda")
        kw.setdefault("device", self.device)
        progs = [self.decode_embed_program(batch, seq)]
        if has_moe(self.cfg):
            progs.append(moe_mod.undispatch_program(self.cfg, batch * seq))
        # named after these programs: a memoized executor may be shared
        # with a structurally equal program of another name
        return pipeline_group([executor_for(p, opt_level, depth=depth, **kw)
                               for p in progs],
                              names=[p.name for p in progs])

    def compile_embeddings(self, batch: int, seq: int,
                           opt_level: str = "O3"):
        """Compile this model's embedding program (compile-cache backed)."""
        from ..core.pipeline import compile_program
        return compile_program(self.embedding_program(batch, seq), opt_level)

    def embedding_executor(self, batch: int, seq: int,
                           opt_level: str = "O3", mesh=None,
                           hot_rows=None, **kw):
        """The steady-state executor of this model's embedding program on
        the model's device, memoized per signature.  Only ``mesh=None``
        (one device) is ported: the vocab-sharded executor and its hot rows
        wait for ROADMAP.md Queue 1 item 6."""
        from ..core.executor import executor_for
        if mesh is not None or hot_rows is not None:
            raise NotImplementedError(
                "the sharded embedding executor (mesh=, hot_rows=) is not "
                "ported yet (ROADMAP.md, Queue 1 item 6)")
        kw.setdefault("device", self.device)
        return executor_for(self.embedding_program(batch, seq), opt_level,
                            **kw)

    def embedding_table_inputs(self) -> dict:
        """The param-backed tables of :meth:`embedding_program`, keyed the
        way :meth:`ProgramExecutor.update_tables` wants them."""
        return {"tok_embed": {"table": self.embed},
                "label_gather": {"table": self.embed}}


class StaticWave:
    """A serving wave over static buffers, bound to one set of ``caches``:
    :meth:`LM.wave_step` runs it eagerly, and the server's
    :class:`~repro_torch.runtime.server.WaveGraph` captures its micro-step
    and slot-reset bodies in CUDA graphs and replays them.

    Buffers, on the model's device: the token column ``tok`` (B,1) int64,
    the mask ``active`` (B,) bool, the slot-keep mask ``keep`` (B,) bool
    and ``logits_last`` (B,1,vocab) fp32.  A wave copies ``tokens`` and
    ``lens`` to the card in one packed copy, then per micro-step copies in
    ``tok[:, t]`` and runs :meth:`micro_step` when every slot is active,
    else sets ``active = lens > t`` and runs :meth:`masked_micro_step`;
    micro-steps where no slot is active are skipped.  A wave's
    ``batch_ctx`` (an encoder-decoder model's ``{"enc_out": ...}``) is
    held in ``batch_ctx`` for its micro-steps."""

    def __init__(self, lm, caches: list):
        # every cache leaf is batch-major (a mamba layer's has no "len")
        b = next(iter(caches[0].values())).shape[0]
        dev = lm.device
        with torch.inference_mode():     # the caches are inference tensors
            self.tok = torch.zeros((b, 1), dtype=torch.int64, device=dev)
            self.active = torch.zeros(b, dtype=torch.bool, device=dev)
            self.keep = torch.ones(b, dtype=torch.bool, device=dev)
            self.logits_last = torch.zeros((b, 1, lm.cfg.vocab_size),
                                           dtype=torch.float32, device=dev)
        self.lm = lm
        self.caches = caches
        self.batch_ctx = None
        # what a wave runs: these bodies here, their graphs in WaveGraph
        self._full = self.micro_step
        self._masked = self.masked_micro_step
        self._zero = self.zero_slots

    def micro_step(self) -> None:
        """``lm.decode_step`` of ``tok`` with every slot active; its logits
        into ``logits_last``."""
        logits, _ = self.lm.decode_step(self.tok, self.caches,
                                        batch_ctx=self.batch_ctx)
        self.logits_last.copy_(logits)

    def masked_micro_step(self) -> None:
        """``lm.decode_step`` of ``tok`` under the ``active`` mask; the
        active slots' logits into ``logits_last``."""
        logits, _ = self.lm.decode_step(self.tok, self.caches,
                                        active=self.active,
                                        batch_ctx=self.batch_ctx)
        self.logits_last.copy_(torch.where(self.active[:, None, None],
                                           logits, self.logits_last))

    def zero_slots(self) -> None:
        """Zero the cache state of the slots where ``keep`` is False."""
        zero_slots(self.caches, self.keep)

    def _bound(self, caches: list) -> None:
        if caches is not self.caches:
            raise ValueError("the wave runs on the caches it was built on")

    @torch.inference_mode()
    def __call__(self, tokens, lens, caches: list,
                 batch_ctx: Optional[dict] = None):
        """One serving wave (``lm.wave_step``'s contract).  Returns a fresh
        tensor of logits: ``logits_last`` is overwritten by the next
        wave."""
        self._bound(caches)
        self.batch_ctx = batch_ctx
        tokens = np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor)
                            else tokens)
        lens_h = np.asarray(lens.cpu() if isinstance(lens, torch.Tensor)
                            else lens).astype(np.int64)
        b, c = tokens.shape
        packed = np.empty((b, c + 1), np.int64)     # one copy to the card
        packed[:, :c] = tokens
        packed[:, c] = lens_h
        dev = torch.from_numpy(packed).to(self.lm.device, non_blocking=True)
        tok, lens_d = dev[:, :c], dev[:, c]
        self.logits_last.zero_()
        for t in range(int(lens_h.max(initial=0))):
            self.tok.copy_(tok[:, t:t + 1])
            if (lens_h > t).all():
                self._full()
            else:
                torch.gt(lens_d, t, out=self.active)
                self._masked()
        return self.logits_last.clone(), caches

    @torch.inference_mode()
    def reset_slots(self, caches: list, keep) -> list:
        """``lm.reset_slots``: zero the slots whose ``keep`` (a host (B,)
        bool array) is False."""
        self._bound(caches)
        self.keep.copy_(torch.as_tensor(np.asarray(keep, bool)))
        self._zero()
        return caches


def zero_slots(caches: list, keep: torch.Tensor) -> None:
    """Zero every cache leaf of the slots where ``keep`` (B,) bool, on the
    caches' device, is False, in place (the body of
    :meth:`LM.reset_slots`)."""
    for cache in caches:
        for leaf in cache.values():
            leaf.masked_fill_(~keep.view((-1,) + (1,) * (leaf.dim() - 1)), 0)


def has_moe(cfg: ModelConfig) -> bool:
    """Whether the model has MoE layers (and so an MoE dispatch op and an
    un-dispatch pipeline member)."""
    pattern = tuple(cfg.block_pattern) + tuple(cfg.remainder_pattern)
    return bool(cfg.num_experts) and any(k in MOE_KINDS for k in pattern)


def embedding_program(cfg: ModelConfig, batch: int,
                      seq: int) -> EmbeddingProgram:
    """All irregular lookups of one (batch, seq) step as one
    :class:`~repro_torch.core.ops.EmbeddingProgram`: token embedding + label
    gather over the shared embed table, plus the MoE dispatch gather for
    models with MoE blocks."""
    tokens = batch * seq
    extra = []
    if has_moe(cfg):
        extra.append(("moe_dispatch", moe_mod.dispatch_op(cfg, tokens)))
    return ee.model_embedding_program(
        vocab_size=cfg.padded_vocab, d_model=cfg.d_model, tokens=tokens,
        extra_ops=tuple(extra), name=f"{cfg.name}-step")
