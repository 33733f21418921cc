"""LM assembly (counterpart of ``repro/models/lm.py``).

Every block kind of the reference: ``dense`` (GQA attention with partial
rotary + gated MLP), ``dense_local`` (the same with the sliding-window band of
``cfg.sliding_window``), the ``moe`` kind (GQA attention + the MoE FFN),
the ``mla`` kind (DeepSeek's latent attention + the MoE FFN),
whisper's encoder-decoder kinds: ``enc_dense`` (the encoder's blocks:
non-causal self-attention + MLP) and ``xdec`` (causal self-attention,
cross-attention over the encoder's output, MLP), and zamba2's hybrid kinds:
``mamba`` (the Mamba2 SSD block, :mod:`.ssm`) and ``shared_attn`` (causal
attention + MLP from one weight set, :attr:`LM.shared`, shared by every
occurrence; only its two norms are the layer's own), and xLSTM's kinds:
``mlstm`` (the matrix-memory recurrence through the shared gated-linear
scan) and ``slstm`` (the scalar-memory recurrence, step by step), both
:mod:`.xlstm`;
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
:meth:`LM.embedding_executor`).  The reference folds depth
into a ``jax.lax.scan`` over super-blocks; here the layers are an
``nn.ModuleList`` run in order (scan super-blocks first, then the
remainder, as the reference does), and a wave is a Python loop of masked
micro-steps (which the server replays as CUDA graphs on the card:
:class:`repro_torch.runtime.server.WaveGraph`).

**Tensor and expert parallelism** (``LM(cfg, shard=ShardCtx(mesh))``, the
reference's ``LM(cfg, ShardCtx(mesh=...))``; the kinds of
:data:`TP_KINDS`: every attention kind, and zamba2's ``mamba`` and
``shared_attn``).  The port is multi-controller:
one process a rank of the mesh, each holding its slice of every leaf by
:func:`repro_torch.launch.sharding.leaf_blocks` (the query and KV heads of
``wq`` / ``wk`` / ``wv`` by :func:`~repro_torch.launch.sharding.head_plan`,
with a copy of a KV group on every rank of its run where the KV heads are
fewer than the ranks, and ``wo``'s rows after the query heads; MLA's
query heads of ``wq`` / ``w_uk`` / ``w_uv`` likewise, its ``w_dkv`` and
``w_kr`` whole; the hidden columns of ``wi_gate`` / ``wi_up`` by column,
``wo`` by row, the experts of an MoE layer, the vocab rows of ``embed``,
a mamba layer's SSM heads by :func:`~repro_torch.launch.sharding.ssm_plan`
(its ``w_in`` as the rank's x, z and dt columns around the B | C block
every rank copies), the shared attention set by the head plan and its MLP
by column and row;
norms, the router, the shared experts, the front end and the encoder's
final norm replicated).  :attr:`LM.split_leaves` records each split
leaf's blocks.  Every rank of the ``model`` axis is handed the same
tokens and computes the whole function: the embed lookup masked to its
rows and summed over the axis
(:func:`repro_torch.core.embedding_engine.lookup`), each attention and MLP
on its heads and columns with one fp32 all-reduce of the row-parallel
output (:func:`.common.row_parallel`; a rank without query heads adds
zeros), each mamba layer's scan on the rank's SSM heads with its
out-projection row-parallel (:func:`.ssm.mamba_forward`), the MoE FFN
expert parallel (:func:`.moe.moe_ffn`), an encoder's
blocks and a decoder's cross-attention the same way, and a decode step's
logits computed over its vocab slice and all-gathered, so every rank's
argmax is the same.  Every collective goes through the axis's
:class:`~repro_torch.core.shard_plan.Collectives` (:attr:`LM.
collective_stats` counts them).  Model-parallel training (:meth:`LM.loss`
over a mesh, every kind but the MoE ones): under autograd each block's
normed input enters its column-parallel products through the axis's
*enter* (its gradient, the rank's partial, summed over the axis in fp32),
and so does an encoder's output once, for every layer's cross-attention;
each row-parallel product has its backward written out
(:class:`.common.RowParallel`), the masked lookup's combine passes the
cotangent through, and the loss is the vocab-parallel cross entropy.  A
KV copy's gradient is the rank's partial: the trainer sums it over the
copies (:meth:`~repro_torch.runtime.trainer.TrainStep.loss_and_grads`).
The MoE kinds train over a mesh too (expert-parallel training): the leaves
every rank holds whole but uses only in part -- MLA's ``w_dkv`` and
``w_kr``, and on the seq-split path the router and the shared experts with
the FFN input -- enter the rank's share of the layer, their gradients
summed over the axis in one fp32 all-reduce (:mod:`.moe`,
:func:`.attention.mla_forward`), and the loss adds the MoE layers' aux
meaned over the mesh.  zamba2 trains over a mesh the same way: a mamba
layer's input and its B | C columns -- every rank computes B and C whole,
only its heads read them -- enter the rank together, their gradients
summed in one fp32 all-reduce (:mod:`.ssm`), so the copies of B | C step
alike on every rank.  xLSTM's ``mlstm`` and ``slstm`` over a mesh are
ROADMAP.md Queue 1 item 6d-2 b.

**The dry run's lowering options** (``ShardCtx.cost_mode`` and
``ShardCtx.remat``, the reference's): ``remat`` recomputes each block's
forward in the backward through ``torch.utils.checkpoint`` ("dots" saves
the outputs of the plain matrix products ``mm`` / ``addmm`` and of the
row-parallel products after their all-reduce, the counterpart of
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``, and
recomputes the rest, the flash kernel and batched products included;
"full" saves nothing and runs the all-reduces again) -- the same kernels on the same inputs, so the loss
and every gradient keep their bits.  ``cost_mode`` swaps the flash kernel
for the materialised softmax (:func:`.attention.dense_attention`) and the
sLSTM loop for its FLOP stand-in, so the dry run's cost pass counts the
attention's FLOPs; a cost-mode model computes the same function (the sLSTM
excepted) and is never served or trained.  Over a
:class:`~repro_torch.core.shard_plan.DryMesh` (the dry run's abstract
production mesh) an LM is built on the meta device: one rank's slices
without storage, its collectives counted, not run.

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
``mamba.{w_in,conv_w,A_log,D,dt_bias,w_out,norm_z}``, an ``mlstm`` layer's
``norm1`` and ``mlstm.{wq,wk,wv,w_if,b_i,b_f,w_gate,wo}``, an ``slstm``
layer's ``norm1`` and ``slstm.{w_in,r,b,wo}``, a ``shared_attn``
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

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core import embedding_engine as ee
from ..core.executor import resolve_device
from ..core.ops import EmbeddingProgram
from ..launch.sharding import leaf_blocks
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .attention import (attn_decode, attn_forward, init_attn, init_kv_cache,
                        init_mla, init_mla_cache, local_heads, mla_decode,
                        mla_forward)
from .common import (ModelConfig, RowOutputs, gated_mlp, init_mlp, init_rms,
                     rms_norm)

#: the block kinds with an MoE FFN (the reference's ``moe_mod`` users)
MOE_KINDS = ("moe", "mla")
#: the block kinds that run split over a mesh's model axis
TP_KINDS = ("dense", "dense_local", "moe", "mla", "enc_dense", "xdec",
            "mamba", "shared_attn")


@dataclasses.dataclass
class ShardCtx:
    """How an LM is split over a mesh (the reference's ``ShardCtx``): the
    ``mesh`` (a ``DeviceMesh`` over ``("data", "model")``:
    :func:`repro_torch.launch.mesh.make_host_mesh`; None on one device),
    the axes the batch splits over, the axis the weights split over, and
    whether the embed lookup takes ``cfg.embed_strategy`` (the reference's
    ``shard_map`` lookup) or its plain ``take`` over the sharded table.  A
    rank holds only its vocab rows either way, so the port runs the masked
    lookup for both, and both give the same values.  ``remat`` ("none",
    "dots" or "full") and ``cost_mode``: the dry run's lowering options
    (module docstring)."""
    mesh: object = None
    data_axes: tuple = ("data",)
    model_axis: str = "model"
    use_shard_map_embed: bool = True
    remat: str = "none"
    cost_mode: bool = False


#: what ``ShardCtx.remat="dots"`` saves: the outputs of the products
#: without batch dims (``dots_with_no_batch_dims_saveable``); a
#: row-parallel product's reduced output is kept by its own record
#: (:class:`.common.RowOutputs`)
_SAVED_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm)
REMATS = ("none", "dots", "full")


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if getattr(op, "overloadpacket", None) in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_block(remat: str, blk, *args):
    """``blk(*args)`` under the ``remat`` policy: itself for "none" or where
    autograd records nothing; else through ``torch.utils.checkpoint``
    (non-reentrant; no RNG state kept: no block draws random numbers),
    "dots" with a selective context saving :data:`_SAVED_DOTS`' outputs
    and a :class:`.common.RowOutputs` keeping the row-parallel products'
    (so their all-reduces do not run again in the backward), "full" saving
    only the block's inputs."""
    if remat == "none" or not torch.is_grad_enabled():
        return blk(*args)
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    fn, kw = blk, {}
    if remat == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _save_dots)
        fn = functools.partial(RowOutputs().run, blk)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


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

    #: the model axis (a :class:`~repro_torch.core.shard_plan.ModelAxis`)
    #: the block's weights are split over, None on one device
    tp = None
    #: the cost mode's materialised attention (``ShardCtx.cost_mode``)
    cost_mode: bool = False

    _init_attn = staticmethod(init_attn)

    def _init_ffn(self, gen, cfg, dtype, device) -> None:
        self.mlp = nn.ParameterDict({
            k: _frozen(v) for k, v in init_mlp(gen, cfg.d_model, cfg.d_ff,
                                               dtype, device).items()})

    def _attend(self, h: torch.Tensor, positions: torch.Tensor):
        return attn_forward(self.attn, h, self.cfg, positions=positions,
                            causal=True, tp=self.tp, dense=self.cost_mode)

    def _attend_decode(self, h: torch.Tensor, cache: dict, active):
        return attn_decode(self.attn, h, self.cfg, cache, active=active,
                           tp=self.tp)

    def _ffn(self, h: torch.Tensor) -> tuple:
        return gated_mlp(self._enter(h), self.mlp, self.cfg.act,
                         self.tp), None

    def _enter(self, h: torch.Tensor) -> torch.Tensor:
        """``h`` where it enters this rank's column-parallel products: under
        autograd on a rank, its gradient (the rank's partial) is summed
        over the model axis (:meth:`~repro_torch.core.shard_plan.ModelAxis
        .enter`); the tensor itself otherwise."""
        return h if self.tp is None else self.tp.enter(h)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                ctx: Optional[dict] = None) -> tuple:
        eps = self.cfg.norm_eps
        x = x + self._attend(self._enter(rms_norm(x, self.norm1, eps)),
                             positions)
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
                            causal=True, window=self.cfg.sliding_window,
                            tp=self.tp, dense=self.cost_mode)

    def _attend_decode(self, h: torch.Tensor, cache: dict, active):
        return attn_decode(self.attn, h, self.cfg, cache,
                           window=self.cfg.sliding_window, active=active,
                           tp=self.tp)


class MoeBlock(DenseBlock):
    """``moe``: causal GQA attention + the MoE FFN (routed experts, and the
    shared ones where the config has them), pre-norm residual."""

    def _init_ffn(self, gen, cfg, dtype, device) -> None:
        self.moe = ParamTree(moe_mod.init_moe(gen, cfg, dtype, device))

    def _ffn(self, h: torch.Tensor) -> tuple:
        """The MoE FFN and the layer's local aux (the LM means the layers'
        sum over the mesh once, :meth:`LM.forward`); expert parallel on a
        rank, where the FFN input enters the path itself
        (:func:`.moe.moe_ffn`)."""
        if self.tp is None:
            return moe_mod.moe_ffn(self.moe, h, self.cfg)
        return moe_mod.moe_ffn(self.moe, h, self.cfg, mesh=self.tp.mesh,
                               ep_axis=self.tp.axis)


class MlaBlock(MoeBlock):
    """``mla``: DeepSeek's multi-head latent attention + the MoE FFN,
    pre-norm residual; its cache is the latent one
    (:func:`.attention.init_mla_cache`)."""

    _init_attn = staticmethod(init_mla)

    def _attend(self, h: torch.Tensor, positions: torch.Tensor):
        return mla_forward(self.attn, h, self.cfg, positions=positions,
                           dense=self.cost_mode, tp=self.tp)

    def _attend_decode(self, h: torch.Tensor, cache: dict, active):
        return mla_decode(self.attn, h, self.cfg, cache, active=active,
                          tp=self.tp)


class EncBlock(DenseBlock):
    """``enc_dense``: :class:`DenseBlock` with non-causal self-attention --
    whisper's encoder block (the reference's ``block_apply`` with ``causal
    = kind != "enc_dense"``).  It runs only in :meth:`LM._encode`, never in
    decode."""

    def _attend(self, h: torch.Tensor, positions: torch.Tensor):
        return attn_forward(self.attn, h, self.cfg, positions=positions,
                            causal=False, tp=self.tp, dense=self.cost_mode)


class XdecBlock(DenseBlock):
    """``xdec``: whisper's decoder block, pre-norm residual -- causal
    self-attention (``norm1``, ``attn``), cross-attention over the
    encoder's output ``ctx["enc_out"]`` (``norm_x``, ``xattn``: no rotary,
    not causal, K and V projected from ``enc_out`` at every call), the
    MLP (``norm2``, ``mlp``).  Its cache is the self-attention's K/V
    (:func:`.attention.init_kv_cache`); the encoder's output comes from the
    context, never from the cache.  On a rank both attentions run on the
    rank's heads; ``enc_out`` has entered the rank once, in
    :meth:`LM._forward_ctx`."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device):
        super().__init__(cfg, gen, dtype, device)
        self.norm_x = _frozen(init_rms(cfg.d_model, dtype, device))
        self.xattn = nn.ParameterDict({
            k: _frozen(v) for k, v in init_attn(gen, cfg, dtype,
                                                device).items()})

    def _cross(self, x: torch.Tensor, ctx: Optional[dict],
               dense: bool = False) -> torch.Tensor:
        h = self._enter(rms_norm(x, self.norm_x, self.cfg.norm_eps))
        return x + attn_forward(self.xattn, h, self.cfg, positions=None,
                                causal=False, kv=ctx["enc_out"], tp=self.tp,
                                dense=dense)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                ctx: Optional[dict] = None) -> tuple:
        eps = self.cfg.norm_eps
        x = x + self._attend(self._enter(rms_norm(x, self.norm1, eps)),
                             positions)
        x = self._cross(x, ctx, self.cost_mode)
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


class RecurrentBlock(nn.Module):
    """A recurrent mixer in a pre-norm residual (the reference's
    ``block_apply`` / ``block_decode`` of ``mamba``, ``mlstm`` and
    ``slstm``): ``norm1`` and the mixer's parameters under :attr:`NAME`.
    Its cache holds the recurrent state and no positions; :meth:`decode`
    updates it in place, an inactive slot's leaves kept bit for bit under
    ``active``.  A subclass names the mixer's ``init``, ``forward``,
    ``decode`` and ``init_cache`` functions."""

    NAME: str
    cost_mode: bool = False
    #: the model axis (only a mamba layer splits over one), None on one
    #: device
    tp = None

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.norm1 = _frozen(init_rms(cfg.d_model, dtype, device))
        self.add_module(self.NAME, nn.ParameterDict({
            k: _frozen(v) for k, v in self._init(gen, cfg, dtype,
                                                 device).items()}))

    @property
    def mixer(self) -> nn.ParameterDict:
        return self._modules[self.NAME]

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                ctx: Optional[dict] = None) -> tuple:
        h = rms_norm(x, self.norm1, self.cfg.norm_eps)
        return x + self._forward(self.mixer, h, self.cfg), None

    def decode(self, x: torch.Tensor, cache: dict,
               active: Optional[torch.Tensor] = None,
               ctx: Optional[dict] = None) -> torch.Tensor:
        h = rms_norm(x, self.norm1, self.cfg.norm_eps)
        return x + self._decode(self.mixer, h, self.cfg, cache,
                                active=active)


class MambaBlock(RecurrentBlock):
    """``mamba``: the Mamba2 SSD block (``norm1``, ``mamba.*``; :mod:`.ssm`);
    its cache is ``{state, conv}`` (:func:`.ssm.init_mamba_cache`).  On a
    rank of a model axis it runs the rank's SSM heads, its input and B | C
    entering the rank in :func:`.ssm.mamba_forward`, and its cache holds
    those heads."""

    NAME = "mamba"
    _init = staticmethod(ssm_mod.init_mamba)

    def _forward(self, p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        return ssm_mod.mamba_forward(p, h, cfg, tp=self.tp)

    def _decode(self, p, h: torch.Tensor, cfg: ModelConfig, cache: dict, *,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
        return ssm_mod.mamba_decode(p, h, cfg, cache, active=active,
                                    tp=self.tp)

    def init_cache(self, cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device=None) -> dict:
        return ssm_mod.init_mamba_cache(cfg, batch, dtype, device,
                                        heads=self.mamba["A_log"].shape[0])


class MlstmBlock(RecurrentBlock):
    """``mlstm``: xLSTM's matrix-memory block (``norm1``, ``mlstm.*``;
    :mod:`.xlstm`); its cache is ``{C, n}``
    (:func:`.xlstm.init_mlstm_cache`)."""

    NAME = "mlstm"
    _init = staticmethod(xlstm_mod.init_mlstm)
    _forward = staticmethod(xlstm_mod.mlstm_forward)
    _decode = staticmethod(xlstm_mod.mlstm_decode)
    init_cache = staticmethod(xlstm_mod.init_mlstm_cache)


class SlstmBlock(RecurrentBlock):
    """``slstm``: xLSTM's scalar-memory block (``norm1``, ``slstm.*``;
    :mod:`.xlstm`); its cache is ``{h, c, n, m}``
    (:func:`.xlstm.init_slstm_cache`)."""

    NAME = "slstm"
    _init = staticmethod(xlstm_mod.init_slstm)
    _decode = staticmethod(xlstm_mod.slstm_decode)

    def _forward(self, p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        return xlstm_mod.slstm_forward(p, h, cfg, cost_mode=self.cost_mode)
    init_cache = staticmethod(xlstm_mod.init_slstm_cache)


class SharedAttnBlock(nn.Module):
    """``shared_attn``: causal attention + gated MLP, pre-norm residual,
    whose weights are the model's one shared set ``ctx["shared"]``
    (``attn.*``, ``mlp.*``; :attr:`LM.shared`); the layer's own parameters
    are its two norms.  The attention's window is ``ctx["shared_window"]``
    (the reference's: a window only for a hybrid model that is not
    ``long_context_ok``).  Its cache is a KV cache
    (:func:`.attention.init_kv_cache`).  On a rank of a model axis the
    shared set holds the rank's heads (the head plan) and MLP columns, and
    the block runs them as :class:`DenseBlock` does: each normed input
    enters the rank, the attention and the MLP output are row-parallel."""

    cost_mode: bool = False
    tp = None

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.norm1 = _frozen(init_rms(cfg.d_model, dtype, device))
        self.norm2 = _frozen(init_rms(cfg.d_model, dtype, device))

    _enter = DenseBlock._enter

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                ctx: Optional[dict] = None) -> tuple:
        cfg, sp = self.cfg, ctx["shared"]
        h = self._enter(rms_norm(x, self.norm1, cfg.norm_eps))
        x = x + attn_forward(sp["attn"], h, cfg, positions=positions,
                             causal=True, window=ctx["shared_window"],
                             tp=self.tp, dense=self.cost_mode)
        h = self._enter(rms_norm(x, self.norm2, cfg.norm_eps))
        return x + gated_mlp(h, sp["mlp"], cfg.act, self.tp), None

    def decode(self, x: torch.Tensor, cache: dict,
               active: Optional[torch.Tensor] = None,
               ctx: Optional[dict] = None) -> torch.Tensor:
        cfg, sp = self.cfg, ctx["shared"]
        h = rms_norm(x, self.norm1, cfg.norm_eps)
        x = x + attn_decode(sp["attn"], h, cfg, cache,
                            window=ctx["shared_window"], active=active,
                            tp=self.tp)
        h = rms_norm(x, self.norm2, cfg.norm_eps)
        return x + gated_mlp(h, sp["mlp"], cfg.act, self.tp)


BLOCKS = {"dense": DenseBlock, "dense_local": LocalBlock, "moe": MoeBlock,
          "mla": MlaBlock, "enc_dense": EncBlock, "xdec": XdecBlock,
          "mamba": MambaBlock, "shared_attn": SharedAttnBlock,
          "mlstm": MlstmBlock, "slstm": SlstmBlock}


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
    """The decoder stack of a config (blocks of any kind in :data:`BLOCKS`;
    another kind raises ``ValueError``, as in the reference), for an
    encoder-decoder config (``cfg.enc_layers``) its
    encoder: ``enc_layers`` ``enc_dense`` blocks and ``enc_norm``, and for a
    config with ``shared_attn`` layers the one weight set they share,
    :attr:`shared`.

    Built on ``device`` (the CUDA card unless ``device="cpu"``; ``"meta"``
    builds the module tree without memory) and initialised there from
    ``seed`` with an explicit :class:`torch.Generator`: embed N(0, 0.02),
    norms 1, weights N(0, fan_in^-1/2), in ``cfg.dtype``; a front end's
    ``frontend_proj`` is the identity, as the reference's.

    With ``shard`` (a :class:`ShardCtx` whose mesh has a model axis wider
    than 1; module docstring) this process is one rank: each leaf is made
    as the single-device ``LM(cfg, seed=seed)`` makes it, on the mesh's
    device, and only the rank's slice is kept, one layer at a time, so no
    rank ever holds the whole model and the ranks' slices join to the
    single device's tensors bit for bit (:func:`repro_torch.launch
    .sharding.join_leaf`; the shared attention set, built once, likewise
    under its ``shared.*`` names).  A kind outside :data:`TP_KINDS`
    (xLSTM's) raises ``NotImplementedError``; any head counts split (the
    head plan; SSM heads by ``ssm_plan``, a rank possibly holding none),
    but a hidden width (the shared MLP's included), an expert count or a
    vocab that does not split evenly over the axis raises ``ValueError``,
    before anything is allocated.
    :attr:`tp` is the rank's :class:`~repro_torch.core.shard_plan
    .ModelAxis` (None on one device), :attr:`split_leaves` the blocks of
    every leaf that differs between ranks (``{name: LeafBlocks}``)."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0,
                 shard: Optional[ShardCtx] = None):
        super().__init__()
        kinds = tuple(cfg.block_pattern) + tuple(cfg.remainder_pattern)
        for kind in kinds:
            if kind not in BLOCKS:
                raise ValueError(kind)
        self.cfg = cfg
        self.shard = shard or ShardCtx()
        if self.shard.remat not in REMATS:
            raise ValueError(f"remat {self.shard.remat!r} is none of "
                             f"{REMATS}")
        meta = device is not None and torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else resolve_device(device)
        self.split_leaves: dict = {}
        self.tp = self._model_axis(kinds, dev)
        gen = None if meta else torch.Generator(device=dev).manual_seed(seed)
        dtype = cfg.torch_dtype
        if meta:
            embed = torch.empty((cfg.padded_vocab, cfg.d_model), dtype=dtype,
                                device=dev)
        else:
            embed = (torch.randn((cfg.padded_vocab, cfg.d_model),
                                 generator=gen, dtype=torch.float32,
                                 device=dev) * 0.02).to(dtype)
        self.embed = _frozen(self._local(embed, "embed"))
        del embed
        self.final_norm = _frozen(init_rms(cfg.d_model, dtype, dev))
        if cfg.modality != "text":
            self.frontend_proj = _frozen(torch.eye(cfg.d_model, dtype=dtype,
                                                   device=dev))
        blocks = []
        for li, kind in enumerate(layer_kinds(cfg)):
            blk = BLOCKS[kind](cfg, gen, dtype, dev)
            self._place(blk, f"blocks.{li}")
            blocks.append(blk)
        self.blocks = nn.ModuleList(blocks)
        if "shared_attn" in kinds:      # the rank's slices, by name
            self.shared = ParamTree({
                part: {k: self._local(v, f"shared.{part}.{k}")
                       for k, v in tree.items()}
                for part, tree in (
                    ("attn", init_attn(gen, cfg, dtype, dev)),
                    ("mlp", init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                     dev)))})
        if cfg.enc_layers:
            enc = []
            for li in range(cfg.enc_layers):
                enc.append(EncBlock(cfg, gen, dtype, dev))
                self._place(enc[-1], f"enc_blocks.{li}")
            self.enc_blocks = nn.ModuleList(enc)
            self.enc_norm = _frozen(init_rms(cfg.d_model, dtype, dev))

    def _place(self, blk: nn.Module, prefix: str) -> None:
        """Keep the rank's slice of each of ``blk``'s leaves (its
        ``state_dict`` names under ``prefix``) and hand it the model axis
        and the cost mode."""
        if self.tp is not None:
            for name, prm in blk.named_parameters():
                prm.data = self._local(prm.data, f"{prefix}.{name}")
            blk.tp = self.tp
        blk.cost_mode = self.shard.cost_mode

    def _model_axis(self, kinds: tuple, dev: torch.device):
        """The model axis this rank's weights split over (None on one
        device or a 1-wide axis), after checking that the config splits
        over it."""
        from ..core.shard_plan import DryMesh, model_axis, shard_count
        sh, cfg = self.shard, self.cfg
        n = shard_count(sh.mesh, sh.model_axis)
        if n == 1:
            return None
        out = sorted({k for k in kinds if k not in TP_KINDS})
        if out:
            raise NotImplementedError(
                f"the block kinds {out} of {cfg.name} over a mesh are not "
                f"ported yet (ROADMAP.md, Queue 1 item 6d-2 b)")
        # heads of any count split (the head plan); these must split evenly
        split = {"padded_vocab": cfg.padded_vocab}
        if cfg.enc_layers or any(k in ("dense", "dense_local", "xdec",
                                        "shared_attn") for k in kinds):
            split["d_ff"] = cfg.d_ff
        if any(k in MOE_KINDS for k in kinds):
            split["num_experts"] = cfg.num_experts
        for what, size in split.items():
            if size % n:
                raise ValueError(
                    f"{cfg.name}'s {what} {size} does not split over the "
                    f"{sh.model_axis} axis of {n}: hidden widths, experts "
                    f"and vocab rows split evenly")
        # the dry run's abstract mesh holds its rank's slices on meta
        dry = isinstance(sh.mesh, DryMesh)
        if (dev.type == "meta") != dry or sh.mesh.device_type != dev.type:
            raise ValueError(f"a sharded LM is built on its mesh's device "
                             f"({sh.mesh.device_type}), not {dev}")
        return model_axis(sh.mesh, sh.model_axis, dev)

    def _local(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's slice of the full leaf ``t`` (``t`` itself on one
        device or where the leaf is whole on every rank), a tensor of its
        own, its blocks recorded in :attr:`split_leaves`."""
        if self.tp is None:
            return t
        blk = leaf_blocks(name, tuple(t.shape), self.cfg, self.tp.size)
        if blk is None:
            return t
        self.split_leaves[name] = blk
        return blk.take(t, self.tp.rank).clone(
            memory_format=torch.contiguous_format)

    @property
    def collective_stats(self) -> Optional[dict]:
        """The model axis's collective counters (``collectives``,
        ``staged_bytes``, ``collective_ms``; shared by every model on the
        same mesh axis in this process), None on one device."""
        return None if self.tp is None else self.tp.stats

    def _lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """The token embeddings: ``take`` on one device, the vocab-sharded
        lookup over the model axis (``cfg.embed_strategy``, or
        ``masked_psum`` where it is not a sharded one) on a rank."""
        if self.tp is None:
            return ee.lookup(self.embed, tokens, strategy="take")
        sh = self.shard
        strategy = self.cfg.embed_strategy if sh.use_shard_map_embed \
            else "masked_psum"
        if strategy not in ee.SHARDED_STRATEGIES + ("one_hot",):
            strategy = "masked_psum"
        scatter = strategy == "masked_psum_scatter"
        if scatter and tokens.shape[-1] % self.tp.size:
            strategy, scatter = "masked_psum", False
        x = ee.lookup(self.embed, tokens, mesh=sh.mesh,
                      vocab_axis=sh.model_axis, strategy=strategy)
        # the blocks take the whole sequence on every rank
        return self.tp.gather(x, x.dim() - 2) if scatter else x

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
            x, _ = remat_block(self.shard.remat, blk, x, positions)
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
        enc_out = self._encode(enc_embeds)
        # every xdec layer's cross-attention K/V are column-parallel
        # products of it: one entry sums their gradients over the axis
        return {"enc_out": enc_out if self.tp is None
                else self.tp.enter(enc_out)}

    def _data_axes(self, data_axes: Optional[tuple]) -> tuple:
        """``data_axes``, by default the :class:`ShardCtx`'s that the mesh
        has."""
        if data_axes is not None:
            return tuple(data_axes)
        return tuple(a for a in self.shard.data_axes
                     if a in self.shard.mesh.mesh_dim_names)

    def forward(self, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None, *,
                enc_embeds: Optional[torch.Tensor] = None,
                with_aux: bool = False, data_axes: Optional[tuple] = None):
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
        for its loss; over a mesh meaned over the model axis and
        ``data_axes`` (:meth:`loss`'s) as the reference's layers ``pmean``
        theirs, once for the sum of the layers
        (:func:`.moe.mean_aux`)."""
        b, s = tokens.shape
        x = self._lookup(tokens)
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
            x, a = remat_block(self.shard.remat, blk, x, positions, ctx)
            if a is not None:
                aux = aux + a
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        if not with_aux:
            return x
        if self.shard.mesh is not None and has_moe(self.cfg):
            aux = moe_mod.mean_aux(aux, self.shard.mesh,
                                   self.shard.model_axis,
                                   self._data_axes(data_axes), s)
        return x, aux

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor,
             frontend_embeds: Optional[torch.Tensor] = None,
             enc_embeds: Optional[torch.Tensor] = None, *,
             data_axes: Optional[tuple] = None) -> torch.Tensor:
        """The training objective, the reference's ``LM.loss``: the mean
        over tokens of ``logsumexp(logits) - logits[label]``, the fp32
        logits over the padded vocab (pad rows included, as the reference
        computes them), plus ``0.01 * aux``, the MoE load-balance loss.
        tokens, labels (B,S) int; a () fp32 tensor.

        Over a mesh (every kind of :data:`TP_KINDS`) this rank passes its
        data block of the batch (the same on every rank of the model
        axis): the sharded forward, then the vocab-parallel cross entropy
        (:func:`~repro_torch.core.embedding_engine.xent_vocab_parallel`)
        over the model axis, meaned over ``data_axes`` -- the axes the
        batch was split over; by default the :class:`ShardCtx`'s that the
        mesh has, ``()`` where every rank was handed the whole batch --
        and, for a model with MoE layers, ``0.01 * aux`` with the aux
        meaned over the model axis and ``data_axes`` (expert-parallel
        training: the backward of :func:`.moe.moe_ffn` over the mesh, the
        module docstring of :mod:`.moe`).  The gradient a backward leaves
        is the rank's own tokens' (the trainer means it over the data
        axes)."""
        mesh = self.shard.mesh
        if mesh is None:
            x, aux = self.forward(tokens, frontend_embeds,
                                  enc_embeds=enc_embeds, with_aux=True)
            return ee.xent_vocab_parallel(x, self.embed, labels) + \
                0.01 * aux
        data_axes = self._data_axes(data_axes)
        x, aux = self.forward(tokens, frontend_embeds, enc_embeds=enc_embeds,
                              with_aux=True, data_axes=data_axes)
        ce = ee.xent_vocab_parallel(x, self.embed, labels, mesh=mesh,
                                    vocab_axis=self.shard.model_axis,
                                    data_axes=data_axes)
        return ce + 0.01 * aux if has_moe(self.cfg) else ce

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
        :func:`.attention.init_mla_cache` for ``mla`` layers; a recurrent
        layer's state, which holds no positions: ``mamba``
        (:func:`.ssm.init_mamba_cache`), ``mlstm`` and ``slstm``
        (:func:`.xlstm.init_mlstm_cache`, :func:`.xlstm.init_slstm_cache`)).
        A rank of a sharded model keeps its KV heads (the head plan's:
        a copy of its group's where the KV heads are fewer than the ranks,
        none where it holds no query head; the shared set's for a
        ``shared_attn`` layer), an MLA layer's whole latent and a mamba
        layer's SSM heads (:func:`repro_torch.launch.sharding
        .cache_blocks`)."""
        dtype = dtype or self.cfg.torch_dtype
        cfg, dev = self.cfg, self.device
        return [blk.init_cache(cfg, batch, dtype, dev)
                if isinstance(blk, RecurrentBlock) else
                init_mla_cache(cfg, batch, max_len, dtype, dev)
                if isinstance(blk, MlaBlock) else
                init_kv_cache(cfg, batch, max_len, dtype, dev,
                              kv_heads=local_heads(
                                  self.shared["attn"]
                                  if isinstance(blk, SharedAttnBlock)
                                  else blk.attn, cfg)[1])
                for blk in self.blocks]

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
        (ROADMAP.md, reference caveat (c)).

        On a rank of a sharded model each rank computes the fp32 logits of
        its vocab rows, and one all-gather gives every rank the whole
        row, so every rank takes the same argmax."""
        ctx = self._decode_ctx(batch_ctx, tokens_new.shape[0])
        if active is not None:
            tokens_new = torch.where(active[:, None], tokens_new, 0)
        x = self._lookup(tokens_new)
        for blk, cache in zip(self.blocks, caches):
            x = blk.decode(x, cache, active, ctx)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        lg = ee.logits(x, self.embed)
        if self.tp is not None:
            lg = self.tp.gather(lg, lg.dim() - 1)
        return lg[..., :self.cfg.vocab_size], caches

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
        gives the same bits: a gather is a copy.  A sharded model raises:
        its decode-embed program reads the whole table (ROADMAP.md, Queue
        1 item 6d-3)."""
        from ..core.executor import executor_for, pipeline_group
        if self.tp is not None:
            raise NotImplementedError(
                "the serving pipeline group of a sharded LM is not ported yet "
                "(ROADMAP.md, Queue 1 item 6d-3)")
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
                           opt_level: str = "O3", mesh="auto",
                           hot_rows=None, **kw):
        """The steady-state executor of this model's embedding program on
        the model's device, memoized per signature.  ``mesh="auto"`` takes
        the model's :class:`ShardCtx` mesh: over a model axis wider than 1
        the executor is the vocab-sharded one, its stacked tables split
        over the axis; ``mesh=None`` forces the single-device executor.
        ``hot_rows`` replicate a classified head of each vocab on every
        shard; ``exchange=`` / ``replicate_outputs=`` (through ``**kw``)
        pick the sharded exchange, as in
        :func:`~repro_torch.core.executor.executor_for`."""
        from ..core.executor import executor_for
        if mesh == "auto":
            mesh = self.shard.mesh
        kw.setdefault("device", self.device)
        return executor_for(self.embedding_program(batch, seq), opt_level,
                            mesh=mesh, shard_axis=self.shard.model_axis,
                            hot_rows=hot_rows, **kw)

    def embedding_table_inputs(self) -> dict:
        """The param-backed tables of :meth:`embedding_program`, keyed the
        way :meth:`ProgramExecutor.update_tables` wants them.  On a rank of
        a sharded model the table is the rank's vocab rows, which the
        vocab-sharded executor stacks as they are where the slot has no hot
        rows (:func:`repro_torch.core.shard_plan.local_stack_table`); a hot
        slab needs every rank's rows (the full table)."""
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
        # every cache leaf is batch-major (a recurrent layer's has no "len")
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
