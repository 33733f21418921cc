"""The dry run's step bundles (counterpart of ``repro/launch/steps.py``).

The reference builds each (arch × shape × mesh) cell's step from
``ShapeDtypeStruct`` stand-ins and lowers it for a fake 512-device mesh.
The port builds ONE rank's step on the ``meta`` device -- its parameter
slices, optimizer state, batch block and caches as meta tensors, shaped
but without storage -- over an abstract mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`), and the dry run
(:mod:`.dryrun`) runs it under a counter.  The step is the program users
run: the training step is :class:`repro_torch.runtime.trainer.TrainStep`
(``LM.loss``, its backward, the gradients meaned over every data axis,
AdamW over the rank's shards with ZeRO-1), the prefill ``LM.prefill`` and
the decode step ``LM.decode_step``.

:data:`SHAPES`, :func:`shape_applicable` and :func:`make_batch_struct` are
the reference's: the same cells, skips and global batch shapes and dtypes
(here meta tensors).  A bundle takes the rank's block of each batch leaf by
:func:`repro_torch.launch.sharding.batch_specs`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.common import ModelConfig
from ..models.lm import LM, ShardCtx
from . import sharding as shd
from .mesh import data_axes_of

SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the documented skip reason
    (the reference's)."""
    if shape_name == "long_500k" and not cfg.long_context_ok:
        return ("full-attention arch: 500k decode needs sub-quadratic "
                "attention state (DESIGN.md §4)")
    return None


def make_batch_struct(cfg: ModelConfig, seq: int, batch: int, kind: str,
                      device="meta") -> dict:
    """The step's global batch as tensors without storage (the reference's
    ``ShapeDtypeStruct``s): int32 ``tokens`` (and ``labels`` to train), a
    decode step's one new token, an ``audio-stub`` model's ``enc_embeds``
    and a ``vision-stub`` model's ``frontend_embeds`` in the model's
    dtype."""
    i32 = dict(dtype=torch.int32, device=device)
    d = dict(dtype=cfg.torch_dtype, device=device)
    out: dict = {}
    if kind == "train":
        out["tokens"] = torch.empty((batch, seq), **i32)
        out["labels"] = torch.empty((batch, seq), **i32)
    elif kind == "prefill":
        out["tokens"] = torch.empty((batch, seq), **i32)
    else:  # decode: one new token against a cache of `seq`
        out["tokens"] = torch.empty((batch, 1), **i32)
    if cfg.modality == "audio-stub" and kind != "decode":
        out["enc_embeds"] = torch.empty((batch, seq, cfg.d_model), **d)
    if cfg.modality == "vision-stub" and kind != "decode":
        from ..configs.llava_next_34b import VISION_TOKENS
        n = min(VISION_TOKENS, seq)
        out["frontend_embeds"] = torch.empty((batch, n, cfg.d_model), **d)
    return out


@dataclasses.dataclass
class StepBundle:
    """One rank's step of an (arch × shape × mesh) cell: ``fn(*args)``
    runs it; ``args`` are the rank's tensors (meta on a dry mesh: its
    slices, where the reference passes global stand-ins and their
    ``in_shardings``); ``lm`` the rank's model."""
    fn: object
    args: tuple
    kind: str
    lm: LM


def make_lm(cfg: ModelConfig, mesh, remat: str = "dots",
            cost_mode: bool = False, device="meta") -> LM:
    """The rank's LM over ``mesh`` (meta tensors on a dry mesh)."""
    shard = ShardCtx(mesh=mesh, data_axes=data_axes_of(mesh),
                     model_axis="model", remat=remat, cost_mode=cost_mode)
    return LM(cfg, device=device, shard=shard)


def _local_batch(struct: dict, batch: int, mesh) -> dict:
    """The rank's block of each leaf by ``batch_specs``, a tensor of its
    own (its bytes are the rank's, not the global batch's)."""
    specs = shd.batch_specs(struct, batch, mesh, data_axes_of(mesh))
    return {k: shd.local_shard(v, specs[k], mesh).clone()
            for k, v in struct.items()}


def build_train_bundle(cfg: ModelConfig, mesh, seq: int, batch: int,
                       remat: str = "dots", cost_mode: bool = False,
                       device="meta") -> StepBundle:
    """The training step of ``Trainer`` (:class:`~repro_torch.runtime
    .trainer.TrainStep`) on the rank's block of a global ``batch`` of
    ``seq`` tokens: args ``(state, batch)``, the state's parameters and
    AdamW moments the rank's, the moments ZeRO-1's rows
    (``sharding.train_specs``, the reference bundle's specs)."""
    from ..runtime.trainer import TrainStep
    lm = make_lm(cfg, mesh, remat, cost_mode, device)
    step = TrainStep(lm, batch, seq, in_shardings=shd.train_specs(
        cfg, mesh, batch, seq, data_axes_of(mesh)))
    local = _local_batch(
        make_batch_struct(cfg, seq, batch, "train", device), batch, mesh)
    return StepBundle(step, (step.init_state(), local), "train", lm)


def build_prefill_bundle(cfg: ModelConfig, mesh, seq: int, batch: int,
                         cost_mode: bool = False,
                         device="meta") -> StepBundle:
    """``LM.prefill`` of the rank's block of a global ``batch`` of ``seq``
    tokens: args ``(batch,)``."""
    lm = make_lm(cfg, mesh, remat="none", cost_mode=cost_mode,
                 device=device)
    local = _local_batch(
        make_batch_struct(cfg, seq, batch, "prefill", device), batch, mesh)

    def prefill_step(batch_):
        return lm.prefill(batch_["tokens"], batch_.get("frontend_embeds"),
                          batch_.get("enc_embeds"))
    return StepBundle(prefill_step, (local,), "prefill", lm)


def build_decode_bundle(cfg: ModelConfig, mesh, cache_len: int, batch: int,
                        cost_mode: bool = False,
                        device="meta") -> StepBundle:
    """One ``LM.decode_step`` of the rank's slots of a global ``batch``
    against caches of ``cache_len`` positions (an encoder-decoder model's
    encoder output beside them): args ``(tokens, caches, extra)``."""
    lm = make_lm(cfg, mesh, remat="none", cost_mode=cost_mode,
                 device=device)
    local = _local_batch(
        make_batch_struct(cfg, cache_len, batch, "decode", device), batch,
        mesh)
    b_local = local["tokens"].shape[0]
    caches = lm.init_caches(b_local, cache_len)
    extra = {}
    if cfg.enc_layers:  # whisper's cross-attention context
        extra["enc_out"] = torch.empty(
            (b_local, min(cfg.enc_seq, cache_len), cfg.d_model),
            dtype=cfg.torch_dtype, device=device)

    def serve_step(tokens, caches_, extra_):
        return lm.decode_step(tokens, caches_, batch_ctx=extra_ or None)
    return StepBundle(serve_step, (local["tokens"], caches, extra),
                      "decode", lm)


def build_bundle(cfg: ModelConfig, mesh, shape_name: str,
                 remat: str = "dots", cost_mode: bool = False) -> StepBundle:
    seq, batch, kind = SHAPES[shape_name]
    if kind == "train":
        return build_train_bundle(cfg, mesh, seq, batch, remat, cost_mode)
    if kind == "prefill":
        return build_prefill_bundle(cfg, mesh, seq, batch, cost_mode)
    return build_decode_bundle(cfg, mesh, seq, batch, cost_mode)
