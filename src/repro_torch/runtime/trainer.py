"""Fault-tolerant training runtime (counterpart of
``repro/runtime/trainer.py``).

The loop of the reference, eager: each step runs :meth:`LM.loss`, its
``backward`` (the flash attention and MoE un-dispatch kernels through their
autograd Functions, whose backward is a kernel too), optional int8 gradient
compression with error feedback, and :class:`~repro_torch.optim.AdamW`
applied in place.  Kept from the reference:

* **checkpoint/restart** -- resume from the latest committed checkpoint,
  written in the reference's format and tree (``convert
  .train_state_to_reference``), so either package restores the other's;
* **watchdog** -- a step over ``step_deadline_s`` on the host clock (which
  waits for the step's work on the card) raises ``StragglerTimeout``;
* **failure injection** -- ``failure_schedule`` and the ``faults``
  injector's ``"step"`` site kill the loop at chosen steps;
* **async checkpointing** -- the leaves are copied to host memory at the
  save, and written (stacked into the reference's tree first) in the
  background while the next steps run;
* **the train-serve handoff** -- every step's embedding table is handed to
  the model's embedding executor (``update_tables``); it is updated in
  place, so the executor rebinds nothing and restacks nothing
  (``table_restacks`` stays 0).

Deliberate differences: the initial state is the module's own weights (the
port's ``LM`` holds its parameters, as ``DecodeServer`` takes none), so
``run`` takes no PRNG key; a restart that finds a checkpoint overwrites
them from it.  ``TrainerConfig.ckpt_dir`` has no default (the
reference's is ``/tmp/repro_ckpt``): a trainer resumes from whatever it
finds there, so two runs must not share one by accident.

**Over a mesh** (an ``LM(shard=ShardCtx(mesh))`` of any kind whose loss
runs over a mesh; one process a rank, multi-controller): each rank takes
its data block of the global batch (the batch specs), runs the loss over
the mesh and its backward (the model axis's collectives inside), sums
each KV copy's gradient over the ranks that hold it (the head plan's
copies: one all-reduce a leaf of its zero-filled KV columns, so the
copies step alike and stay bit-equal; a mamba layer's copied B | C
columns are summed in the layer, where they enter it), means every
gradient over the data axes (fp32, rounded once), and steps AdamW on its
slices (:class:`~repro_torch.optim.adamw.Shards`: the global clipping
norm, each copy counted once -- a partly copied leaf by the segments the
rank holds first --, ZeRO-1 where the opt specs shard a moment of a leaf
the LM does not split).  The LM's ``split_leaves`` place every leaf; the
param specs are the reference's names of the layout.  ``in_shardings``
is the port's counterpart of the reference's jit placements: the spec
triple ``(param specs, opt specs, batch specs)`` of
:func:`repro_torch.launch.sharding.train_specs`; param specs that disagree
with the LM's own layout raise.  Without it the moments follow the
parameters (no ZeRO-1) and the batch splits over the data axes where it
divides.  Checkpoints are sharded (every rank writes its blocks with their
global offsets; ``checkpoint.ckpt``) and restored onto the rank's slices.
Gradient compression over a mesh raises (ROADMAP.md, Queue 1 item 6f: a
rank's slice of a split leaf does not fall into the reference's 256-value
blocks of the global leaf).

:class:`TrainStep` is the step itself (the mesh plan, the state, the
loss, its gradients and the update), which :class:`Trainer` runs in its
loop and the dry run (``repro_torch.launch.steps``) builds on the meta
device, so the dry run counts the program users run.  The data axes may
be two (``pod`` and ``data``, as on the reference's multi-pod mesh): the
batch splits over both joined row-major, and the gradients are meaned and
the ZeRO-1 rows split over that one joint axis.

The supervisor (:func:`run_supervised`) is the single-process stand-in for
the cluster controller: it builds a fresh trainer and restarts the loop
after injected failures until the target step is reached.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional

import torch

from ..checkpoint import CheckpointManager
from ..checkpoint.ckpt import tree_map
from ..convert import train_state_from_reference, train_state_to_reference
from ..data.pipeline import SyntheticTokens
from ..optim import adamw
from ..optim.adamw import Shards
from ..optim.compress import compress_gradients, error_feedback_init
from .faults import InjectedFailure, StragglerTimeout  # noqa: F401


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None    # required: the trainer resumes from it
    keep: int = 3
    step_deadline_s: Optional[float] = None     # watchdog
    grad_compression: bool = False
    lr: float = 3e-4


class TrainStep:
    """One training step of ``lm`` on a global batch of ``global_batch``
    sequences of ``seq_len`` tokens: the mesh plan (:meth:`_plan_mesh`),
    the state (:meth:`init_state`), :meth:`loss_and_grads` and the update
    (``self(state, batch)``).  What :class:`Trainer` runs each step, and
    what the dry run counts."""

    def __init__(self, lm, global_batch: int, seq_len: int, *,
                 lr: float = 3e-4, grad_compression: bool = False,
                 in_shardings=None):
        self.lm = lm.requires_grad_(True)
        self.grad_compression = grad_compression
        self.opt = adamw(lr=lr)
        self.mesh = lm.shard.mesh
        self.shards = None          # optim.adamw.Shards on a mesh
        self._plan_mesh(in_shardings, global_batch, seq_len)

    def _plan_mesh(self, in_shardings, global_batch: int,
                   seq_len: int) -> None:
        """On a mesh: the specs of the parameters, moments and batch (from
        ``in_shardings``, checked, or the defaults), the AdamW shards, this
        rank's data block and the data axes the gradients are meaned
        over."""
        self._block, self._data = None, None
        self._copies: dict = {}
        self._loss_axes = ()
        if self.mesh is None:
            if in_shardings is not None:
                raise ValueError("in_shardings places a sharded train step: "
                                 "the LM has no mesh (LM(shard=ShardCtx("
                                 "mesh)))")
            return
        if self.grad_compression:
            raise NotImplementedError(
                "gradient compression over a mesh is not ported yet "
                "(ROADMAP.md, Queue 1 item 6f)")
        from ..core.shard_plan import model_axis, shard_count
        from ..launch import sharding as shd
        mesh, sh = self.mesh, self.lm.shard
        data_axes = tuple(a for a in sh.data_axes if a in mesh.mesh_dim_names)
        p_want, zero, b_specs = shd.train_specs(
            self.lm.cfg, mesh, global_batch, seq_len, data_axes)
        mu = dict(p_want)
        if in_shardings is not None:
            p_specs, opt_specs, b_specs = in_shardings
            wrong = sorted(k for k in set(p_want) | set(p_specs)
                           if p_specs.get(k) != p_want.get(k))
            if wrong:
                raise ValueError(
                    f"in_shardings' param specs disagree with the LM's "
                    f"layout at {wrong[:4]} (e.g. {wrong[0]}: "
                    f"{p_specs.get(wrong[0])} against "
                    f"{p_want.get(wrong[0])})")
            mu = dict(opt_specs.mu)
            bad = sorted(k for k in p_want if mu.get(k) not in
                         (p_want[k], zero.mu[k]) or
                         opt_specs.nu.get(k) != mu.get(k))
            if bad:
                raise ValueError(f"in_shardings' opt specs at {bad[:4]} are "
                                 f"neither the params' nor ZeRO-1's")
        # the LM's own blocks of each leaf it splits (the head plan's for
        # the attention heads); ZeRO-1 cuts only leaves it does not split
        blocks = self.lm.split_leaves
        mu = {k: p_want[k] if k in blocks else v for k, v in mu.items()}
        self.specs = {"params": p_want, "moments": mu}
        zero1 = frozenset(k for k in p_want if mu[k] != p_want[k])
        wide = tuple(a for a in data_axes if shard_count(mesh, a) > 1)
        dev = self.lm.device
        if wide:    # the data axes, joined row-major where there are two
            self._data = model_axis(mesh, wide[0] if len(wide) == 1
                                    else wide, dev)
        split = b_specs["tokens"][0]
        if split is not None and wide:
            b = global_batch // self._data.size
            lo = self._data.rank * b
            self._block = (lo, lo + b)
            self._loss_axes = data_axes
        tp = self.lm.tp
        me = 0 if tp is None else tp.rank
        self.shards = Shards(
            model=tp, split=frozenset(blocks), data=self._data, zero1=zero1,
            repeat=frozenset(k for k, b in blocks.items()
                             if not b.writes(me)),
            counted={k: (b.dim, tuple((at, at + hi - lo)
                                      for at, lo, hi, w, _ in b.local(me)
                                      if w))
                     for k, b in blocks.items()
                     if b.writes(me) and not all(
                         w for _, _, w in b.segments[me])})
        # the copies whose gradients the model leaves as partials (a KV
        # copy; a mamba layer's B | C is summed where it enters the layer)
        self._copies = {k: b for k, b in blocks.items()
                        if b.copies and not b.entered}
        from ..launch.sharding import axis_sizes, mesh_index
        self._sizes, self._index = axis_sizes(mesh), mesh_index(mesh)

    def init_state(self) -> dict:
        """``{"params", "opt", "ef"}``: the module's parameters (the live
        tensors, updated in place), AdamW's zero state (this rank's rows of
        a ZeRO-1 leaf), and the error-feedback residuals (None without
        compression)."""
        params = dict(self.lm.named_parameters())
        return {"params": params,
                "opt": self.opt.init(params, self.shards),
                "ef": (error_feedback_init(params)
                       if self.grad_compression else None)}

    def loss_and_grads(self, params: dict, batch: dict) -> tuple:
        """The loss (the mean over the global batch, on every rank) and
        every parameter's gradient (a parameter the loss does not reach gets
        zeros, as ``jax.grad`` gives); over a mesh the gradients of the
        rank's slices, a KV copy's summed over its holders
        (:meth:`_sum_copies`), meaned over the data axes in fp32 and
        rounded once."""
        for p in params.values():
            p.grad = None
        loss = self.lm.loss(batch["tokens"], batch["labels"],
                            batch.get("frontend_embeds"),
                            batch.get("enc_embeds"),
                            data_axes=self._loss_axes)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        for k, blk in self._copies.items():
            grads[k] = self._sum_copies(grads[k], blk)
        if self._block is not None:
            n = self._data.size
            grads = {k: (self._data.coll.all_reduce(g.float(), "add") / n)
                     .to(g.dtype) for k, g in grads.items()}
        return loss.detach(), grads

    def _sum_copies(self, g: torch.Tensor, blk) -> torch.Tensor:
        """A KV leaf's gradient summed over the ranks that hold each of its
        copies: this rank's partial placed at its columns of the zero-filled
        full width in fp32, one all-reduce over the model axis, the rank's
        columns taken back and rounded once (every rank of a group gets
        the same bits).  A KV leaf is one segment on a rank (none on a
        rank without query heads)."""
        tp = self.lm.tp
        segs = blk.segments[tp.rank]
        lo, hi = segs[0][:2] if segs else (0, 0)
        shape = list(g.shape)
        shape[blk.dim] = blk.size
        full = g.new_zeros(shape, dtype=torch.float32)
        full.narrow(blk.dim, lo, hi - lo).copy_(g)
        return tp.coll.all_reduce(full, "add").narrow(
            blk.dim, lo, hi - lo).to(g.dtype).contiguous()

    def __call__(self, state: dict, batch: dict) -> torch.Tensor:
        """One step: the loss, its gradients, compression, AdamW in place.
        Returns the loss (before the update), on the device."""
        params = state["params"]
        loss, grads = self.loss_and_grads(params, batch)
        if self.grad_compression:
            grads, state["ef"] = compress_gradients(grads, state["ef"])
        state["opt"] = self.opt.apply_(params, grads, state["opt"],
                                       self.shards)
        return loss

    def local_batch(self, host: dict) -> dict:
        """A global batch of host arrays as this rank's tensors on the
        model's device: its data block (the whole batch off a mesh), float
        leaves in the model's dtype."""
        dev = self.lm.device
        out = {}
        for k, v in host.items():
            if self._block is not None:
                v = v[self._block[0]:self._block[1]]
            t = torch.from_numpy(v).to(dev)
            out[k] = t.to(self.lm.cfg.torch_dtype) if t.is_floating_point() \
                else t
        return out


class Trainer(TrainStep):
    """The loop of :class:`TrainStep`s over ``data`` with checkpoints,
    the watchdog, failure injection and the train-serve handoff (module
    docstring)."""

    def __init__(self, lm, data: SyntheticTokens, tcfg: TrainerConfig,
                 in_shardings=None, faults=None):
        if tcfg.ckpt_dir is None:
            raise ValueError(
                "TrainerConfig.ckpt_dir is required: the trainer resumes "
                "from any checkpoint it finds there, so it takes no shared "
                "default")
        super().__init__(lm, data.cfg.global_batch, data.cfg.seq_len,
                         lr=tcfg.lr, grad_compression=tcfg.grad_compression,
                         in_shardings=in_shardings)
        self.data = data
        self.tcfg = tcfg
        # optional shared chaos injector (runtime.faults.FaultInjector):
        # fires the "step" site each iteration
        self.faults = faults
        self._rank = 0 if self.mesh is None else \
            int(torch.distributed.get_rank())
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep,
                                      rank=self._rank)
        self.emb_executor = None

    def _ckpt_shards(self):
        """The specs and place of this rank for a sharded checkpoint (None
        on one device)."""
        if self.mesh is None:
            return None
        return (self.specs["params"], self.specs["moments"], self._sizes,
                self._index)

    def _restore(self, state: dict) -> int:
        """Overwrite ``state`` in place from the latest checkpoint (this
        rank's blocks of it on a mesh); returns its step."""
        cfg = self.lm.cfg
        like = train_state_to_reference(tree_map(
            lambda t: torch.empty_like(t, device="meta"), state), cfg,
            shards=self._ckpt_shards())
        tree, step = self.ckpt.restore(
            like, shardings=like if self.mesh is not None else None)
        loaded = train_state_from_reference(tree, cfg, device="cpu")
        with torch.no_grad():
            for group in ("params", "ef"):
                if state[group] is None:
                    continue
                for k, t in state[group].items():
                    t.copy_(loaded[group][k])
            opt, lopt = state["opt"], loaded["opt"]
            opt.step.copy_(lopt.step)
            for k in opt.mu:
                opt.mu[k].copy_(lopt.mu[k])
                opt.nu[k].copy_(lopt.nu[k])
        return step

    def run(self, *, failure_schedule: Callable[[int], bool] = None,
            on_step=None) -> dict:
        tcfg = self.tcfg
        state = self.init_state()
        step0 = 0
        if self.ckpt.latest() is not None:
            step0 = self._restore(state) + 1
        if self.emb_executor is None:
            # the serving-handoff artifact: the embedding program compiled
            # for this (batch, seq), fed every step's table (the lookups
            # themselves run inside the model's forward)
            dc = self.data.cfg
            batch = dc.global_batch if self._block is None else \
                self._block[1] - self._block[0]
            self.emb_executor = self.lm.embedding_executor(batch,
                                                           dc.seq_len)

        losses = []
        for step in range(step0, tcfg.total_steps):
            if failure_schedule is not None and failure_schedule(step):
                raise InjectedFailure(f"injected failure at step {step}")
            if self.faults is not None:
                self.faults.fire("step", step=step)
            t0 = time.time()
            loss = float(self(state, self.local_batch(
                self.data.batch_at(step))))
            dt = time.time() - t0      # float() waited for the step's work
            if tcfg.step_deadline_s and dt > tcfg.step_deadline_s:
                raise StragglerTimeout(
                    f"step {step} took {dt:.1f}s > {tcfg.step_deadline_s}s")
            # train-serve handoff: the embed table was updated in place, so
            # the executor's alias unit keeps its binding (no restack)
            with torch.no_grad():
                self.emb_executor.update_tables(
                    self.lm.embedding_table_inputs())
            losses.append(loss)
            if on_step:
                on_step(step, loss)
            if (step + 1) % tcfg.ckpt_every == 0 or \
                    step + 1 == tcfg.total_steps:
                self.ckpt.save(step, state, transform=functools.partial(
                    train_state_to_reference, cfg=self.lm.cfg,
                    shards=self._ckpt_shards()))
        self.ckpt.wait()
        out = {"final_step": tcfg.total_steps - 1, "losses": losses,
               "state": state}
        from ..core.executor import executor_cache_stats
        from ..core.pipeline import compile_cache_stats
        ec = compile_cache_stats()
        ec["executor_cache"] = executor_cache_stats()
        ec["executor"] = dict(self.emb_executor.stats)
        out["embedding_compile"] = ec
        return out


def run_supervised(make_trainer: Callable[[], Trainer], *,
                   failure_schedule=None, max_restarts: int = 5) -> dict:
    """Cluster-controller stand-in: restart-from-checkpoint on failure.
    The failed trainer is dropped before the next is built, so a full-size
    model's state is never held twice."""
    restarts = 0
    fired: set = set()

    def sched(step):
        if failure_schedule and step in failure_schedule and \
                step not in fired:
            fired.add(step)
            return True
        return False

    while True:
        trainer = make_trainer()
        try:
            out = trainer.run(failure_schedule=sched)
            out["restarts"] = restarts
            return out
        except (InjectedFailure, StragglerTimeout):
            restarts += 1
            if restarts > max_restarts:
                raise
        trainer.ckpt.wait()
        del trainer
