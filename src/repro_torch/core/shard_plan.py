"""Vocab-sharded fused programs on ``torch.distributed`` -- the device half
of the sharded executor (counterpart of ``repro/core/shard_plan.py``).

At serving scale one device cannot hold the fused stacked tables, so the
steady-state executor shards them along the vocab (row) dimension over the
``model`` axis of a mesh, FlexEMR-style: the *indices* move to the data,
the data never moves to the compute.  Every layout and routing decision
lives in the compiled :class:`~repro_torch.core.access_plan.AccessPlan`;
this module realizes a plan on one rank of a process group.

The reference is single-controller: one host routes every shard's stream
and ``jit(shard_map(...))`` runs the bodies.  The port is SPMD over
processes: each rank runs one executor, routes the whole step on its host
(deterministic numpy, so the ranks agree without talking) and keeps its own
part, and the bodies below are plain functions of that rank's local table,
its operands and a :class:`Collectives` bound to the mesh axis's group:

* :func:`local_stack_table` builds rank r's ``(L·blk, E)`` local table
  (its stripe of every slot's cold tail, then the replicated hot slabs) on
  the tables' device, where the reference's ``shard_stack_tables`` places
  the global array;
* :func:`csr_host_body` / :func:`gather_host_body` (host exchange: the
  rank's routed bucket arrives as its operands) and
  :func:`csr_collective_body` / :func:`gather_collective_body` (collective
  exchange: the rank's row of the ``(S_src, S_dst, …)`` send lattice goes
  through ``all_to_all``): the local pool on the hand-written kernels
  (``backend="cuda"``) or stock ops (``"torch"``), then the pooled rows
  back -- all-reduced to every rank, or reduce-scattered so that rank r
  owns fused segments ``[r·seg_cap, (r+1)·seg_cap)`` -- with every
  locally-empty segment holding the (+)-identity and globally-empty ones
  fixed to 0 afterwards (the SLS convention).

The collective exchange rebuilds the received lattice into a canonical
sub-CSR with the port's stable transposition kernel
(``kernels.gather.transposed_lookups``: ``ember_transpose`` on the card),
where the reference runs ``argsort`` and ``searchsorted``: pad slots carry
the segment sentinel ``num_segments``, so they sort last and the first
``num_segments + 1`` offsets are the local CSR.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import gather as kgather, ops as kops, ref
from .access_plan import AccessPlan

_ADD_IDENT = ref.ADD_IDENTITY
_REDUCE_OPS = {"add": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def shard_count(mesh, axis="model") -> int:
    """Size of ``axis`` in ``mesh`` (1 when mesh is None or the axis is
    absent; a tuple of axes: the product of their sizes) -- the
    executor's single switch between the replicated and sharded paths."""
    if mesh is None:
        return 1
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    axes = axis if isinstance(axis, tuple) else (axis,)
    return int(np.prod([sizes.get(a, 1) for a in axes]))


# ---------------------------------------------------------------------------
# Layout realization: one rank's local table
# ---------------------------------------------------------------------------

def local_stack_table(parts: list, plan: AccessPlan, rank: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rank ``rank``'s ``(L·blk, E)`` local table of one fused unit per its
    AccessPlan: the rank's stripe of each slot's cold tail (ceil split;
    rows past the tail stay 0), then every slot's hot slab, replicated.

    ``parts`` are the slots' full source tables (tensors on one device);
    rows are gathered on that device (a slot without hot rows copies a
    contiguous slice), never through the host.  A slot without hot rows
    may instead be given only this rank's stripe of its rows (a
    vocab-sharded LM's ``embed``: :meth:`repro_torch.models.lm.LM.
    embedding_table_inputs`), which is then copied as it is.  ``out``, if
    given, is rewritten in place (``update_tables``, slab swaps).  Row
    block r of the plan's numpy oracle ``stack_np`` is the same array."""
    blk, emb = plan.blk, parts[0].shape[1]
    rows = plan.local_rows * blk
    dev, dt = parts[0].device, parts[0].dtype
    if out is None:
        out = torch.zeros((rows, emb), dtype=dt, device=dev)
    elif out.shape != (rows, emb) or out.dtype != dt:
        raise ValueError(f"local table {tuple(out.shape)} {out.dtype} is not "
                         f"the plan's ({rows}, {emb}) {dt}")
    for slot, p in zip(plan.slots, parts):
        lo = rank * slot.cap
        hi = min((rank + 1) * slot.cap, slot.cold_rows)
        n = max(hi - lo, 0)
        own = not slot.hot_rows and p.shape[0] == n * blk
        if p.shape[0] != slot.rows * blk and not own:
            raise ValueError(f"slot table has {p.shape[0]} rows, expected "
                             f"{slot.rows * blk}"
                             + ("" if slot.hot_rows else
                                f" (or this rank's {n * blk})"))
        dst = slot.cold_base * blk
        if n and own:                     # the rank's stripe, as given
            out[dst:dst + n * blk].copy_(p)
        elif n and not slot.hot_rows:     # cold ids are the rows themselves
            out[dst:dst + n * blk].copy_(p[lo * blk:hi * blk])
        elif n:
            _take(p, plan.phys_rows(slot.cold_ids[lo:hi]),
                  out[dst:dst + n * blk])
        out[dst + n * blk:dst + slot.cap * blk].zero_()
        if slot.hot_rows:
            dst = slot.hot_base * blk
            _take(p, plan.phys_rows(slot.hot_ids),
                  out[dst:dst + slot.hot_rows * blk])
    return out


def _take(src: torch.Tensor, rows: np.ndarray, dst: torch.Tensor) -> None:
    idx = torch.from_numpy(np.ascontiguousarray(rows, np.int64)).to(
        src.device)
    torch.index_select(src, 0, idx, out=dst)


def compute_spill(pair_counts: np.ndarray, max_fraction: float,
                  overload_ratio: float) -> dict:
    """Hot-spill table from one step's ``(S_src, S_dst)`` pair counts.

    The lattice diagonal is the hot (source-served) traffic; when a source
    shard's diagonal exceeds ``overload_ratio ×`` the mean diagonal load,
    a bounded ``max_fraction`` of its hot lookups should spill to its
    least-loaded peer (by total routed column load).  Returns the
    ``{src: (dst, fraction)}`` mapping
    :meth:`~repro_torch.core.access_plan.AccessPlan.route_csr_collective`
    applies on the *next* step — the feedback edge of the executor's
    spill-aware lattice fill."""
    pair = np.asarray(pair_counts, np.int64)
    s = pair.shape[0]
    if s < 2 or max_fraction <= 0.0:
        return {}
    diag = np.diag(pair).astype(np.float64)
    mean = diag.mean()
    if mean <= 0:
        return {}
    load = pair.sum(axis=0).astype(np.float64)   # per-dst routed work
    spill: dict = {}
    for src in np.flatnonzero(diag > overload_ratio * mean):
        peers = np.array([d for d in range(s) if d != src])
        dst = int(peers[np.argmin(load[peers])])
        spill[int(src)] = (dst, float(max_fraction))
    return spill


# ---------------------------------------------------------------------------
# The collective helper
# ---------------------------------------------------------------------------

class Collectives:
    """The one route of every collective the sharded executor makes, on
    ``group`` for tensors on ``device``.

    Under a gloo group with CUDA tensors every collective goes through
    pinned host buffers: device to host, the collective on the host, host
    to device (gloo's own CUDA support differs by collective and version;
    the route depends on the group's backend alone, never on an error).
    Under any other pairing (NCCL on the card, gloo on the CPU) the
    collective takes the tensors directly.  ``stats`` (the executor's) gets
    the calls, the staged bytes (both directions), the host milliseconds
    the collectives took and the bytes of their results: ``collectives``,
    ``staged_bytes``, ``collective_ms``, ``result_bytes`` -- the
    reference's roofline convention (``collective_bytes_from_hlo``: an
    all-reduce counts its payload, an all-gather the gathered result), so
    a dry run's count (:class:`DryCollectives`) and a live one compare."""

    def __init__(self, group, device: torch.device, stats: dict):
        self.group = group
        self.device = torch.device(device)
        self.size = dist.get_world_size(group)
        self.staged = (self.device.type == "cuda" and
                       dist.get_backend(group) == "gloo")
        self.stats = stats
        stats.setdefault("result_bytes", 0)
        self._host: dict = {}             # (role, shape, dtype) -> pinned

    def _count(self, out: torch.Tensor, t0: float) -> None:
        self.stats["collective_ms"] += (time.perf_counter() - t0) * 1e3
        self.stats["collectives"] += 1
        self.stats["result_bytes"] += out.numel() * out.element_size()

    def _pinned(self, role: str, shape, dtype) -> torch.Tensor:
        """The reused pinned buffer of ``role`` at ``shape`` and ``dtype``:
        made outside inference mode, so a buffer first made under
        ``torch.inference_mode`` (serving) takes the copies of a later
        training step."""
        key = (role, tuple(shape), dtype)
        buf = self._host.get(key)
        if buf is None:
            with torch.inference_mode(False):
                buf = self._host[key] = torch.empty(shape, dtype=dtype,
                                                    pin_memory=True)
        return buf

    def _run(self, call, x: torch.Tensor, out_shape) -> torch.Tensor:
        """``call(out, x)`` into a fresh tensor of ``out_shape``, staged
        through the host where the group's backend needs it."""
        x = x.contiguous()
        if not self.staged:
            out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
            t0 = time.perf_counter()
            call(out, x)
            self._count(out, t0)
            return out
        # the stream must drain before the host reads the input; a
        # non-blocking copy into a pinned buffer is then safe to reuse, as
        # the next staged call drains the stream again before writing it
        torch.cuda.current_stream(self.device).synchronize()
        t0 = time.perf_counter()
        h_in = self._pinned("in", x.shape, x.dtype)
        h_out = self._pinned("out", out_shape, x.dtype)
        h_in.copy_(x)
        call(h_out, h_in)
        out = torch.empty(out_shape, dtype=x.dtype, device=self.device)
        out.copy_(h_out, non_blocking=True)
        self._count(out, t0)
        self.stats["staged_bytes"] += (x.numel() + out.numel()) * \
            x.element_size()
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (S, …): block j goes to rank j; the result's block j came
        from rank j."""
        return self._run(lambda o, i: dist.all_to_all_single(
            o, i, group=self.group), x, x.shape)

    def all_reduce(self, x: torch.Tensor, add_op: str) -> torch.Tensor:
        def call(o, i):
            o.copy_(i)
            dist.all_reduce(o, op=_REDUCE_OPS[add_op], group=self.group)
        return self._run(call, x, x.shape)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks of ``x`` (S·c, …); this rank keeps block
        ``rank`` (c, …)."""
        rs = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        return self._run(lambda o, i: rs(o, i, group=self.group), x,
                         (x.shape[0] // self.size,) + tuple(x.shape[1:]))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (c, …) of every rank, rank-major: (S·c, …)."""
        ag = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        return self._run(lambda o, i: ag(o, i, group=self.group), x,
                         (x.shape[0] * self.size,) + tuple(x.shape[1:]))


class DryMesh:
    """An abstract mesh for the dry run (the counterpart of the reference's
    fake-device production mesh): axis sizes ``{axis: size}`` in order
    and the place of the one rank this process stands for (``rank``,
    row-major over the axes), with no process group and no device.  It
    answers what the port reads of a ``DeviceMesh`` -- ``mesh_dim_names``,
    ``shape``, ``device_type`` ("meta"), ``get_local_rank`` -- and an LM
    built over it (``LM(cfg, device="meta", shard=ShardCtx(mesh))``) holds
    that rank's slices on the meta device, its collectives
    :class:`DryCollectives`."""

    def __init__(self, sizes: dict, rank: int = 0):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(int(n) for n in sizes.values())
        n = int(np.prod(self.shape))
        if not 0 <= rank < n:
            raise ValueError(f"rank {rank} is not on a mesh of {n}")
        self.rank = rank
        self.device_type = "meta"
        self._coord = dict(zip(self.mesh_dim_names,
                               np.unravel_index(rank, self.shape)))

    def size(self) -> int:
        return int(np.prod(self.shape))

    def get_local_rank(self, axis) -> int:
        """This rank's coordinate along ``axis``, or along a tuple of axes
        joined row-major (as a spec's joint axes are)."""
        axes = axis if isinstance(axis, tuple) else (axis,)
        sizes = dict(zip(self.mesh_dim_names, self.shape))
        coord = 0
        for a in axes:
            coord = coord * sizes[a] + int(self._coord[a])
        return coord


class DryCollectives(Collectives):
    """The collectives of a :class:`DryMesh` axis: every call makes its
    result's shape on the meta device and counts it in ``stats`` as
    :class:`Collectives` counts a live one (``result_bytes`` the
    reference's convention; nothing is staged and no time passes)."""

    def __init__(self, size: int, stats: dict):
        self.group, self.device, self.size = None, torch.device("meta"), size
        self.staged = False
        self.stats = stats
        stats.setdefault("result_bytes", 0)

    def _run(self, call, x: torch.Tensor, out_shape) -> torch.Tensor:
        out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
        self._count(out, time.perf_counter())
        return out


def _tracked(x: torch.Tensor) -> bool:
    """Whether autograd records an op on ``x`` (grad mode on, ``x`` needs
    a gradient): only then do the axis ops go through their Functions, so
    a forward under ``no_grad`` / ``inference_mode`` runs the collectives
    alone, with the same bits."""
    return torch.is_grad_enabled() and x.requires_grad


class _AxisSum(torch.autograd.Function):
    """Forward: the all-reduce over the axis.  Backward: the identity --
    the output is replicated and what runs downstream of it is too, so its
    cotangent is already the same on every rank."""

    @staticmethod
    def forward(ctx, axis, x):
        return axis.coll.all_reduce(x, "add")

    @staticmethod
    def backward(ctx, g):
        return None, g


class _AxisEnter(torch.autograd.Function):
    """Megatron's *f* for one tensor or several at once: forward the
    identity, backward every cotangent summed over the axis in ONE fp32
    all-reduce of them flattened together (:meth:`ModelAxis.sum_grad`),
    each rounded to its tensor's dtype once.  A replicated tensor entering
    column-parallel products gets only this rank's partial gradient from
    them; so does a leaf every rank holds whole but uses only in part (an
    MoE layer's router and shared experts on the seq-split path, MLA's
    ``w_dkv`` and ``w_kr``)."""

    @staticmethod
    def forward(ctx, axis, *xs):
        ctx.axis = axis
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = ctx.axis.sum_grad(torch.cat([g.reshape(-1).float()
                                            for g in gs]), torch.float32)
        out, at = [], 0
        for g in gs:
            out.append(flat[at:at + g.numel()].view_as(g).to(g.dtype))
            at += g.numel()
        return (None, *out)


class _AxisAllToAll(torch.autograd.Function):
    """Forward: the tiled all-to-all (block j to rank j).  Backward: the
    same all-to-all of the cotangent -- it is its own transpose, since
    block j of the result came from rank j, so its cotangent goes back to
    rank j, into the block that rank sent."""

    @staticmethod
    def forward(ctx, axis, x):
        ctx.axis = axis
        return axis.coll.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.axis.coll.all_to_all(g)


class _AxisMean(torch.autograd.Function):
    """Forward: the mean of a () tensor over the axis (the reference's
    ``pmean``) where each rank's value is its own share (the seq-split MoE
    path's aux, of the rank's tokens).  Backward: ``g / size`` to the
    rank's own value; what made it is summed over the axis by an entry."""

    @staticmethod
    def forward(ctx, axis, x):
        ctx.size = axis.size
        return axis.coll.all_reduce(x.reshape(1), "add")[0] / axis.size

    @staticmethod
    def backward(ctx, g):
        return None, g / ctx.size


class _AxisGather(torch.autograd.Function):
    """Forward: every rank's block joined along ``dim``.  Backward: this
    rank's block of the cotangent (the joined output is replicated, so its
    cotangent is the same on every rank)."""

    @staticmethod
    def forward(ctx, axis, x, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return axis.coll.all_gather(x.movedim(dim, 0)).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return (None, g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n),
                None)


class _AxisScatter(torch.autograd.Function):
    """Forward: the reduce-scatter along ``dim`` (the sum over the axis,
    this rank keeping its block).  Backward: every rank's block of the
    cotangent joined -- each rank's partial reached every block of the
    sum."""

    @staticmethod
    def forward(ctx, axis, x, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.coll.reduce_scatter(x.movedim(dim, 0)).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return (None, ctx.axis.coll.all_gather(
            g.movedim(ctx.dim, 0).contiguous()).movedim(0, ctx.dim), None)


def _joint_group(mesh, axes: tuple):
    """The process group of a live ``DeviceMesh``'s ``axes`` joined
    row-major, and this rank's place in it.  Every rank of the mesh makes
    every such group (``new_subgroups_by_enumeration`` is collective over
    the world), so every rank calls this at the same point of its
    program.  The joined order must be the group's own (ascending global
    ranks, as a mesh laid out row-major gives), since an all-gather over
    the group stacks its blocks in that order."""
    names = list(mesh.mesh_dim_names)
    rest = [names.index(a) for a in names if a not in axes]
    perm = rest + [names.index(a) for a in axes]
    blocks = mesh.mesh.permute(perm).reshape(-1, shard_count(mesh, axes))
    ranks = [[int(r) for r in row] for row in blocks]
    if any(row != sorted(row) for row in ranks):
        raise ValueError(f"the mesh's {axes} do not join in rank order "
                         f"({ranks[0]})")
    group, _ = dist.new_subgroups_by_enumeration(ranks)
    me = dist.get_rank()
    (row,) = [row for row in ranks if me in row]
    return group, row.index(me)


class ModelAxis:
    """One rank's place on a mesh axis that a model is split over (tensor
    and expert parallelism) or that its batch is split over (the data
    axis of training): ``size``, ``rank`` and the axis group's
    :class:`Collectives`, whose ``stats`` (``collectives``,
    ``staged_bytes``, ``collective_ms``, ``result_bytes``) count every
    collective the model makes.  :func:`model_axis` memoizes one per
    (mesh, axis, device).  The axis may be a tuple of axes joined
    row-major (the data axes ``("pod", "data")`` a batch splits over; on
    a live mesh their group is made by :func:`_joint_group`).  On a
    :class:`DryMesh` the axis is counted, not run (:class:`DryCollectives`).

    :meth:`sum`, :meth:`enter` / :meth:`enter_all`, :meth:`gather`,
    :meth:`scatter`, :meth:`all_to_all` and :meth:`mean` are
    differentiable where autograd records them (model-parallel and
    expert-parallel training), each backward through the same
    :class:`Collectives`, so it runs alike staged or not and a dry mesh
    counts it: a sum's backward is the identity, an entry's the
    all-reduce of the cotangent in fp32, a gather's the rank's block, a
    scatter's the all-gather, an all-to-all's the same all-to-all, a
    mean's ``g / size``."""

    def __init__(self, mesh, axis, device):
        self.mesh, self.axis = mesh, axis
        self.size = shard_count(mesh, axis)
        self.stats = {"collectives": 0, "staged_bytes": 0,
                      "collective_ms": 0.0, "result_bytes": 0}
        if isinstance(mesh, DryMesh):
            self.rank = mesh.get_local_rank(axis)
            self.coll = DryCollectives(self.size, self.stats)
        elif isinstance(axis, tuple):
            group, self.rank = _joint_group(mesh, axis)
            self.coll = Collectives(group, device, self.stats)
        else:
            self.rank = mesh.get_local_rank(axis)
            self.coll = Collectives(mesh.get_group(axis), device, self.stats)

    @property
    def staged(self) -> bool:
        """Whether the collectives go through host memory (gloo on the
        card), which a CUDA graph cannot capture."""
        return self.coll.staged

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the axis, on every rank (backward: the
        identity)."""
        if _tracked(x):
            return _AxisSum.apply(self, x)
        return self.coll.all_reduce(x, "add")

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself; its gradient is summed over the axis (fp32
        partials, rounded to x's dtype once).  Put once where a replicated
        tensor enters this rank's column-parallel products."""
        return self.enter_all((x,))[0]

    def enter_all(self, xs) -> tuple:
        """:meth:`enter` for the tensors ``xs`` at once: their gradients
        summed over the axis in one fp32 all-reduce (the tensors
        themselves where autograd records none of them)."""
        xs = tuple(xs)
        if any(_tracked(x) for x in xs):
            return _AxisEnter.apply(self, *xs)
        return xs

    def sum_grad(self, g32: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """An entry's backward: this rank's fp32 partial gradient summed
        over the axis in fp32, rounded to ``dtype`` once."""
        return self.coll.all_reduce(g32, "add").to(dtype)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of a () tensor over the axis (the reference's
        ``pmean``); backward ``g / size`` (:class:`_AxisMean`)."""
        if _tracked(x):
            return _AxisMean.apply(self, x)
        return self.coll.all_reduce(x.reshape(1), "add")[0] / self.size

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``x`` over the axis (no gradient)."""
        return self.coll.all_reduce(x, "max")

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` joined along ``dim``, in rank order (backward:
        the rank's block)."""
        if _tracked(x):
            return _AxisGather.apply(self, x, dim)
        y = self.coll.all_gather(x.movedim(dim, 0))
        return y.movedim(0, dim)

    def scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum of ``x`` over the axis, this rank keeping block ``rank``
        of ``dim`` (a reduce-scatter; backward: the all-gather of the
        cotangent)."""
        if _tracked(x):
            return _AxisScatter.apply(self, x, dim)
        y = self.coll.reduce_scatter(x.movedim(dim, 0))
        return y.movedim(0, dim)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (size, ...): block j to rank j; block j of the result came
        from rank j (backward: the same all-to-all of the cotangent)."""
        if _tracked(x):
            return _AxisAllToAll.apply(self, x)
        return self.coll.all_to_all(x)


class _DataMean(torch.autograd.Function):
    """Forward: the mean over each data axis in turn (the reference's
    ``pmean``).  Backward: the identity -- data-parallel training takes
    each rank's gradient of its own tokens' loss and means the gradients
    over the data axes (``runtime.trainer``), which is the gradient of
    the global mean."""

    @staticmethod
    def forward(ctx, x, axes):
        for ax in axes:
            x = ax.mean(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def data_mean(x: torch.Tensor, axes: list) -> torch.Tensor:
    """The mean of a () tensor over the data ``axes`` (a list of
    :class:`ModelAxis`; ``x`` itself for none), differentiable as
    :class:`_DataMean` says."""
    if not axes:
        return x
    if _tracked(x):
        return _DataMean.apply(x, list(axes))
    return _DataMean.forward(None, x, axes)


_MODEL_AXES: dict = {}


def model_axis(mesh, axis, device) -> ModelAxis:
    """The memoized :class:`ModelAxis` of ``mesh``'s ``axis`` on
    ``device`` (one per process: its stats gather every collective of
    the model's layers)."""
    dev = torch.device(device)
    key = (id(mesh), axis, str(dev))
    hit = _MODEL_AXES.get(key)
    if hit is None or hit.mesh is not mesh:
        hit = _MODEL_AXES[key] = ModelAxis(mesh, axis, dev)
    return hit


def axes_of(mesh) -> list:
    """The :class:`ModelAxis` objects made so far on ``mesh`` (every axis
    a model or its training step split over): their ``stats`` hold every
    collective made on the mesh in this process."""
    return [ax for ax in _MODEL_AXES.values() if ax.mesh is mesh]


# ---------------------------------------------------------------------------
# Pooled rows back
# ---------------------------------------------------------------------------

def _reduce_scatter(x: torch.Tensor, coll: Collectives, add_op: str,
                    shards: int, seg_cap: int) -> torch.Tensor:
    """(+)-reduce-scatter of the partial pools along dim 0: pad the
    segment dim to the ``shards·seg_cap`` grid with the (+)-identity and
    leave this rank holding the combined rows of its own contiguous
    segment slice (rows past the true segment count are padding and never
    read).  Add reduce-scatters; max and min take the ``all_to_all``
    transpose (each rank collects every peer's partials for its slice)."""
    pad = shards * seg_cap - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]),
                                     _ADD_IDENT[add_op])])
    if add_op == "add":
        return coll.reduce_scatter(x)
    r = coll.all_to_all(x.reshape((shards, seg_cap) + tuple(x.shape[1:])))
    return r.amax(dim=0) if add_op == "max" else r.amin(dim=0)


def _finish_csr(out: torch.Tensor, counts: torch.Tensor, *,
                coll: Collectives, add_op: str, replicate: bool, shards: int,
                seg_cap: int) -> torch.Tensor:
    """Cross-shard combine + SLS zero-fix of one CSR unit's partial pools.
    ``counts`` are this rank's per-segment lookup counts (locally-empty
    segments hold the (+)-identity in ``out``); globally-empty segments are
    fixed to 0 after the merge from the summed counts, reduce-scattered
    beside the rows when outputs are owned."""
    if replicate:
        merged = coll.all_reduce(out, add_op)
        if add_op == "add":
            return merged
        total = coll.all_reduce(counts, "add")
        return torch.where((total > 0)[:, None], merged, 0.0).to(out.dtype)
    merged = _reduce_scatter(out, coll, add_op, shards, seg_cap)
    if add_op == "add":
        return merged
    pad = shards * seg_cap - counts.shape[0]
    if pad:
        counts = torch.cat([counts, counts.new_zeros(pad)])
    total = coll.reduce_scatter(counts)
    return torch.where((total > 0)[:, None], merged, 0.0).to(out.dtype)


# ---------------------------------------------------------------------------
# The local pool and the four bodies
# ---------------------------------------------------------------------------

def _local_pool_csr(table, roff, ptrs, idxs, vals, *, backend: str,
                    add_op: str, mul_op: str, nseg: int) -> tuple:
    """One rank's partial pool over its local sub-CSR, locally-empty
    segments holding the (+)-identity (merge-ready): ``(out, counts)``,
    the counts feeding the globally-empty zero-fix.  ``backend="cuda"``
    runs ``ember_sls`` (its plain version on CPU tensors), ``"torch"`` the
    stock-op pool :func:`repro_torch.kernels.ref.sls_local`."""
    counts = ptrs[1:] - ptrs[:-1]
    if backend == "cuda":
        out = kops.sls(table, ptrs, idxs, vals, num_segments=nseg,
                       add_op=add_op, mul_op=mul_op, seg_base=roff)
        if add_op != "add":
            # the kernel zeroed locally-empty segments (SLS convention);
            # restore the (+)-identity before merging across ranks
            out = torch.where((counts > 0)[:, None], out,
                              _ADD_IDENT[add_op]).to(out.dtype)
    else:
        out = ref.sls_local(table, ptrs, idxs, vals, roff,
                            num_segments=nseg, add_op=add_op, mul_op=mul_op)
    return out, counts


def csr_host_body(table, roff, ptrs, idxs, vals, *, coll: Collectives,
                  backend: str, add_op: str, mul_op: str, nseg: int,
                  replicate: bool, shards: int, seg_cap: int):
    """One fused CSR unit under the *host* exchange: this rank's routed
    bucket (``ptrs`` (nseg + 1,), ``idxs`` / ``vals`` padded to the
    bucket's capacity, indices fully rebased so ``roff`` is all zero), the
    local pool, then the pooled rows back."""
    out, counts = _local_pool_csr(table, roff, ptrs, idxs, vals,
                                  backend=backend, add_op=add_op,
                                  mul_op=mul_op, nseg=nseg)
    return _finish_csr(out, counts, coll=coll, add_op=add_op,
                       replicate=replicate, shards=shards, seg_cap=seg_cap)


def csr_collective_body(table, roff, ints, vals, *, coll: Collectives,
                        backend: str, add_op: str, mul_op: str, nseg: int,
                        replicate: bool, shards: int, seg_cap: int):
    """One fused CSR unit under the *collective* exchange: ``ints`` is this
    rank's row of the send lattice, ``(S_dst, 2, cap)`` (segment id, local
    index) pairs (``vals`` its ``(S_dst, cap)`` twin or None); the
    ``all_to_all`` makes dim 0 *received-from*.  The received streams
    rebuild a canonical local sub-CSR (``cuda``: the stable transposition
    by segment, then the kernel runs exactly as on the host exchange) or
    feed the segment reduction directly (``torch``), and the pooled rows
    combine."""
    recv = coll.all_to_all(ints)
    segs = recv[:, 0, :].contiguous().view(-1)
    idxs = recv[:, 1, :].contiguous().view(-1)
    if vals is not None:
        vals = coll.all_to_all(vals).reshape(-1)
    if backend == "cuda":
        order, ptrs = kgather.transposed_lookups(segs, None, nseg + 1)
        out, counts = _local_pool_csr(
            table, roff, ptrs[:nseg + 1], idxs.index_select(0, order),
            None if vals is None else vals.index_select(0, order),
            backend=backend, add_op=add_op, mul_op=mul_op, nseg=nseg)
    else:
        out, counts = ref.segment_pool(table, segs, idxs, vals,
                                       num_segments=nseg, add_op=add_op,
                                       mul_op=mul_op)
    return _finish_csr(out, counts, coll=coll, add_op=add_op,
                       replicate=replicate, shards=shards, seg_cap=seg_cap)


def _local_block_gather(table, idxs, blk: int, backend: str, roff=None):
    if backend == "cuda":
        return kops.block_gather(table, idxs, block_rows=blk, roff=roff)
    i = idxs.to(torch.int64)
    if roff is not None:
        i = i + roff.to(torch.int64)
    r = (i[:, None] * blk + torch.arange(blk, device=i.device)[None, :])
    return torch.index_select(table, 0, r.reshape(-1)).reshape(
        idxs.shape[0], blk, table.shape[-1])


def gather_host_body(table, roff, idxs, mask, *, coll: Collectives,
                     backend: str, blk: int, replicate: bool, shards: int,
                     seg_cap: int):
    """One fused gather unit under the host exchange: this rank's (B,)
    local block ids with the segments it does not own masked out, the
    local block gather, then the rows back (exactly one rank owns each
    segment, so the sum is the owner's rows)."""
    rows = _local_block_gather(table, idxs, blk, backend, roff)
    rows = rows * mask[:, None, None].to(rows.dtype)
    if replicate:
        return coll.all_reduce(rows, "add")
    return _reduce_scatter(rows, coll, "add", shards, seg_cap)


def gather_collective_body(table, ints, *, coll: Collectives, backend: str,
                           blk: int, nseg: int, replicate: bool,
                           shards: int, seg_cap: int):
    """Collective-exchange gather: ``all_to_all`` this rank's row of the
    (segment, block id) send lattice, gather the received local blocks,
    copy each to its segment (pad slots land on a scratch row past the
    segments; every segment has one owner), and sum-combine."""
    recv = coll.all_to_all(ints)
    segs = recv[:, 0, :].contiguous().view(-1)
    idxs = recv[:, 1, :].contiguous().view(-1)
    rows = _local_block_gather(table, idxs, blk, backend)
    out = rows.new_zeros((nseg + 1,) + tuple(rows.shape[1:]))
    out.index_copy_(0, segs.to(torch.int64), rows)
    out = out[:nseg]
    if replicate:
        return coll.all_reduce(out, "add")
    return _reduce_scatter(out, coll, "add", shards, seg_cap)


def owned_range(num_rows: int, offset: int, rank: int,
                seg_cap: int) -> tuple:
    """The rows ``[lo, hi)`` of a member op (fused rows ``[offset, offset +
    num_rows)``) that rank ``rank`` owns under reduce-scattered outputs
    (fused segments ``[rank·seg_cap, (rank+1)·seg_cap)``), in the op's own
    row numbering; ``lo == hi`` where it owns none."""
    lo = min(max(rank * seg_cap - offset, 0), num_rows)
    hi = min(max((rank + 1) * seg_cap - offset, 0), num_rows)
    return lo, max(lo, hi)


def all_gather_rows(coll: Collectives, piece: torch.Tensor, sizes: list,
                    width: int) -> torch.Tensor:
    """Concatenate every rank's ``piece`` (rank r's has ``sizes[r]`` rows,
    at most ``width``) in rank order, through one ``all_gather`` of the
    pieces padded to ``width`` rows."""
    pad = width - piece.shape[0]
    if pad:
        piece = torch.cat([piece, piece.new_zeros((pad,) +
                                                  tuple(piece.shape[1:]))])
    allp = coll.all_gather(piece)
    return torch.cat([allp[r * width:r * width + n]
                      for r, n in enumerate(sizes)])


__all__ = ["shard_count", "local_stack_table",
           "compute_spill", "Collectives", "ModelAxis", "model_axis",
           "data_mean",
           "csr_host_body",
           "csr_collective_body", "gather_host_body",
           "gather_collective_body", "owned_range", "all_gather_rows"]
