"""Sharding rules: params, KV caches, batches (counterpart of
``repro/launch/sharding.py``).

Conventions, as in the reference:
  * embedding / unembedding tables: vocab -> ``model``
  * attention projections: heads (fused head·dim columns) -> ``model``
  * MLP: hidden -> ``model`` (column then row parallel)
  * MoE: experts -> ``model`` (EP == TP axis)
  * SSM/xLSTM inner dims -> ``model``
  * batch dims -> (``pod``, ``data``)
  * optimizer moments: the params' spec, plus ZeRO-1 sharding of
    replicated leaves over the data axes (:func:`zero1_specs`)

A spec is a tuple with one entry per dim: an axis name, a tuple of axis
names (one dim split over several axes jointly) or None, as the reference's
``PartitionSpec`` is.  Parameters are keyed by the port's ``state_dict``
names (``blocks.<i>.attn.wq``, ``blocks.<i>.moe.wi_gate``, ``shared.mlp.wo``,
...); the port's layers are not stacked, so the reference's leading None of
a ``scan`` leaf has no counterpart.  Caches are the port's list of
per-layer dicts, the KV leaves head-major (B, Hkv, S, hd).

A mesh here is a :class:`torch.distributed.device_mesh.DeviceMesh` (its
``mesh_dim_names`` and ``shape``) or a plain ``{axis: size}`` dict, which
is all the spec functions read.  :func:`local_shard` takes a rank's slice
of a full tensor by its spec: the port is multi-controller, each rank holds
its own slices, and splits are even (``padded_vocab`` divides by any model
axis up to 256).

:func:`train_specs` is the spec part of the reference's
``build_train_bundle`` (``launch/steps.py``): the ``(param specs, opt
specs, batch specs)`` triple a sharded ``Trainer`` takes as
``in_shardings``.

**What a model-axis rank holds** (:func:`leaf_blocks`, the one source of
truth for the LM, the weight converter, sharded checkpoints, the trainer,
AdamW and the dry run).  The spec tables above stay the reference's, but
the attention heads are placed by :func:`head_plan` (Megatron's rule for
few KV heads) instead of an even split of the fused head·dim columns: the
flash kernel needs whole heads, where the reference lets GSPMD compute
partial scores across ranks.  With at least as many KV heads as ranks the
KV groups split into contiguous blocks (``np.array_split``: earlier ranks
take the larger ones; exactly the even split where the axis divides the
KV heads), each rank taking its groups' query heads.  With fewer, each
KV group spans a contiguous run of ranks, and every rank of the run holds
a copy of the group's ``wk`` / ``wv`` columns and a contiguous share of
its query heads; a rank whose share is empty holds no attention columns at
all.  ``wo``'s rows follow the query heads.  An MLA layer's query heads
(``wq``, ``w_uk``, ``w_uv``, ``wo``) follow the plan with one KV group a
head; its ``w_dkv`` and ``w_kr`` -- and so its latent cache -- are whole on
every rank, and so are an MoE layer's shared experts (``moe.shared.*``),
which :func:`repro_torch.models.moe.moe_ffn` runs replicated.  zamba2's
shared attention set (``shared.attn.*``) follows the head plan like any
attention, its ``shared.mlp.*`` the spec.  A mamba layer is split by SSM
head (:func:`ssm_plan`: whole heads, contiguous, ``np.array_split``; a
rank may hold none): its ``w_in`` columns ``x | z | B | C | dt`` are not
one block on a rank but four segments -- the rank's x, its z, the B | C
block that every rank copies (its one group of B and C serves every head)
and its dt -- joined in that order, so a rank's in-projection keeps the
reference's layout at its own widths; ``conv_w``'s columns and ``w_out``'s
rows follow the rank's x, ``A_log`` / ``D`` / ``dt_bias`` its heads, and
``norm_z`` (read nowhere) is whole.  The reference replicates ``conv_w``,
``A_log``, ``D`` and ``dt_bias`` and lets GSPMD cut ``w_in`` evenly across
the ``x | z | B | C | dt`` boundaries; the head split computes the same
function with no collective of its own.  Every other leaf splits evenly
by its spec.  A leaf's placement is a :class:`LeafBlocks`: per rank a list
of segments, each with the rank that writes and counts it (a copy's first
holder), so a leaf may be partly the rank's own and partly a copy.

Not ported: ``to_shardings``, ``table_row_sharding``,
``leading_axis_sharding`` and ``replicated_sharding`` build
``NamedSharding`` placements of global arrays, which have nothing to stand
for when each process holds only its own shard.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

COL = {"wq", "wk", "wv", "wi_gate", "wi_up", "w_in", "w_gate", "w_if"}
ROW = {"wo", "w_out"}
REPL = {"router", "A_log", "D", "dt_bias", "b_i", "b_f", "b", "conv_w",
        "norm1", "norm2", "norm_x", "norm_z", "final_norm", "enc_norm",
        "frontend_proj", "w_kr", "r"}


def axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` or of a dict mesh."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _size(sizes: dict, ax) -> int:
    axes = ax if isinstance(ax, tuple) else (ax,)
    return int(np.prod([sizes[a] for a in axes]))


def param_spec(name: str, ndim: int) -> tuple:
    """The spec of parameter ``name`` (a ``state_dict`` key) with ``ndim``
    dims: the reference's ``param_spec`` on an unstacked leaf."""
    names = name.split(".")
    leaf = names[-1]
    in_moe = "moe" in names and "shared" not in names
    if leaf == "embed":
        return ("model", None)
    if leaf in REPL or ndim <= 1:
        return (None,) * ndim
    if in_moe and leaf in ("wi_gate", "wi_up", "wo"):
        return ("model", None, None)          # experts -> model (EP)
    if leaf in ("w_dkv", "w_uk", "w_uv") or leaf in COL:
        return (None, "model")
    if leaf in ROW:
        return ("model", None)
    return (None,) * ndim


def param_specs(params) -> dict:
    """``{name: spec}`` of an LM (its ``state_dict``) or of any ``{name:
    tensor}`` mapping."""
    if hasattr(params, "state_dict"):
        params = params.state_dict()
    return {k: param_spec(k, v.dim() if hasattr(v, "dim") else v.ndim)
            for k, v in params.items()}


def zero1_specs(params, specs: dict, data_axes: tuple, mesh) -> dict:
    """ZeRO-1 (the reference's rule): the optimizer moments of a leaf
    whose spec is all None (norms, the router, ``frontend_proj``, ...)
    split their leading dim over the data axes where it divides; every
    other leaf's moments keep its spec, and the parameters stay as they
    are.  ``params`` maps names to anything with ``shape`` (the full
    leaves' shapes); the port's leaves are per layer, so a norm's leading
    dim is its width (the reference's stacked leaf has the layers there)."""
    sizes = axis_sizes(mesh)
    dsize = _size(sizes, tuple(data_axes)) if data_axes else 1
    out = {}
    for k, spec in specs.items():
        shape = tuple(params[k].shape)
        if dsize > 1 and shape and all(a is None for a in spec) and \
                shape[0] % dsize == 0 and shape[0] >= dsize:
            out[k] = (tuple(data_axes),) + (None,) * (len(shape) - 1)
        else:
            out[k] = spec
    return out


def train_specs(cfg, mesh, batch: int, seq: int, data_axes: tuple = ("data",),
                zero1: bool = True) -> tuple:
    """The reference's ``build_train_bundle`` specs for ``cfg`` on ``mesh``
    and a global ``batch`` of ``seq`` tokens: ``(param specs, opt specs,
    batch specs)`` -- the params' sanitized :func:`param_specs`, an
    ``AdamWState`` of ``((), mu specs, mu specs)`` (:func:`zero1_specs`
    with ``zero1``, else the params'), and :func:`batch_specs` of the
    ``tokens`` / ``labels`` batch.  ``data_axes`` are filtered to the
    mesh's."""
    from ..models.lm import LM
    from ..optim.adamw import AdamWState
    sizes = axis_sizes(mesh)
    data_axes = tuple(a for a in data_axes if a in sizes)
    full = LM(cfg, device="meta").state_dict()
    p_specs = sanitize_specs(param_specs(full), full, mesh)
    mu = zero1_specs(full, p_specs, data_axes, mesh) if zero1 else \
        dict(p_specs)
    struct = {k: np.empty((batch, seq), np.int32)
              for k in ("tokens", "labels")}
    return (p_specs, AdamWState((), mu, dict(mu)),
            batch_specs(struct, batch, mesh, data_axes))


def cache_spec(name: str, shape: tuple, batch_axes, msize: int = 1) -> tuple:
    """The spec of one cache leaf ``name`` of ``shape`` in the port's
    layout (the reference's ``cache_spec``; its (B, S, Hkv, hd) K/V split
    over the head dim is the port's (B, Hkv, S, hd) split over dim 1).
    A few-KV-head model whose heads do not divide the model axis splits
    the head dim instead, as in the reference.  The int8 cache's
    ``k_scale`` / ``v_scale`` (B, Hkv, S) follow their K/V heads."""
    nd = len(shape)
    ba = batch_axes if batch_axes else None
    if name == "len" or nd == 0:
        base = (None,) * nd
    elif name in ("k", "v"):            # (B, Hkv, S, hd)
        base = (ba, "model", None, None) if shape[1] % msize == 0 \
            else (ba, None, None, "model")
    elif name in ("k_scale", "v_scale"):   # (B, Hkv, S)
        base = (ba, "model", None) if shape[1] % msize == 0 \
            else (ba, None, None)
    elif name == "c" and nd == 3:       # mla latent (B, S, r)
        base = (ba, None, "model")
    elif name == "kr":                  # (B, S, rd)
        base = (ba, None, None)
    elif name == "state":               # mamba (B, H, P, N)
        base = (ba, "model", None, None)
    elif name == "conv":                # (B, 3, d_inner)
        base = (ba, None, "model")
    elif name == "C":                   # mlstm (B, H, hd, hd)
        base = (ba, None, "model", None)
    elif name == "n" and nd == 4:       # mlstm normalizer (B, H, 1, hd)
        base = (ba, None, None, None)
    elif nd == 2:                       # slstm scalars (B, d)
        base = (ba, "model")
    else:
        base = (ba,) + (None,) * (nd - 1)
    base = tuple(base)[:nd]
    return base + (None,) * (nd - len(base))


def _batch_axes(batch: int, mesh, data_axes: tuple) -> tuple:
    sizes = axis_sizes(mesh)
    dsize = int(np.prod([sizes[a] for a in data_axes])) if data_axes else 1
    return tuple(data_axes) if batch % max(dsize, 1) == 0 and \
        batch >= dsize else ()


def cache_specs(caches: list, batch: int, mesh, data_axes: tuple) -> list:
    """Specs of the port's caches (a list of per-layer ``{name: tensor}``
    dicts) on ``mesh``, sanitized."""
    ba = _batch_axes(batch, mesh, data_axes)
    msize = axis_sizes(mesh)["model"]
    specs = [{k: cache_spec(k, tuple(v.shape), ba, msize)
              for k, v in layer.items()} for layer in caches]
    return sanitize_specs(specs, caches, mesh)


def batch_specs(batch_struct: dict, batch: int, mesh,
                data_axes: tuple) -> dict:
    """Every batch leaf splits its leading dim over the data axes (when the
    batch divides), the rest replicated."""
    ba = _batch_axes(batch, mesh, data_axes) or None
    return {k: (ba,) + (None,) * (len(v.shape) - 1)
            for k, v in batch_struct.items()}


def sanitize_specs(specs, tree, mesh):
    """Drop any per-dim axis assignment that does not divide the dim (or
    exceeds it), e.g. 4 KV heads over a model axis of 16: the dim is then
    replicated.  ``specs`` and ``tree`` are dicts / lists / tuples of the
    same structure, ``tree``'s leaves anything with ``shape``."""
    sizes = axis_sizes(mesh)
    if isinstance(specs, dict):
        return {k: sanitize_specs(s, tree[k], mesh) for k, s in specs.items()}
    if isinstance(specs, list):
        return [sanitize_specs(s, t, mesh) for s, t in zip(specs, tree)]
    shape = tuple(tree.shape)
    dims = []
    for i, n in enumerate(shape):
        ax = specs[i] if i < len(specs) else None
        if ax is None:
            dims.append(None)
            continue
        size = _size(sizes, ax)
        dims.append(ax if n % size == 0 and n >= size else None)
    return tuple(dims)


def mesh_index(mesh) -> dict:
    """This process's coordinate along every axis of a ``DeviceMesh``."""
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def local_shard(tensor, spec: tuple, mesh, index: Optional[dict] = None):
    """The slice of the full ``tensor`` that the rank at ``index`` (``{axis:
    coordinate}``; this process's place in a ``DeviceMesh`` by default)
    holds under ``spec``: each split dim cut into equal blocks, block
    ``index`` kept (a view).  A dim that does not divide raises
    ``ValueError``."""
    sizes = axis_sizes(mesh)
    index = mesh_index(mesh) if index is None else index
    out = tensor
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = _size(sizes, axes)
        if size == 1:
            continue
        n = tensor.shape[dim]
        if n % size:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"split evenly over {axes} ({size})")
        coord = 0
        for a in axes:                  # row-major over the joint axes
            coord = coord * sizes[a] + index[a]
        step = n // size
        out = out.narrow(dim, coord * step, step)
    return out


def concat_shards(shards: list, spec: tuple, axis: str = "model"):
    """The inverse of :func:`local_shard` over one axis: the model-axis
    ranks' slices (in rank order) joined back along the dim ``spec`` splits
    over ``axis`` (the first rank's tensor where no dim is)."""
    import torch
    for dim, ax in enumerate(spec):
        if ax == axis or (isinstance(ax, tuple) and axis in ax):
            return torch.cat(list(shards), dim=dim)
    return shards[0]


# ---------------------------------------------------------------------------
# What a model-axis rank holds: the head plan and every leaf's blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """A model-axis rank's attention heads: query heads ``[q[0], q[1])``,
    KV heads ``[kv[0], kv[1])`` and ``group``, the ranks that hold the same
    KV heads (this rank alone where they have no copy elsewhere; empty for
    a rank with no query head, which holds no KV head either)."""
    q: tuple
    kv: tuple
    group: tuple


def plan_heads(cfg) -> tuple:
    """(query heads, KV heads) the plan places: an MLA model's heads are
    one KV group each (its keys and values are expanded per head from the
    latent)."""
    kinds = tuple(cfg.block_pattern) + tuple(cfg.remainder_pattern)
    h = cfg.num_heads
    return (h, h) if "mla" in kinds else (h, cfg.num_kv_heads)


def head_plan(cfg, n: int, rank: int) -> HeadPlan:
    """The heads rank ``rank`` of a model axis of ``n`` holds (module
    docstring; Megatron's rule for few KV heads).  With ``n`` KV heads or
    more, the KV groups split over the ranks by ``np.array_split`` and the
    rank takes its groups' query heads; with fewer, the ranks split over
    the groups by ``np.array_split`` and each rank of a group's run takes a
    copy of its KV heads and an ``array_split`` share of its query heads.
    A rank's query heads never straddle two groups, so its local attention
    is uniform GQA."""
    h, hkv = plan_heads(cfg)
    g = h // hkv
    if hkv >= n:
        kv = np.array_split(np.arange(hkv), n)[rank]
        k0, k1 = int(kv[0]), int(kv[-1]) + 1
        return HeadPlan((k0 * g, k1 * g), (k0, k1), (rank,))
    runs = np.array_split(np.arange(n), hkv)
    j = next(j for j, run in enumerate(runs) if rank in run)
    run = [int(r) for r in runs[j]]
    shares = np.array_split(np.arange(j * g, (j + 1) * g), len(run))
    mine = shares[run.index(rank)]
    group = tuple(r for r, s in zip(run, shares) if len(s))
    if not len(mine):
        q0 = int(shares[0][0]) + g     # past the group's heads: empty
        return HeadPlan((q0, q0), (j, j), ())
    return HeadPlan((int(mine[0]), int(mine[-1]) + 1), (j, j + 1), group)


def ssm_plan(cfg, n: int, rank: int) -> tuple:
    """The SSM heads ``[h0, h1)`` that rank ``rank`` of a model axis of
    ``n`` holds: contiguous whole heads by ``np.array_split`` (earlier ranks
    take the larger blocks; exactly the even split where the axis divides
    the heads), as :func:`head_plan` splits KV groups.  A rank may hold
    none (``h0 == h1``)."""
    heads = np.array_split(np.arange(cfg.num_heads), n)[rank]
    if not len(heads):
        return (0, 0)
    return (int(heads[0]), int(heads[-1]) + 1)


@dataclasses.dataclass(frozen=True)
class LeafBlocks:
    """How a leaf splits over a model axis: along dim ``dim`` (``size``
    long in the full leaf) rank ``r`` holds the concatenation, in order, of
    its segments ``segments[r]``, each ``(lo, hi, writer)``: the full
    leaf's ``[lo, hi)`` and whether the rank is that segment's first holder
    -- the rank that writes it to a checkpoint and counts it in the global
    gradient norm.  A copy repeats a segment on several ranks; a rank that
    holds nothing has no segment.  ``entered``: the model sums a copied
    segment's gradient over the axis itself (it enters the rank's products
    as a whole leaf does, :meth:`~repro_torch.core.shard_plan.ModelAxis
    .enter_all`), so the trainer does not sum it again."""
    dim: int
    size: int
    segments: tuple
    entered: bool = False

    @classmethod
    def of(cls, dim: int, size: int, spans, **kw) -> "LeafBlocks":
        """Blocks from each rank's ``(lo, hi, writer)`` spans, the empty
        ones dropped."""
        return cls(dim, size, tuple(tuple((lo, hi, w) for lo, hi, w in segs
                                          if hi > lo) for segs in spans),
                   **kw)

    @property
    def copies(self) -> bool:
        """Whether some segment is held by more than one rank."""
        return any(c for r in range(len(self.segments))
                   for *_, c in self.local(r))

    def local(self, rank: int) -> list:
        """``[(local lo, lo, hi, writer, copied)]``: rank ``rank``'s
        segments with their offsets in its slice and whether another rank
        holds the same one."""
        held = [(lo, hi) for segs in self.segments for lo, hi, _ in segs]
        out, at = [], 0
        for lo, hi, w in self.segments[rank]:
            out.append((at, lo, hi, w, held.count((lo, hi)) > 1))
            at += hi - lo
        return out

    def writes(self, rank: int) -> bool:
        """Whether rank ``rank`` is the first holder of some segment."""
        return any(w for _, _, w in self.segments[rank])

    def take(self, t, rank: int):
        """Rank ``rank``'s slice of the full leaf ``t``: one segment's view,
        several segments joined (a new tensor), an empty view for none."""
        segs = self.segments[rank]
        if len(segs) <= 1:
            lo, hi = (segs[0][:2] if segs else (0, 0))
            return t.narrow(self.dim, lo, hi - lo)
        import torch
        return torch.cat([t.narrow(self.dim, lo, hi - lo)
                          for lo, hi, _ in segs], dim=self.dim)


#: the parents of the attention projections the head plan places
ATTN = ("attn", "xattn")


def _mamba_blocks(leaf: str, shape: tuple, cfg, n: int):
    """A mamba layer's leaf split by :func:`ssm_plan` (module docstring):
    ``w_in``'s columns ``x | z | B | C | dt`` as the rank's x, z, the B | C
    block every rank copies (written by rank 0; its gradient summed in the
    layer, ``entered``) and its dt; ``conv_w``'s columns and ``w_out``'s
    rows by the rank's x; ``A_log``, ``D``, ``dt_bias`` by its heads;
    ``norm_z`` whole."""
    di, ns = 2 * cfg.d_model, cfg.ssm_state
    per = di // cfg.num_heads
    plans = [ssm_plan(cfg, n, r) for r in range(n)]
    if leaf == "w_in":
        dt = 2 * di + 2 * ns
        return LeafBlocks.of(1, shape[1], [
            ((h0 * per, h1 * per, True), (di + h0 * per, di + h1 * per, True),
             (2 * di, dt, r == 0), (dt + h0, dt + h1, True))
            for r, (h0, h1) in enumerate(plans)], entered=True)
    dims = {"conv_w": (1, per), "w_out": (0, per), "A_log": (0, 1),
            "D": (0, 1), "dt_bias": (0, 1)}
    if leaf not in dims:
        return None                              # norm_z
    dim, step = dims[leaf]
    return LeafBlocks.of(dim, shape[dim], [((h0 * step, h1 * step, True),)
                                           for h0, h1 in plans])


def leaf_blocks(name: str, shape: tuple, cfg, n: int) -> Optional[LeafBlocks]:
    """How parameter ``name`` (a ``state_dict`` key) of full ``shape``
    splits over a model axis of ``n`` ranks (module docstring): the
    attention projections (the shared attention set's among them) by
    :func:`head_plan`, a mamba layer's leaves by :func:`ssm_plan`, an MLA
    layer's ``w_dkv`` and ``w_kr`` and an MoE layer's shared experts
    whole, every other leaf evenly along the dim its spec splits over
    ``model``.  None where the leaf is whole on every rank (or ``n`` is
    1); a dim that does not split evenly raises ``ValueError``."""
    if n == 1:
        return None
    names = name.split(".")
    leaf = names[-1]
    if len(names) > 1 and names[-2] in ATTN:
        if leaf not in ("wq", "wk", "wv", "wo", "w_uk", "w_uv"):
            return None                          # MLA's w_dkv, w_kr
        h, hkv = plan_heads(cfg)
        plans = [head_plan(cfg, n, r) for r in range(n)]
        kv = leaf in ("wk", "wv")
        dim = 0 if leaf == "wo" else 1
        per = shape[dim] // (hkv if kv else h)
        return LeafBlocks.of(dim, shape[dim], [
            ((lo * per, hi * per,
              bool(p.group) and (p.group[0] == r if kv else True)),)
            for r, p in enumerate(plans)
            for lo, hi in [p.kv if kv else p.q]])
    if len(names) > 1 and names[-2] == "mamba":
        return _mamba_blocks(leaf, shape, cfg, n)
    if "moe" in names and "shared" in names:
        return None
    for dim, ax in enumerate(param_spec(name, len(shape))):
        if ax != "model":
            continue
        if shape[dim] % n:
            raise ValueError(f"{name}: dim {dim} of {tuple(shape)} does not "
                             f"split evenly over a model axis of {n}")
        step = shape[dim] // n
        return LeafBlocks.of(dim, shape[dim], [((r * step, (r + 1) * step,
                                                 True),) for r in range(n)])
    return None


def local_leaf(t, name: str, cfg, n: int, rank: int):
    """Model rank ``rank``'s slice of the full leaf ``t`` (a view where it
    is one block; ``t`` itself where the leaf is whole on every rank), by
    :func:`leaf_blocks`."""
    blk = leaf_blocks(name, tuple(t.shape), cfg, n)
    return t if blk is None else blk.take(t, rank)


def join_leaf(parts: list, blk: Optional[LeafBlocks]):
    """The full leaf from the model ranks' slices ``parts`` (rank order):
    each segment put at its place, a copy taken once (its first holder's);
    the first rank's tensor where the leaf is whole."""
    if blk is None:
        return parts[0]
    import torch
    keep = sorted(((lo, p.narrow(blk.dim, at, hi - lo))
                   for r, p in enumerate(parts)
                   for at, lo, hi, w, _ in blk.local(r) if w),
                  key=lambda e: e[0])
    return torch.cat([t for _, t in keep], dim=blk.dim)


def cache_blocks(kind: str, name: str, cfg,
                 n: int) -> Optional[LeafBlocks]:
    """How the cache leaf ``name`` (the port's layout) of a ``kind`` layer
    splits over a model axis of ``n`` ranks, as the LM's
    ``init_caches`` places it: an attention layer's K/V heads (and int8
    scales) by :func:`head_plan` (a copy written by its group's first
    rank), a mamba layer's ``state`` by its heads and ``conv`` by its x
    columns (:func:`ssm_plan`); ``len`` and MLA's latent whole (None)."""
    if n == 1 or name == "len" or kind == "mla":
        return None
    if kind == "mamba":
        plans = [ssm_plan(cfg, n, r) for r in range(n)]
        dim, per = (1, 1) if name == "state" else \
            (2, 2 * cfg.d_model // cfg.num_heads)
        return LeafBlocks.of(dim, cfg.num_heads * per,
                             [((h0 * per, h1 * per, True),)
                              for h0, h1 in plans])
    if name not in ("k", "v", "k_scale", "v_scale"):
        raise NotImplementedError(
            f"the {kind} cache over a mesh is not ported yet (ROADMAP.md, "
            f"Queue 1 item 6d-2 b)")
    plans = [head_plan(cfg, n, r) for r in range(n)]
    return LeafBlocks.of(1, plan_heads(cfg)[1], [
        ((p.kv[0], p.kv[1], bool(p.group) and p.group[0] == r),)
        for r, p in enumerate(plans)])


__all__ = ["COL", "ROW", "REPL", "axis_sizes", "param_spec", "param_specs",
           "zero1_specs", "train_specs", "cache_spec", "cache_specs",
           "batch_specs", "sanitize_specs", "mesh_index", "local_shard",
           "concat_shards", "HeadPlan", "plan_heads", "head_plan",
           "ssm_plan", "LeafBlocks", "leaf_blocks", "local_leaf",
           "join_leaf", "cache_blocks"]
