"""Atomic, async-capable checkpoints in the reference's on-disk format
(counterpart of ``repro/checkpoint/ckpt.py``), without JAX.

Layout, as the reference writes it::

    <dir>/step_000000123/
        manifest.json            # step, leaf paths / shapes / dtypes / shards
        shard_00000.npz          # this host's leaves
    <dir>/step_000000123.COMMITTED  # atomic commit marker (rename-based)

A tree is nested dicts, tuples and named tuples with tensor (or numpy)
leaves, flattened in JAX's order -- dict keys sorted, tuples in order, a
named tuple's fields in order -- so the ``leaf_{i:05d}`` names match, and
each leaf's manifest ``path`` is the string ``jax.tree_util.keystr`` gives
it (``['params']['scan'][0]['attn']['wq']``, ``['opt'].mu['embed']``,
``['opt'].step``), produced here (:func:`tree_flatten_with_path`).  A leaf
is written whole, as the one addressable shard ``leaf_…_s<host>_0`` of a
single-device array is in the reference.  bf16 leaves are stored as the
reference's numpy writes an ``ml_dtypes`` bfloat16 array: two raw bytes an
element under the descriptor ``<V2``; the manifest's ``dtype`` says
``bfloat16``, and that decides how the bytes are read back.  (The
reference's own restore cannot read such a member: ROADMAP.md, reference
caveat (e).)

:class:`CheckpointManager` keeps keep-N retention and a background-thread
save: the leaves are copied to host memory synchronously (so the caller may
update them in place at once, as the trainer's optimizer does) and written
in the background; an error of that write is raised from :meth:`wait` or
from the next :meth:`save`.  A torn step (a commit marker without its
directory) is skipped on restore, falling back to the step before.

**Sharded checkpoints** (model-parallel training).  A rank's leaf is a
:class:`ShardedLeaf`: its block of a global leaf, placed by a spec over
the mesh's axes.  The manifest gives each leaf's global shape and every
shard's global offsets, as the reference's does; each rank writes its own
``shard_{rank:05d}.npz``; a leaf replicated over an axis is written once,
by coordinate 0 on that axis (the reference's ``replica_id == 0``).  A
leaf placed by the head plan carries its model-axis blocks
(:class:`ShardedLeaf`'s ``blocks``): its offsets are the plan's, one
member a segment (a mamba layer's ``w_in`` is four on a rank), and a copy
held by several ranks (a KV copy, zamba2's B | C columns) is written
once, by its first holder, and restored into every copy.  Rank
0 writes the manifest once every rank's file is in place and publishes
through the same commit protocol; every rank's save returns once the step
is committed.  That barrier is the files themselves, not the process
group: the write runs on a background thread while the training thread
makes collectives.  :func:`restore_checkpoint` with ``shardings=`` (a tree
of :class:`ShardedLeaf` placements) reads only the rank's block of each
leaf, from the members whose offsets overlap it, so it restores onto any
mesh (elastic) and never builds a whole leaf; without it, the whole leaves
are assembled by their offsets.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import zipfile
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

#: the npy descriptor numpy writes for an ml_dtypes bfloat16 array
BF16_DESCR = "<V2"
#: how long a sharded save waits for the other ranks' files or the commit
SHARD_WAIT_S = 600.0


class ShardedLeaf:
    """One rank's block of a global leaf: ``data`` (a tensor, or None for a
    placement: where the block lies, :func:`restore_checkpoint`'s
    ``shardings``), ``spec`` (per dim an axis name, a tuple of axis names
    or None, as :mod:`repro_torch.launch.sharding` writes them), ``sizes``
    (``{axis: size}`` of the mesh, in the mesh's order: ranks are
    numbered row-major over it) and ``index`` (``{axis: coordinate}`` of
    the rank).  ``blocks`` -- ``(axis, leaf blocks)``, a
    :class:`repro_torch.launch.sharding.LeafBlocks` over the mesh axis
    ``axis`` -- places the leaf instead of ``spec``: the rank at
    coordinate ``c`` of ``axis`` holds the segments ``segments[c]`` of its
    dim ``dim`` (``size`` in the global leaf) joined in order, whole on
    every other axis, and writes each segment it is the first holder of
    as a member of its own (coordinate 0 on the other axes).  A tree leaf
    (not a node) for the flattening below."""

    __slots__ = ("data", "spec", "sizes", "index", "blocks")

    def __init__(self, data, spec: tuple, sizes: dict, index: dict,
                 blocks: Optional[tuple] = None):
        self.data, self.spec = data, tuple(spec)
        self.sizes, self.index = dict(sizes), dict(index)
        self.blocks = blocks

    @classmethod
    def stack(cls, leaves: list) -> "ShardedLeaf":
        """Leaves of one spec stacked on a new leading dim (the reference's
        layers under ``scan``): the stacked dim is whole on every rank."""
        first = leaves[0]
        data = None if first.data is None else \
            torch.stack([x.data for x in leaves])
        blocks = first.blocks
        if blocks is not None:
            axis, lb = blocks
            blocks = (axis, dataclasses.replace(lb, dim=lb.dim + 1))
        return cls(data, (None,) + first.spec, first.sizes, first.index,
                   blocks)

    def _axes(self, ax) -> tuple:
        return () if ax is None else (ax if isinstance(ax, tuple) else (ax,))

    def _split(self, ax, index: dict) -> tuple:
        """(parts, this rank's part) of a dim split over ``ax``."""
        parts, coord = 1, 0
        for a in self._axes(ax):            # row-major over joint axes
            parts *= self.sizes[a]
            coord = coord * self.sizes[a] + index[a]
        return parts, coord

    def global_shape(self) -> tuple:
        """The global leaf's shape, from the block's."""
        shape = tuple(self.data.shape)
        if self.blocks is not None:
            lb = self.blocks[1]
            return shape[:lb.dim] + (lb.size,) + shape[lb.dim + 1:]
        spec = self.spec + (None,) * (len(shape) - len(self.spec))
        return tuple(n * self._split(ax, self.index)[0]
                     for n, ax in zip(shape, spec))

    def pieces(self, shape: tuple, index: Optional[dict] = None) -> list:
        """``[(bounds, writes)]``: the blocks of the global ``shape`` that
        the rank at ``index`` (this one's by default) holds, in the order
        its data joins them (one for a spec; one a segment for
        ``blocks``, an empty one where the rank holds none), each with
        ``[[lo, hi], ...]`` per dim and whether the rank writes it."""
        index = self.index if index is None else index
        if self.blocks is not None:
            axis, lb = self.blocks
            first = all(c == 0 for a, c in index.items() if a != axis)
            out = []
            for lo, hi, w in lb.segments[index[axis]] or ((0, 0, False),):
                rect = [[0, n] for n in shape]
                rect[lb.dim] = [lo, hi]
                out.append((rect, w and first))
            return out
        spec = self.spec + (None,) * (len(shape) - len(self.spec))
        out = []
        for n, ax in zip(shape, spec):
            parts, coord = self._split(ax, index)
            if n % parts:
                raise ValueError(f"dim of {n} does not split over "
                                 f"{self._axes(ax)} ({parts})")
            step = n // parts
            out.append([coord * step, (coord + 1) * step])
        used = {a for ax in self.spec for a in self._axes(ax)}
        return [(out, all(c == 0 for a, c in index.items()
                          if a not in used))]

    def written(self, shape: tuple, index: Optional[dict] = None) -> list:
        """``[(member number, bounds, the block's data)]`` of the pieces
        the rank at ``index`` (this one by default) writes; the data is
        this rank's own (None for another rank's)."""
        out, at = [], 0
        dim = None if self.blocks is None else self.blocks[1].dim
        for rect, w in self.pieces(shape, index):
            n = 0 if dim is None else rect[dim][1] - rect[dim][0]
            if w:
                data = None
                if index is None:
                    data = self.data if dim is None else \
                        self.data.narrow(dim, at, n)
                out.append((len(out), rect, data))
            at += n
        return out

    def ranks(self) -> list:
        """``(rank, index)`` of every rank of the mesh, in rank order."""
        return [(r, dict(zip(self.sizes, coords))) for r, coords in
                enumerate(np.ndindex(*self.sizes.values()))]

    @property
    def rank(self) -> int:
        r = 0
        for a, n in self.sizes.items():
            r = r * n + self.index[a]
        return r


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten_with_path(tree, path: str = "") -> list:
    """``[(keystr path, leaf), ...]`` in JAX's flattening order; ``None``
    is an empty subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_flatten_with_path(tree[k], f"{path}[{k!r}]")
        return out
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out += tree_flatten_with_path(getattr(tree, f), f"{path}.{f}")
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, x in enumerate(tree):
            out += tree_flatten_with_path(x, f"{path}[{i}]")
        return out
    return [(path, tree)]


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` with ``leaves`` in flattening order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree):
    return tree_unflatten(tree, [fn(x) for _, x in
                                 tree_flatten_with_path(tree)])


def _dtype_name(leaf) -> str:
    if isinstance(leaf, ShardedLeaf):
        return _dtype_name(leaf.data)
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).split(".")[-1]
    return str(np.asarray(leaf).dtype)


def host_copy(leaf):
    """A private host copy of a leaf: a CPU tensor for a tensor (its own
    memory, whatever device it came from), a numpy array otherwise."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _to_numpy(leaf) -> np.ndarray:
    """The leaf's bytes as numpy: bf16 as uint16 (written under
    :data:`BF16_DESCR`)."""
    if isinstance(leaf, ShardedLeaf):
        return _to_numpy(leaf.data)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.ascontiguousarray(np.asarray(leaf))


def _write_npz(path: Path, arrays: dict, bf16: set) -> None:
    """``np.savez`` of ``arrays`` (stored, zip64 members ``<name>.npy``),
    the members named in ``bf16`` with the ``<V2`` descriptor; flushed and
    fsynced."""
    with open(path, "wb") as f:
        with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for name, arr in arrays.items():
                with zf.open(name + ".npy", "w", force_zip64=True) as fid:
                    if name in bf16:
                        np.lib.format.write_array_header_1_0(fid, {
                            "descr": BF16_DESCR, "fortran_order": False,
                            "shape": arr.shape})
                        fid.write(arr.tobytes())
                    else:
                        np.lib.format.write_array(fid, arr,
                                                  allow_pickle=False)
        f.flush()
        os.fsync(f.fileno())


# ---------------------------------------------------------------------------
# Save / publish / restore
# ---------------------------------------------------------------------------

def save_checkpoint(ckpt_dir, step: int, tree, *, host_index: int = 0):
    """Write ``tree`` as step ``step`` and commit it.  A tree with
    :class:`ShardedLeaf` leaves is one rank's part of a sharded
    checkpoint (:func:`_save_sharded`; ``host_index`` is then ignored)."""
    leaves = tree_flatten_with_path(tree)
    sharded = next((x for _, x in leaves if isinstance(x, ShardedLeaf)),
                   None)
    if sharded is not None:
        return _save_sharded(Path(ckpt_dir), step, leaves, sharded)
    ckpt_dir = Path(ckpt_dir)
    step_dir = ckpt_dir / f"step_{step:09d}"
    tmp_dir = ckpt_dir / f".tmp_step_{step:09d}_{host_index}"
    tmp_dir.mkdir(parents=True, exist_ok=True)

    manifest = {"step": step, "leaves": []}
    arrays, bf16 = {}, set()
    for i, (path, leaf) in enumerate(leaves):
        key = f"leaf_{i:05d}"
        dtype = _dtype_name(leaf)
        arr = _to_numpy(leaf)
        name = f"{key}_s{host_index}_0"
        arrays[name] = arr
        if dtype == "bfloat16":
            bf16.add(name)
        manifest["leaves"].append(
            {"key": key, "path": path, "shape": list(arr.shape),
             "dtype": dtype,
             "shards": [{"name": name,
                         "index": [[0, s] for s in arr.shape]}]})

    _write_npz(tmp_dir / f"shard_{host_index:05d}.npz", arrays, bf16)
    _write_manifest(tmp_dir, manifest)
    marker = ckpt_dir / f"step_{step:09d}.COMMITTED"
    publish_dir(ckpt_dir, tmp_dir, step_dir, marker)
    return step_dir


def _write_manifest(tmp_dir: Path, manifest: dict) -> None:
    with open(tmp_dir / "manifest.json", "w") as f:
        f.write(json.dumps(manifest))
        f.flush()
        os.fsync(f.fileno())


def _save_sharded(ckpt_dir: Path, step: int, leaves: list,
                  first: ShardedLeaf):
    """One rank's part of a sharded save: its members (the leaves it
    writes, :meth:`ShardedLeaf.written`, a member each; a plain leaf
    counts as replicated)
    into ``shard_{rank:05d}.npz`` of the step's shared temporary
    directory, renamed into place once written.  Rank 0 then waits for
    every rank's file, writes the manifest (every writer's shard of every
    leaf with its global offsets, in rank order) and publishes; the other
    ranks wait until the step is committed."""
    sizes, rank = first.sizes, first.rank
    world = int(np.prod(list(sizes.values())))
    step_dir = ckpt_dir / f"step_{step:09d}"
    tmp_dir = ckpt_dir / f".tmp_step_{step:09d}_0"
    marker = ckpt_dir / f"step_{step:09d}.COMMITTED"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    arrays, bf16 = {}, set()
    for i, (path, leaf) in enumerate(leaves):
        if not isinstance(leaf, ShardedLeaf):
            leaf = ShardedLeaf(leaf, (), sizes, first.index)
        key = f"leaf_{i:05d}"
        dtype = _dtype_name(leaf)
        shape = leaf.global_shape()
        for j, _, data in leaf.written(shape):
            name = f"{key}_s{rank}_{j}"
            arrays[name] = _to_numpy(data)
            if dtype == "bfloat16":
                bf16.add(name)
        manifest["leaves"].append(
            {"key": key, "path": path, "shape": list(shape),
             "dtype": dtype,
             "shards": [{"name": f"{key}_s{r}_{j}", "index": rect}
                        for r, index in leaf.ranks()
                        for j, rect, _ in leaf.written(shape, index)]})
    part = tmp_dir / f"shard_{rank:05d}.npz"
    _write_npz(part.with_suffix(".part"), arrays, bf16)
    part.with_suffix(".part").rename(part)
    if rank != 0:
        # committed: rank 0 renamed the directory this rank wrote into,
        # then wrote the marker (an older marker was removed before)
        _wait_for(lambda: not tmp_dir.exists() and marker.exists(),
                  f"the commit of step {step}")
        return step_dir
    _wait_for(lambda: all((tmp_dir / f"shard_{r:05d}.npz").exists()
                          for r in range(world)),
              f"the {world} ranks' files of step {step}")
    _write_manifest(tmp_dir, manifest)
    publish_dir(ckpt_dir, tmp_dir, step_dir, marker)
    return step_dir


def _wait_for(done: Callable[[], bool], what: str) -> None:
    deadline = time.monotonic() + SHARD_WAIT_S
    while not done():
        if time.monotonic() > deadline:
            raise TimeoutError(f"a sharded checkpoint waited "
                               f"{SHARD_WAIT_S:.0f} s for {what}")
        time.sleep(0.01)


def publish_dir(parent: Path, tmp_dir: Path, final_dir: Path,
                marker: Path) -> None:
    """The commit-marker publish protocol: retire an old marker before its
    directory goes, rename the new directory into place, make the rename
    durable, then write the marker -- so a crash never leaves a committed
    marker pointing at nothing that restore would trust."""
    marker.unlink(missing_ok=True)
    if final_dir.exists():
        shutil.rmtree(final_dir)
    tmp_dir.rename(final_dir)
    _fsync_dir(parent)                    # make the rename durable
    marker.write_text(str(time.time()))
    _fsync_dir(parent)                    # ... and the commit marker


def atomic_write_text(path, text: str) -> None:
    """Durable atomic single-file publish: write a tmp sibling, fsync it,
    rename it over the target, fsync the directory.  A bare
    ``write_text`` + ``rename`` is atomic against readers but not against
    power loss: the rename can land before the data blocks do."""
    path = Path(path)
    tmp = path.with_name("." + path.name + ".tmp")
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    tmp.rename(path)
    _fsync_dir(path.parent)


def _fsync_dir(path: Path) -> None:
    """Best-effort directory fsync (rename/unlink durability on POSIX)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _is_torn(ckpt_dir: Path, step: int) -> bool:
    """A committed marker whose step directory (or manifest) is missing."""
    return not (ckpt_dir / f"step_{step:09d}" / "manifest.json").exists()


def committed_steps(ckpt_dir) -> list:
    """All *intact* committed steps, ascending (torn steps excluded)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    steps = sorted(int(p.stem.split("_")[1])
                   for p in ckpt_dir.glob("step_*.COMMITTED"))
    return [s for s in steps if not _is_torn(ckpt_dir, s)]


def latest_step(ckpt_dir) -> Optional[int]:
    """The newest committed step whose directory is intact."""
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def _from_member(arr: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "bfloat16":
        return np.ascontiguousarray(arr).view(np.uint16)
    return arr


def _tensor(full: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(full).view(torch.bfloat16)
    return torch.from_numpy(full)


def restore_checkpoint(ckpt_dir, tree_like, *, step: int = None,
                       shardings=None):
    """``(tree, step)``: the checkpoint's leaves in ``tree_like``'s
    structure, matched by path, each a CPU tensor of the manifest's dtype
    (``tree_like``'s leaves give only the structure: meta tensors do).
    The latest intact step unless ``step`` is given.

    Without ``shardings`` every leaf is whole, assembled from its shards
    by their offsets (a checkpoint written from any mesh restores onto one
    device).  With ``shardings`` -- a tree of :class:`ShardedLeaf`
    placements in ``tree_like``'s structure -- each leaf is the block the
    placement's rank holds, read from the members whose offsets overlap
    it and nothing else (onto any mesh: elastic)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    step_dir = ckpt_dir / f"step_{step:09d}"
    if not (step_dir / "manifest.json").exists():
        raise FileNotFoundError(
            f"checkpoint step {step} in {ckpt_dir} is torn "
            f"(committed marker without manifest)")
    manifest = json.loads((step_dir / "manifest.json").read_text())
    files = [np.load(f) for f in sorted(step_dir.glob("shard_*.npz"))]
    try:
        where = {name: z for z in files for name in z.files}
        by_path = {e["path"]: e for e in manifest["leaves"]}
        like = tree_flatten_with_path(tree_like)
        places = ([x for _, x in tree_flatten_with_path(shardings)]
                  if shardings is not None else [None] * len(like))
        if len(places) != len(like):
            raise ValueError(f"shardings has {len(places)} leaves, the "
                             f"tree {len(like)}")
        out_leaves = [_read_leaf(by_path[path], where, place)
                      for (path, _), place in zip(like, places)]
    finally:
        for z in files:
            z.close()
    return tree_unflatten(tree_like, out_leaves), step


def _read_leaf(entry: dict, where: dict, place) -> torch.Tensor:
    """One leaf of the manifest: whole (``place`` None) or the blocks of
    the placement's rank joined as its data joins them, each from the
    overlapping members."""
    shape, dtype = tuple(entry["shape"]), entry["dtype"]
    if place is None:
        return _tensor(_read_block(entry, where, [[0, n] for n in shape]),
                       dtype)
    blocks = [_read_block(entry, where, rect)
              for rect, _ in place.pieces(shape)]
    if len(blocks) == 1:
        return _tensor(blocks[0], dtype)
    return _tensor(np.concatenate(blocks, axis=place.blocks[1].dim), dtype)


def _read_block(entry: dict, where: dict, want: list) -> np.ndarray:
    """The block ``want`` (``[[lo, hi], ...]`` per dim) of a manifest
    leaf, from the members whose offsets overlap it (numpy; bf16 as
    uint16)."""
    shape, dtype = tuple(entry["shape"]), entry["dtype"]
    shards = entry["shards"]
    if len(shards) == 1 and shards[0]["index"] == want:
        block = _from_member(where[shards[0]["name"]][shards[0]["name"]],
                             dtype)
        return np.ascontiguousarray(block).reshape([b - a for a, b in want])
    block = np.zeros([b - a for a, b in want],
                     np.uint16 if dtype == "bfloat16" else np.dtype(dtype))
    for s in shards:
        lo = [max(a, c) for (a, _), (c, _) in zip(s["index"], want)]
        hi = [min(b, d) for (_, b), (_, d) in zip(s["index"], want)]
        if any(a >= b for a, b in zip(lo, hi)) and shape:
            continue
        member = _from_member(where[s["name"]][s["name"]], dtype)
        src = tuple(slice(a - c, b - c)
                    for a, b, (c, _) in zip(lo, hi, s["index"]))
        dst = tuple(slice(a - c, b - c)
                    for a, b, (c, _) in zip(lo, hi, want))
        block[dst] = member.reshape([b - a for a, b in s["index"]])[src]
    return block


class CheckpointManager:
    """Keep-N retention and the background save.  ``rank`` is this
    process's rank where it writes its part of sharded checkpoints: only
    rank 0 retires old steps."""

    def __init__(self, ckpt_dir, keep: int = 3, async_save: bool = True,
                 rank: int = 0):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.async_save = async_save
        self.rank = rank
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        """Join an in-flight background save; an exception that save hit is
        raised here (a failed write must never pass as durable) -- and from
        the next :meth:`save`."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, transform: Optional[Callable] = None):
        """Copy the leaves to host memory now (:func:`host_copy`), then
        write them -- in the background with ``async_save`` -- as
        ``transform(host tree)`` if given (the trainer stacks its per-layer
        state into the reference's tree there, off the training thread)."""
        self.wait()                     # re-raises a failed previous save
        host_tree = tree_map(host_copy, tree)

        def _do():
            try:
                save_checkpoint(self.dir, step, transform(host_tree)
                                if transform is not None else host_tree)
                if self.rank == 0:
                    self._gc()
            except BaseException as e:   # noqa: BLE001 -- the thread's
                if not self.async_save:  # error is kept for wait()
                    raise
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()
        else:
            _do()

    def restore(self, tree_like, shardings=None, step=None):
        return restore_checkpoint(self.dir, tree_like, step=step,
                                  shardings=shardings)

    def latest(self):
        return latest_step(self.dir)

    def _gc(self):
        steps = sorted(int(p.stem.split("_")[1])
                       for p in self.dir.glob("step_*.COMMITTED"))
        for s in steps[:-self.keep]:
            (self.dir / f"step_{s:09d}.COMMITTED").unlink(missing_ok=True)
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)
