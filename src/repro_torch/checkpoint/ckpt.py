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
directory) is skipped on restore, falling back to the step before.  The
elastic restore onto another mesh (``shardings=``) waits for the sharding
item (ROADMAP.md, Queue 1 item 6c).
"""
from __future__ import annotations

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
    ckpt_dir = Path(ckpt_dir)
    step_dir = ckpt_dir / f"step_{step:09d}"
    tmp_dir = ckpt_dir / f".tmp_step_{step:09d}_{host_index}"
    tmp_dir.mkdir(parents=True, exist_ok=True)

    manifest = {"step": step, "leaves": []}
    arrays, bf16 = {}, set()
    for i, (path, leaf) in enumerate(tree_flatten_with_path(tree)):
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
    with open(tmp_dir / "manifest.json", "w") as f:
        f.write(json.dumps(manifest))
        f.flush()
        os.fsync(f.fileno())
    marker = ckpt_dir / f"step_{step:09d}.COMMITTED"
    publish_dir(ckpt_dir, tmp_dir, step_dir, marker)
    return step_dir


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
    structure, matched by path, each a CPU tensor of the manifest's shape
    and dtype (``tree_like``'s leaves give only the structure: meta tensors
    do).  The latest intact step unless ``step`` is given."""
    if shardings is not None:
        raise NotImplementedError(
            "restoring onto a mesh (shardings=) is not ported yet "
            "(ROADMAP.md, Queue 1 item 6c)")
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
    data: dict = {}
    for f in step_dir.glob("shard_*.npz"):
        with np.load(f) as z:
            data.update({k: z[k] for k in z.files})

    by_path = {e["path"]: e for e in manifest["leaves"]}
    out_leaves = []
    for path, _ in tree_flatten_with_path(tree_like):
        entry = by_path[path]
        shape, dtype = tuple(entry["shape"]), entry["dtype"]
        if len(entry["shards"]) == 1 and \
                entry["shards"][0]["index"] == [[0, s] for s in shape]:
            full = _from_member(data[entry["shards"][0]["name"]], dtype)
        else:
            full = np.zeros(shape, np.uint16 if dtype == "bfloat16"
                            else np.dtype(dtype))
            for s in entry["shards"]:
                idx = tuple(slice(a, b) for a, b in s["index"])
                full[idx] = _from_member(data[s["name"]], dtype)
        out_leaves.append(_tensor(full.reshape(shape), dtype))
    return tree_unflatten(tree_like, out_leaves), step


class CheckpointManager:
    def __init__(self, ckpt_dir, keep: int = 3, async_save: bool = True):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.async_save = async_save
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
