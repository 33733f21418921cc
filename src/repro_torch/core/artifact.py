"""Serving artifact: boot by loading, not compiling (counterpart of
``repro/core/artifact.py``).

A fresh process re-pays the whole PassManager pipeline before its first
request.  This module makes the compiled program a durable on-disk
artifact, so a restarted server (or a respawned replica of the
disaggregated tier) reaches its first token by **loading**::

    <artifact_dir>/current/
        meta.json        # format + runtime fingerprint + compile identity
        compile.pkl      # pickled ProgramCompileResult (IR + AccessPlans)
    <artifact_dir>/current.COMMITTED   # the checkpoints' commit marker

Publication goes through :func:`repro_torch.checkpoint.ckpt.publish_dir`,
the retire-marker -> rename -> fsync sequence checkpoints use, so a crash
mid-save leaves either the previous committed artifact or a torn state
that :func:`load_artifact` detects and rejects.

Loading is fingerprint-gated: the artifact is accepted only when the
runtime fingerprint (:func:`runtime_fingerprint`: torch's version and
``torch.version.cuda``, the device's name and compute capability or
``"cpu"``, the driver's version where the card reports it, the kernel
library's source digest, :data:`FORMAT_VERSION`) matches the running
process AND the compile identity (program signature hash, opt_level,
vlen, fusion budget, hot spec) matches what the caller is about to
compile.  Any mismatch counts a reject (:func:`artifact_stats`) and falls
back to a fresh compile: a stale artifact can cost time, never numerics.

**No executables ride along.**  The reference also stores serialized XLA
executables, one per kernel call site (its ``AotCache`` and ``aot.pkl``).
Nothing here stands for them: the port's kernels are the shared library
``build/kernels/ember_kernels-<digest>.so`` that
:mod:`repro_torch.kernels._build` compiles once per source digest and
every later process (a respawned replica included) loads as it is, and a
server's CUDA graphs are captured at its boot, on its own caches.  So the
artifact holds the compile result alone, the digest in the fingerprint
ties it to the kernels it was compiled beside, and the reference's
``aot_deserialized`` / ``aot_compiled`` / ``aot_fallbacks`` counters have
no counterpart in :func:`artifact_stats` (whether a process built the
kernel library or loaded an earlier build is
``kernels._build.build().built``).  A payload whose kernels changed is a
``fingerprint`` reject and a fresh compile, never a partial load.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import json
import os
import pickle
import shutil
from pathlib import Path
from typing import Optional

import torch

from .access_plan import canonical_hot
from .cost_model import FusionBudget
from .pipeline import ProgramCompileResult, compile_cache_key

__all__ = ["FORMAT_VERSION", "artifact_meta", "artifact_stats",
           "compile_key_of", "load_artifact", "note_fresh_compile",
           "reset_artifact_stats", "runtime_fingerprint", "save_artifact"]

#: bump on any incompatible change to the on-disk layout
FORMAT_VERSION = 1

_STATS = {"saves": 0, "loads": 0, "fresh_compiles": 0, "rejects": {}}


def artifact_stats() -> dict:
    """Process-wide load/save/reject counters (rejects keyed by reason)."""
    s = dict(_STATS)
    s["rejects"] = dict(_STATS["rejects"])
    return s


def reset_artifact_stats() -> None:
    _STATS.update({"saves": 0, "loads": 0, "fresh_compiles": 0,
                   "rejects": {}})


def _reject(reason: str) -> None:
    _STATS["rejects"][reason] = _STATS["rejects"].get(reason, 0) + 1


def note_fresh_compile() -> None:
    """An ``artifact_dir`` caller that ended up compiling (missing or
    rejected artifact)."""
    _STATS["fresh_compiles"] += 1


@functools.lru_cache(maxsize=None)
def _driver_version() -> Optional[int]:
    """The CUDA driver's version (``cuDriverGetVersion``), or None where
    no driver library loads."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        v = ctypes.c_int(0)
        if lib.cuDriverGetVersion(ctypes.byref(v)) != 0:
            return None
        return int(v.value)
    except OSError:
        return None


def runtime_fingerprint(device="cpu") -> dict:
    """What must match for an artifact compiled in another process to be
    trusted here: the torch build, the device it serves (name and compute
    capability, or ``"cpu"``), the card's driver and the kernel library's
    source digest."""
    from ..kernels import _build
    dev = torch.device(device)
    fp = {"torch": torch.__version__, "cuda": torch.version.cuda,
          "kernels": _build._digest(), "format": FORMAT_VERSION}
    if dev.type == "cuda":
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        fp["device"] = torch.cuda.get_device_name(idx)
        fp["capability"] = list(torch.cuda.get_device_capability(idx))
        fp["driver"] = _driver_version()
    else:
        fp["device"] = "cpu"
    return fp


# ---------------------------------------------------------------------------
# Save / load
# ---------------------------------------------------------------------------

def artifact_meta(program, *, opt_level: str, vlen: int = 128,
                  budget: Optional[FusionBudget] = None, hot_rows=None,
                  backend: str = "cuda", device="cpu") -> dict:
    """The identity an artifact is saved under and validated against at
    load: the compile-cache key rendered JSON-stable.  ``backend`` is
    informational (the payload is backend-agnostic IR); ``device`` selects
    the fingerprint's device."""
    budget = budget or FusionBudget()
    sig = hashlib.sha256(repr(program.signature()).encode()).hexdigest()
    return {"identity": {"signature_sha": sig,
                         "opt_level": opt_level,
                         "vlen": vlen,
                         "budget": repr(budget),
                         "hot_spec": _jsonable(canonical_hot(hot_rows))},
            "backend": backend,
            "device": str(torch.device(device)),
            "program": program.name}


def _jsonable(x):
    return json.loads(json.dumps(x))


def compile_key_of(program, meta: dict, *,
                   budget: Optional[FusionBudget] = None,
                   hot_rows=None) -> tuple:
    """The compile-cache key matching an artifact's identity (used to seed
    :mod:`repro_torch.core.pipeline`'s cache after a successful load)."""
    ident = meta["identity"]
    return compile_cache_key(program, ident["opt_level"],
                             vlen=ident["vlen"], budget=budget,
                             hot_rows=hot_rows)


def save_artifact(artifact_dir, compiled: ProgramCompileResult, *,
                  meta: dict) -> Path:
    """Atomically publish ``<artifact_dir>/current`` (the checkpoints'
    commit-marker protocol).  Re-saving overwrites: last writer wins, and
    a loader racing the publish window sees a torn state and compiles
    fresh."""
    from ..checkpoint.ckpt import publish_dir
    artifact_dir = Path(artifact_dir)
    artifact_dir.mkdir(parents=True, exist_ok=True)
    tmp = artifact_dir / f".tmp_current_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    full = {"format": FORMAT_VERSION,
            "fingerprint": runtime_fingerprint(meta.get("device", "cpu")),
            **meta}
    # a cache-hit flag inside the payload would lie to the next process
    payload = dataclasses.replace(compiled, cache_hit=False)
    _write_fsync(tmp / "meta.json", json.dumps(full, indent=1).encode())
    _write_fsync(tmp / "compile.pkl", pickle.dumps(payload))
    publish_dir(artifact_dir, tmp, artifact_dir / "current",
                artifact_dir / "current.COMMITTED")
    _STATS["saves"] += 1
    return artifact_dir / "current"


def _write_fsync(path: Path, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def load_artifact(artifact_dir, meta: dict
                  ) -> Optional[ProgramCompileResult]:
    """The committed artifact's ``ProgramCompileResult`` when it matches
    ``meta`` (from :func:`artifact_meta`) on this runtime, else None with
    the reject reason counted in :func:`artifact_stats`:

    * ``fingerprint`` -- torch / CUDA / device / driver / kernel-source skew
    * ``identity``    -- other program, opt_level, vlen, budget or hot spec
    * ``format``      -- the on-disk layout generation changed
    * ``torn``        -- a crash mid-publish (or a racing saver): the
      commit marker and the directory disagree
    * ``unpickle``    -- the compile payload does not deserialize here
    """
    d = Path(artifact_dir) / "current"
    marker = Path(artifact_dir) / "current.COMMITTED"
    if not marker.exists():
        return None                       # no artifact yet: not a reject
    try:
        raw = json.loads((d / "meta.json").read_text())
    except (OSError, json.JSONDecodeError):
        _reject("torn")
        return None
    if raw.get("format") != FORMAT_VERSION:
        _reject("format")
        return None
    if raw.get("fingerprint") != _jsonable(
            runtime_fingerprint(meta.get("device", "cpu"))):
        _reject("fingerprint")
        return None
    if raw.get("identity") != _jsonable(meta["identity"]):
        _reject("identity")
        return None
    try:
        compiled = pickle.loads((d / "compile.pkl").read_bytes())
    except OSError:
        _reject("torn")
        return None
    except Exception:   # noqa: BLE001 -- a version-skewed pickle, bad bytes
        _reject("unpickle")
        return None
    if not isinstance(compiled, ProgramCompileResult):
        _reject("unpickle")
        return None
    _STATS["loads"] += 1
    return compiled
