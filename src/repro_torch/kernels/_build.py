"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface, so they are compiled by ``nvcc`` alone
-- one ``nvcc`` per source, all started together, then one link -- into one
shared library loaded with :mod:`ctypes`.  No PyTorch headers, which keeps
the build to seconds.  The library is built at first use (never
at import) into ``build/kernels/`` at the root of the checkout, named by a
hash of the sources and flags: a changed source builds anew, an unchanged one
loads the earlier build.  Each build is written under a temporary name and
renamed into place, so two processes that build at once cannot leave a torn
file behind.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "ember_kernels.cu", CSRC / "ember_fusedmm.cu",
           CSRC / "ember_flash_attention.cu")
HEADERS = (CSRC / "ember_common.cuh", CSRC / "ember_hopper.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_SIGNATURES = {
    # table, ptrs, idxs, weights, seg_base, out, num_segments, emb_len,
    # dtype, add_op, mul_op, vec, threads_per_row, rows_per_block, stream
    "ember_sls": (_P, _P, _P, _P, _P, _P, _I64, _I64,
                  _I32, _I32, _I32, _I32, _I32, _I32, _P),
    # table, idxs, roff, out, num_blocks, block_rows, row_bytes,
    # unit_bytes, threads_per_row, rows_per_block, stream
    "ember_block_gather": (_P, _P, _P, _P, _I64, _I64, _I64,
                           _I32, _I32, _I32, _P),
    # num_blocks -> bytes of the bulk gather's grouping scratch
    "ember_gather_scratch_bytes": (_I64,),
    # idxs, roff, scratch, num_blocks, stream
    "ember_gather_group": (_P, _P, _P, _I64, _P),
    # table, out, scratch, num_blocks, block_bytes, stream
    "ember_block_gather_bulk": (_P, _P, _P, _I64, _I64, _P),
    # x, ptrs, idxs, out, num_segments, emb_len, dtype, fn, vec,
    # threads_per_row, rows_per_block, stream
    "ember_fusedmm": (_P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32,
                      _I32, _I32, _P),
    # x, ptrs, idxs, out, num_segments, emb_len, dtype, fn, stream
    "ember_fusedmm_ring": (_P, _P, _P, _P, _I64, _I64, _I32, _I32, _P),
    # q, k, v, o, batch, seq_q, seq_k, heads, kv_heads, head_dim,
    # v_head_dim, dtype, causal, scale, stream
    "ember_flash_attention": (_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                              _I32, _I32, _I32, _I32, ctypes.c_double, _P),
    # dtype -> the flash kernel's KV tile
    "ember_flash_kv_tile": (_I32,),
}

#: entry points that return something other than a cudaError_t
_RESTYPES = {"ember_gather_scratch_bytes": _I64}


@dataclasses.dataclass(frozen=True)
class BuildRecord:
    path: Path
    built: bool          # False: an earlier build of the same sources loaded
    seconds: float       # nvcc wall time (0.0 when loaded)
    log: str             # nvcc / ptxas output (register and spill counts)


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the toolkit's default
    install, or the one on ``PATH``."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand is not None and cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def cuobjdump() -> str:
    """``cuobjdump`` (for ``-sass``): beside :func:`nvcc`, or the copy that
    Triton's package carries."""
    cand = Path(nvcc()).parent / "cuobjdump"
    if cand.exists():
        return str(cand)
    import importlib.util
    spec = importlib.util.find_spec("triton")
    for loc in (spec.submodule_search_locations or []) if spec else []:
        cand = Path(loc) / "backends" / "nvidia" / "bin" / "cuobjdump"
        if cand.exists():
            return str(cand)
    raise RuntimeError("cuobjdump not found beside nvcc or in triton")


def _digest() -> str:
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildRecord:
    """Compile the sources unless a build of these exact sources exists:
    one ``nvcc -c`` per source, run in parallel, then one link."""
    out = BUILD_DIR / f"ember_kernels-{_digest()}.so"
    if out.exists():
        return BuildRecord(out, False, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / (src.stem + ".o") for src in SOURCES]
        procs = [(src, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src, obj in zip(SOURCES, objs)]
        logs, failed = [], []
        for src, proc in procs:
            text = proc.communicate()[0]
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(f"nvcc exited {proc.returncode} on {src.name}:"
                              f"\n{text[-8000:]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = Path(tmpdir) / out.name
        r = subprocess.run([nvcc(), "-shared", "-o", str(lib),
                            *map(str, objs)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link exited {r.returncode}:\n"
                               f"{r.stderr[-8000:]}")
        os.replace(lib, out)
    return BuildRecord(out, True, time.perf_counter() - t0, "".join(logs))


@functools.lru_cache(maxsize=None)
def _load() -> tuple:
    rec = build()
    lib = ctypes.CDLL(str(rec.path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    lib.ember_error_string.argtypes = (ctypes.c_int,)
    lib.ember_error_string.restype = ctypes.c_char_p
    return lib, rec


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    return _load()[0]


def build_record() -> BuildRecord:
    """How this process got the library: built now, or loaded."""
    return _load()[1]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        name = library().ember_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: cudaError_t {err} "
                           f"({name})")
