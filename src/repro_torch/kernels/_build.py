"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface, so they are compiled by ``nvcc`` alone
into one shared library and loaded with :mod:`ctypes` -- no PyTorch headers,
which keeps the build to seconds.  The library is built at first use (never
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
SOURCES = (CSRC / "ember_kernels.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

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
}


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


def _digest() -> str:
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildRecord:
    """Compile the sources unless a build of these exact sources exists."""
    out = BUILD_DIR / f"ember_kernels-{_digest()}.so"
    if out.exists():
        return BuildRecord(out, False, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc exited {r.returncode}:\n"
                               f"{' '.join(cmd)}\n{r.stderr[-8000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuildRecord(out, True, time.perf_counter() - t0,
                       r.stdout + r.stderr)


@functools.lru_cache(maxsize=None)
def _load() -> tuple:
    rec = build()
    lib = ctypes.CDLL(str(rec.path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
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
