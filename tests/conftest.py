"""Shared test plumbing: the ``--fast`` smoke switch and the forced
2-device subprocess runner.

``--fast`` (wired through ``scripts/tier1.sh --fast``) shrinks the
generated-case counts of the differential harness to a smoke subset, the
same way tier1.sh gates the benchmark smokes; the full ``pytest`` run (the
ROADMAP tier-1 command) keeps the ≥200-case sweep.

``run_on_mesh`` is the single home of the respawn/env-forcing logic that
used to be duplicated across ``tests/test_sharded_executor.py``,
``benchmarks/bench_sharded.py`` and ``benchmarks/bench_locality.py`` (the
benches share :mod:`benchmarks._mesh`): it executes a code snippet in a
subprocess whose copied environment forces an N-device CPU platform, skips
(not fails) when the forced count cannot be honored, and never mutates the
calling process's environment.
"""
from __future__ import annotations

import os
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

# make benchmarks._mesh (and the benchmarks package generally) importable
# from tests without installing the repo
sys.path.insert(0, str(REPO))

from benchmarks._mesh import (MESH_SKIP, forced_device_env,  # noqa: E402
                              run_with_spawn_retry)


def pytest_addoption(parser):
    parser.addoption(
        "--fast", action="store_true", default=False,
        help="smoke subset of the generated differential cases "
             "(tier1.sh --fast); the full run sweeps >=200 cases")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips (with its reason) "
                   "where there is none")
    # hypothesis example counts follow the same --fast gate (loaded before
    # collection, so @settings decorators inherit the profile's
    # max_examples); tests that pin max_examples explicitly are unaffected
    try:
        from hypothesis import settings
    except ImportError:
        return
    settings.register_profile("diff-full", max_examples=20)
    settings.register_profile("diff-fast", max_examples=5)
    settings.load_profile(
        "diff-fast" if config.getoption("--fast") else "diff-full")


@pytest.fixture(scope="session")
def fast_mode(request) -> bool:
    return bool(request.config.getoption("--fast"))


# one implementation of the skip protocol: the child calls
# benchmarks._mesh.require_devices, which prints the MESH_SKIP sentinel
# this fixture matches on (the repo root is on the child's PYTHONPATH)
_PREAMBLE = """
from benchmarks._mesh import require_devices
if not require_devices({devices}):
    raise SystemExit(0)
"""


@pytest.fixture
def run_on_mesh():
    """Run ``code`` in a subprocess with a forced ``devices``-wide CPU
    platform.  The child first verifies the forced count took effect and
    prints the ``MESH_SKIP`` sentinel otherwise, which this fixture turns
    into ``pytest.skip`` — an environment that can't honor the mesh is not
    a failure.  Returns the completed process (stdout checked by caller)."""

    def run(code: str, devices: int = 2, timeout: int = 900,
            sentinel: str = None):
        body = _PREAMBLE.format(devices=devices) + textwrap.dedent(code)
        env = forced_device_env(devices)
        env["PYTHONPATH"] = "src" + os.pathsep + str(REPO) + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        # bounded spawn retry: a loaded CI host transiently failing the
        # fork/exec (or OOM-killing the child before it runs) should not
        # flake the 2-device job; real test failures never retry
        r = run_with_spawn_retry([sys.executable, "-c", body],
                                 capture_output=True, text=True, env=env,
                                 cwd=str(REPO), timeout=timeout)
        if MESH_SKIP in r.stdout:
            pytest.skip(f"forced {devices}-device CPU mesh not honored: "
                        f"{r.stdout.strip().splitlines()[-1]}")
        if sentinel is not None:
            assert sentinel in r.stdout, \
                (r.stdout[-2000:] + "\n" + r.stderr[-4000:])
        return r

    return run
