"""The port's serving artifact (``core/artifact.py``) and the warm
artifact's durability, on the CPU, held port against port where the
reference asserts bit identity (artifact boot == fresh compile).

* round trip -- an ``executor_for(artifact_dir=...)`` boot saves the
  compile result; a later boot (caches cleared: a fresh process as far as
  the port is concerned) loads instead of compiling, with the same bits.
  Every reject (fingerprint skew, a changed kernel source, identity,
  format, a torn publish) falls back to a fresh compile that still
  serves.  The port has no serialized executables (the module docstring),
  so the reference's corrupt-AOT-blob case becomes the kernel-digest skew
  case;
* durability -- ``program.json`` publishes fsync-before-rename through the
  checkpoint tier's helper, and the meta/tables pair is never observed
  inconsistent;
* the disaggregated tier -- a killed replica's respawn boots from the
  artifact (``compile_source == "artifact"``), and the server's
  ``artifact_dir``.

The reference's sharded hot-slab round trip fails in the JAX package
(ROADMAP.md reference caveat (a): its AOT executable cache at a mesh
artifact boot); the port's runs over two gloo ranks and passes.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.convert import program_inputs_to_torch
from repro_torch.core import artifact as art
from repro_torch.core.executor import clear_executor_cache, executor_for
from repro_torch.core.ops import (EmbeddingOp, EmbeddingProgram,
                                  make_program_inputs)
from repro_torch.core.pipeline import (clear_compile_cache, compile_program,
                                       compile_cache_stats)
from repro_torch.launch.mesh import run_ranks
from repro_torch.runtime import embedding_service as es


def _program(name: str = "artifact_prog") -> EmbeddingProgram:
    sls = EmbeddingOp("sls", num_segments=8, num_embeddings=64, emb_len=16,
                      avg_lookups=4, weighted=True)
    gather = EmbeddingOp("gather", num_segments=6, num_embeddings=32,
                         emb_len=16, block_rows=2)
    return EmbeddingProgram(name, (("sls0", sls), ("g0", gather)))


def _inputs(prog, seed: int = 0) -> dict:
    return program_inputs_to_torch(make_program_inputs(prog, seed=seed),
                                   "cpu")


def _boot(artifact_dir, **kw):
    """One 'process boot': cleared executor and compile caches, then
    executor_for (which saves a fresh compile) and a first step."""
    clear_executor_cache()
    clear_compile_cache()
    prog = _program()
    ex = executor_for(prog, device="cpu", artifact_dir=artifact_dir, **kw)
    outs = ex.step(_inputs(prog))
    return ex, outs


def _assert_outputs_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# Round trip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_round_trip_loads_and_is_bit_identical(tmp_path, backend):
    art.reset_artifact_stats()
    ex, outs = _boot(tmp_path, backend=backend)
    assert ex.compile_source == "fresh"
    assert (tmp_path / "current.COMMITTED").exists()
    ex.save_artifact()                  # an idempotent re-publish

    ex2, outs2 = _boot(tmp_path, backend=backend)
    assert ex2.compile_source == "artifact"
    _assert_outputs_equal(outs, outs2)
    s = art.artifact_stats()
    assert s["saves"] == 2 and s["loads"] == 1
    assert s["fresh_compiles"] == 1 and s["rejects"] == {}
    # the loaded payload is the compile: same units, same access plans
    fresh = compile_program(_program(), "O3", use_cache=False)
    assert [u.names for u in ex2.compiled.units] == \
        [u.names for u in fresh.units]
    assert [repr(u.result.access_plan) for u in ex2.compiled.units] == \
        [repr(u.result.access_plan) for u in fresh.units]


def test_boot_save_alone_hydrates_compile_cache(tmp_path):
    """The boot-time save at executor_for alone lets a second boot skip the
    PassManager: it loads the payload and seeds the compile cache, so a
    later compile_program of the same identity is a cache hit."""
    art.reset_artifact_stats()
    clear_executor_cache()
    clear_compile_cache()
    prog = _program()
    executor_for(prog, device="cpu", artifact_dir=tmp_path)

    clear_executor_cache()
    clear_compile_cache()
    ex2 = executor_for(prog, device="cpu", artifact_dir=tmp_path)
    assert ex2.compile_source == "artifact"
    misses = compile_cache_stats()["misses"]
    again = compile_program(prog, "O3")
    assert again.cache_hit and compile_cache_stats()["misses"] == misses
    outs = ex2.step(_inputs(prog))
    assert set(outs) == {"sls0", "g0"}


# ---------------------------------------------------------------------------
# Invalidation: every reject falls back to a fresh compile that serves
# ---------------------------------------------------------------------------

def test_fingerprint_skew_rejects_and_counts(tmp_path):
    art.reset_artifact_stats()
    ex, outs = _boot(tmp_path)
    mp = tmp_path / "current" / "meta.json"
    raw = json.loads(mp.read_text())
    raw["fingerprint"]["torch"] = "0.0.0-skewed"
    mp.write_text(json.dumps(raw))

    ex2, outs2 = _boot(tmp_path)
    assert ex2.compile_source == "fresh"
    s = art.artifact_stats()
    assert s["rejects"].get("fingerprint") == 1
    assert s["fresh_compiles"] == 2              # the runbook counter
    _assert_outputs_equal(outs, outs2)


def test_identity_mismatch_rejects(tmp_path):
    art.reset_artifact_stats()
    _boot(tmp_path)
    # same program, another opt_level: another compile identity
    ex2, _ = _boot(tmp_path, opt_level="O2")
    assert ex2.compile_source == "fresh"
    assert art.artifact_stats()["rejects"].get("identity") == 1


def test_format_bump_rejects(tmp_path):
    art.reset_artifact_stats()
    _boot(tmp_path)
    mp = tmp_path / "current" / "meta.json"
    raw = json.loads(mp.read_text())
    raw["format"] = art.FORMAT_VERSION + 1
    mp.write_text(json.dumps(raw))
    ex2, _ = _boot(tmp_path)
    assert ex2.compile_source == "fresh"
    assert art.artifact_stats()["rejects"].get("format") == 1


def test_torn_publish_rejects_and_serves_fresh(tmp_path):
    """Commit marker present but the directory's contents gone: the crash
    window publish_dir leaves when dying between rename and marker."""
    art.reset_artifact_stats()
    ex, outs = _boot(tmp_path)
    (tmp_path / "current" / "meta.json").unlink()

    ex2, outs2 = _boot(tmp_path)
    assert ex2.compile_source == "fresh"
    assert art.artifact_stats()["rejects"].get("torn") == 1
    _assert_outputs_equal(outs, outs2)


def test_kernel_digest_skew_rejects_and_compiles_fresh(tmp_path,
                                                       monkeypatch):
    """An artifact saved beside other kernel sources (the library's source
    digest differs) is a ``fingerprint`` reject, never a partial load: the
    boot compiles fresh, serves the same bits, and re-saves under the new
    digest, which the next boot loads."""
    from repro_torch.kernels import _build
    art.reset_artifact_stats()
    ex, outs = _boot(tmp_path)
    real = _build._digest()
    monkeypatch.setattr(_build, "_digest", lambda: "0" * len(real))

    ex2, outs2 = _boot(tmp_path)
    assert ex2.compile_source == "fresh"
    assert art.artifact_stats()["rejects"] == {"fingerprint": 1}
    _assert_outputs_equal(outs, outs2)
    meta = json.loads((tmp_path / "current" / "meta.json").read_text())
    assert meta["fingerprint"]["kernels"] == "0" * len(real)
    ex3, outs3 = _boot(tmp_path)
    assert ex3.compile_source == "artifact"
    _assert_outputs_equal(outs, outs3)


def test_fingerprint_is_the_ports_runtime():
    fp = art.runtime_fingerprint("cpu")
    from repro_torch.kernels import _build
    assert fp == {"torch": torch.__version__, "cuda": torch.version.cuda,
                  "kernels": _build._digest(),
                  "format": art.FORMAT_VERSION, "device": "cpu"}


def _sharded_round_trip(rank: int, world: int, td: str) -> dict:
    """One rank's boots over a 2-wide mesh with a hot slab: fresh, from
    the artifact, then another hot spec (another identity)."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(world, device="cpu")
    prog = EmbeddingProgram("mesh_prog", (
        ("a", EmbeddingOp("sls", 5, 9, 8, avg_lookups=3, weighted=True)),
        ("g", EmbeddingOp("gather", 6, 20, 8)),
    ))
    ins = program_inputs_to_torch(make_program_inputs(prog, seed=0), "cpu")
    # each rank its own artifact directory: ranks boot concurrently
    adir = os.path.join(td, f"rank{rank}")

    def boot(hot_rows):
        clear_executor_cache()
        clear_compile_cache()
        ex = executor_for(prog, "O3", vlen=4, device="cpu", mesh=mesh,
                          hot_rows=hot_rows, artifact_dir=adir)
        outs = ex.full_outputs(ex.step(ins))
        return ex, {k: v.numpy() for k, v in outs.items()}

    art.reset_artifact_stats()
    ex, outs = boot({"a": (0, 1)})
    ex2, outs2 = boot({"a": (0, 1)})
    ex3, _ = boot({"a": (0, 2)})
    return {"sources": [ex.compile_source, ex2.compile_source,
                        ex3.compile_source],
            "shards": ex2.shards, "outs": outs, "outs2": outs2,
            "rejects": art.artifact_stats()["rejects"]}


def test_round_trip_sharded_with_hot_slab(tmp_path):
    """A 2-rank mesh and a hot slab: the artifact round-trips under sharded
    execution with the same bits, and another hot spec is another identity
    (a fresh compile), since the hot split changes the AccessPlan.  (The
    reference's own case fails: ROADMAP.md reference caveat (a).)"""
    for res in run_ranks(_sharded_round_trip, 2, (str(tmp_path),)):
        assert res["sources"] == ["fresh", "artifact", "fresh"]
        assert res["shards"] == 2
        assert res["rejects"].get("identity", 0) >= 1
        for k in res["outs"]:
            np.testing.assert_array_equal(res["outs"][k], res["outs2"][k])


# ---------------------------------------------------------------------------
# program.json publishes durably through the checkpoint tier's helper
# ---------------------------------------------------------------------------

def test_atomic_write_text_fsyncs_data_and_directory(tmp_path, monkeypatch):
    """The tmp file is fsynced before the rename and the directory after:
    the two syncs a bare write_text + rename skips."""
    from repro_torch.checkpoint import atomic_write_text
    count = {"n": 0}
    real = os.fsync

    def counting(fd):
        count["n"] += 1
        return real(fd)

    monkeypatch.setattr(os, "fsync", counting)
    atomic_write_text(tmp_path / "program.json", "{\"v\": 1}")
    assert json.loads((tmp_path / "program.json").read_text()) == {"v": 1}
    assert count["n"] >= 2, "missing data fsync or directory fsync"
    assert not list(tmp_path.glob(".*tmp*")), "tmp file left behind"


def test_warm_meta_routes_through_durable_publish(tmp_path, monkeypatch):
    """Both program.json writers -- ``write_warm_artifact`` and the pool's
    ``publish_hot_spec`` -- go through the checkpoint tier's
    ``atomic_write_text``, not a private rename."""
    import repro_torch.checkpoint as ckpt
    calls = []
    real = ckpt.atomic_write_text

    def spy(path, text):
        calls.append(Path(path).name)
        return real(path, text)

    monkeypatch.setattr(ckpt, "atomic_write_text", spy)
    meta, tables = _warm_fixture()
    es.write_warm_artifact(tmp_path, meta, tables, 1)
    assert calls == ["program.json"]

    pool = SimpleNamespace(_bind_call=(meta, tables), warm_dir=tmp_path,
                           pool_stats={"hot_publishes": 0},
                           _broadcast=lambda *a, **k: None,
                           _table_version=1)
    es.ServicePool.publish_hot_spec(pool, {"sls0": (1, 3)})
    assert calls == ["program.json", "program.json"]
    republished = json.loads((tmp_path / "program.json").read_text())
    assert republished["hot_spec"] == {"sls0": [1, 3]}
    assert republished["table_step"] == 1     # still the committed step


# ---------------------------------------------------------------------------
# The meta/tables pair is never observed inconsistent
# ---------------------------------------------------------------------------

def _warm_fixture(seed: int = 0):
    prog = _program("warm_prog")
    meta = {"program": es.program_to_spec(prog), "opt_level": "O3",
            "vlen": 128, "backend": "torch", "index_policy": "strict",
            "device": "cpu", "table_ops": ["g0", "sls0"],
            "hot_spec": None, "hot_epoch": 0}
    rng = np.random.default_rng(seed)
    tables = {"sls0": torch.from_numpy(
                  rng.standard_normal((64, 16)).astype(np.float32)),
              "g0": torch.from_numpy(
                  rng.standard_normal((32, 16)).astype(np.float32))}
    return meta, tables


def test_tables_commit_before_meta_publishes(tmp_path, monkeypatch):
    """The write order: when the table checkpoint fails, the published
    program.json survives untouched (meta first would leave a new meta
    naming tables that never committed)."""
    import repro_torch.checkpoint as ckpt
    meta, tables = _warm_fixture()
    es.write_warm_artifact(tmp_path, meta, tables, 1)
    got = es.read_warm_artifact(tmp_path)
    assert got is not None and got[0]["table_step"] == 1

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save_checkpoint", boom)
    meta2 = dict(meta)
    meta2["hot_epoch"] = 7
    with pytest.raises(OSError):
        es.write_warm_artifact(tmp_path, meta2, tables, 2)
    got = es.read_warm_artifact(tmp_path)
    assert got is not None, "consistent pair lost on failed update"
    assert got[0]["table_step"] == 1
    assert got[0]["hot_epoch"] == 0, "uncommitted meta became visible"


def test_meta_referencing_uncommitted_step_is_rejected(tmp_path):
    """A meta stamped with a step the checkpoint tier never committed reads
    as no artifact: the replica waits for a bind instead of warming
    inconsistent."""
    meta, tables = _warm_fixture()
    es.write_warm_artifact(tmp_path, meta, tables, 1)
    pj = tmp_path / "program.json"
    m = json.loads(pj.read_text())
    m["table_step"] = 99
    pj.write_text(json.dumps(m))
    assert es.read_warm_artifact(tmp_path) is None


def test_tables_ahead_of_meta_restores_stamped_pair(tmp_path):
    """A crash between the table commit and the meta publish: the reader
    restores the step the surviving meta stamps, not the newer orphaned
    tables."""
    from repro_torch.checkpoint import save_checkpoint
    meta, tables = _warm_fixture()
    es.write_warm_artifact(tmp_path, meta, tables, 1)
    _, newer = _warm_fixture(seed=9)
    save_checkpoint(tmp_path / "tables", 2, dict(newer))

    got = es.read_warm_artifact(tmp_path)
    assert got is not None
    got_meta, got_tables = got
    assert got_meta["table_step"] == 1
    assert torch.equal(got_tables["sls0"], tables["sls0"])


def test_legacy_meta_without_stamp_reads_latest_committed(tmp_path):
    """A program.json without the stamp still warms, best effort, from the
    latest committed step."""
    meta, tables = _warm_fixture()
    es.write_warm_artifact(tmp_path, meta, tables, 3)
    pj = tmp_path / "program.json"
    m = json.loads(pj.read_text())
    del m["table_step"]
    pj.write_text(json.dumps(m))
    got = es.read_warm_artifact(tmp_path)
    assert got is not None
    assert torch.equal(got[1]["sls0"], tables["sls0"])


def test_table_step_retention_keeps_superseded_pair(tmp_path):
    """Keep-2 pruning: after N publishes the step the *previous* meta names
    is still restorable."""
    from repro_torch.checkpoint import committed_steps
    meta, tables = _warm_fixture()
    for v in (1, 2, 3, 4):
        es.write_warm_artifact(tmp_path, meta, tables, v)
    assert committed_steps(tmp_path / "tables") == [3, 4]


def test_a_shared_bf16_table_is_written_once(tmp_path):
    """Two ops on one bf16 table (an LM's embed): one member in the
    checkpoint, the alias in the meta, one object back with the same
    bits."""
    meta, _ = _warm_fixture()
    embed = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 16)).astype(np.float32)).bfloat16()
    es.write_warm_artifact(tmp_path, meta, {"sls0": embed, "g0": embed}, 1)
    got_meta, got = es.read_warm_artifact(tmp_path)
    assert got_meta["table_alias"] == {"g0": "sls0"}
    assert got["g0"] is got["sls0"] and got["g0"].dtype == torch.bfloat16
    assert torch.equal(got["sls0"], embed)
    manifest = json.loads((tmp_path / "tables" / "step_000000001" /
                           "manifest.json").read_text())
    assert len(manifest["leaves"]) == 1


# ---------------------------------------------------------------------------
# Disaggregated tier: the respawn boots from the artifact
# ---------------------------------------------------------------------------

def test_respawned_replica_skips_recompilation():
    """Kill a replica; the respawned process reports BOTH
    ``warm_source == "artifact"`` (tables from the checkpoint) and
    ``compile_source == "artifact"`` (the program from the serving
    artifact an earlier life saved)."""
    prog = _program("disagg_aot")
    ins = _inputs(prog, 5)
    ref = executor_for(prog, device="cpu").step(ins)
    with es.ServicePool(2, device="cpu", rpc_timeout_s=30.0,
                        backoff_s=0.01) as pool:
        ex = executor_for(prog, device="cpu", service="disagg",
                          service_pool=pool)
        _assert_outputs_equal(ref, ex.step(ins))

        victim = next(i for i, r in enumerate(pool.replicas)
                      if r.state == "live")
        pool.kill_replica(victim)
        for _ in range(4):              # failover keeps serving
            _assert_outputs_equal(ref, ex.step(ins))

        t0 = time.perf_counter()
        while pool.replicas[victim].state != "live":
            pool.heartbeat_once()
            time.sleep(0.05)
            assert time.perf_counter() - t0 < 120, "revive timed out"
        s = pool.stats()
        assert s["respawns"] >= 1
        assert s["warm_sources"][-1] == "artifact"
        assert s["compile_sources"][-1] == "artifact", \
            "respawned replica recompiled instead of loading the artifact"
        for _ in range(3):              # the loaded program serves
            _assert_outputs_equal(ref, ex.step(ins))


# ---------------------------------------------------------------------------
# DecodeServer wiring
# ---------------------------------------------------------------------------

def test_decode_server_boots_from_artifact(tmp_path):
    """``artifact_dir`` end to end: the first server compiles and saves,
    the second boots with compile_source == "artifact", shows the stats
    under compile_stats["artifact"], and emits the same tokens."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.lm import LM
    from repro_torch.runtime.server import DecodeServer, Request
    lm = LM(get_reduced("zamba2-7b"), device="cpu", seed=0)

    def serve_once():
        clear_executor_cache()
        clear_compile_cache()
        srv = DecodeServer(lm, batch_slots=2, max_len=16,
                           artifact_dir=str(tmp_path))
        r = Request(prompt=np.arange(4, dtype=np.int32), max_new_tokens=2)
        srv.submit(r)
        srv.run_until_drained()
        assert r.done and r.status == "ok"
        return srv, r.out

    art.reset_artifact_stats()
    srv, out = serve_once()
    assert srv.compile_stats["artifact"]["compile_source"] == "fresh"
    srv2, out2 = serve_once()
    a = srv2.compile_stats["artifact"]
    assert a["compile_source"] == "artifact" and a["loads"] == 1
    # saved at the first boot's build, then after each boot's first wave
    assert a["saves"] == 3 and a["rejects"] == {}
    assert out2 == out
