"""The port's disaggregated embedding tier on the CPU: transport, failover,
re-warm, degrade, held port against port where the reference asserts bit
identity (disagg == in-process), and against the JAX package where both
packages compute the same thing (the backoff lists, the program spec, the
outputs of the reference's in-process executor on the same seeded
inputs).

Every replica here runs on the CPU (``ServicePool(device="cpu")``: the
kernels' plain versions) with one torch thread.  The module-scoped pool
serves most end-to-end tests; the dark-pool tests spawn their own
one-replica pools (they kill them).  Every pool is closed by its ``with``
or its fixture.
"""
from __future__ import annotations

import os
import socket
import time

import numpy as np
import pytest
import torch

from repro.core import ops as jops
from repro.core.executor import executor_for as jexecutor_for
from repro.runtime import embedding_service as jes
from repro.runtime import rpc as jrpc
from repro_torch.convert import program_inputs_to_torch
from repro_torch.core import ops as tops
from repro_torch.core.executor import ProgramExecutor, executor_for
from repro_torch.core.ops import (EmbeddingOp, EmbeddingProgram,
                                  make_program_inputs, single_op_program)
from repro_torch.core.pipeline import compile_program
from repro_torch.data.locality import AdaptiveHotConfig
from repro_torch.runtime.embedding_service import (ServicePool,
                                                   program_to_spec,
                                                   spec_to_program)
from repro_torch.runtime.faults import (FaultInjector, FaultSpec,
                                        InjectedFailure, RpcError,
                                        RpcTimeout, ServiceUnavailable)
from repro_torch.runtime.rpc import (RpcClient, backoff_delays, frame_bytes,
                                     raise_typed, recv_msg, send_msg)

BACKOFF = dict(device="cpu", rpc_timeout_s=30.0, backoff_s=0.01)
TOL = dict(rtol=2e-5, atol=2e-5)
REVIVE_S = 120


def _program(m=None) -> EmbeddingProgram:
    """The two-op program, built from the port's ops or ``m``'s."""
    op = m.EmbeddingOp if m is not None else EmbeddingOp
    prog = m.EmbeddingProgram if m is not None else EmbeddingProgram
    sls = op("sls", num_segments=8, num_embeddings=64, emb_len=16,
             avg_lookups=4, weighted=True)
    gather = op("gather", num_segments=6, num_embeddings=32, emb_len=16,
                block_rows=2)
    return prog("disagg_prog", (("sls0", sls), ("g0", gather)))


def _sls_program(name: str) -> EmbeddingProgram:
    return single_op_program(
        EmbeddingOp("sls", num_segments=4, num_embeddings=32, emb_len=8,
                    avg_lookups=2), name)


def _inputs(prog, seed: int) -> dict:
    """Seeded inputs with the tables as CPU tensors (one object each, so a
    steady feed never re-ships them)."""
    return program_inputs_to_torch(make_program_inputs(prog, seed=seed),
                                   "cpu")


def _assert_outputs_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].device == b[k].device
        assert torch.equal(a[k], b[k]), k


def _revive(pool, idx: int) -> None:
    t0 = time.perf_counter()
    while pool.replicas[idx].state != "live":
        pool.heartbeat_once()
        time.sleep(0.05)
        assert time.perf_counter() - t0 < REVIVE_S, "revive timed out"


@pytest.fixture(scope="module")
def pool():
    with ServicePool(2, **BACKOFF) as p:
        yield p


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

def test_framing_roundtrip_bit_identical():
    """numpy arrays arrive as numpy, CPU tensors as tensors (bf16 by its
    bits), each with its dtype and bits; a tensor under two keys travels
    once and arrives as one object."""
    a, b = socket.socketpair()
    rng = np.random.default_rng(0)
    shared = torch.from_numpy(rng.normal(size=(5, 4)).astype(np.float32))
    arrays = {"f32": rng.normal(size=(7, 3)).astype(np.float32),
              "i32": np.arange(11, dtype=np.int32),
              "i64": np.arange(5, dtype=np.int64) * -3,
              "empty": np.zeros((0,), np.int32),
              "t_f32": torch.from_numpy(rng.normal(size=(3, 2))
                                        .astype(np.float32)),
              "t_bf16": torch.from_numpy(rng.normal(size=(6, 5))
                                         .astype(np.float32)).bfloat16(),
              "t_empty_bf16": torch.zeros((0, 3), dtype=torch.bfloat16),
              "a": shared, "b": shared}
    send_msg(a, "step", {"seq": 42, "client": "c1"}, arrays)
    kind, meta, out = recv_msg(b, deadline_s=5.0)
    assert kind == "step" and meta == {"seq": 42, "client": "c1"}
    assert set(out) == set(arrays)
    for k, want in arrays.items():
        got = out[k]
        if isinstance(want, np.ndarray):
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        else:
            assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
            assert got.shape == want.shape and torch.equal(got, want)
    assert out["a"] is out["b"]
    # the shared tensor's bytes are on the wire once
    single = frame_bytes("x", {}, {"a": shared})
    assert frame_bytes("x", {}, {"a": shared, "b": shared}) < \
        single + shared.numel() * 4
    a.close(), b.close()


def test_recv_deadline_lapses_typed():
    a, b = socket.socketpair()
    t0 = time.perf_counter()
    with pytest.raises(RpcTimeout):
        recv_msg(b, deadline_s=0.2)
    assert time.perf_counter() - t0 < 5.0
    # a partial frame (header promised, body never sent) times out too:
    # the deadline spans partial reads, it is not per chunk
    send_msg(a, "step", {"n": 1}, None)
    a.send(b"EMB1")                     # start of a frame that never ends
    recv_msg(b, deadline_s=5.0)         # the complete frame drains fine
    with pytest.raises(RpcTimeout):
        recv_msg(b, deadline_s=0.2)
    a.close(), b.close()


def test_closed_connection_is_typed_rpc_error():
    a, b = socket.socketpair()
    a.close()
    with pytest.raises(RpcError):
        recv_msg(b, deadline_s=5.0)
    b.close()


def test_backoff_matches_spawn_retry_shape():
    assert list(backoff_delays(4, 0.5)) == [0.0, 0.5, 1.0, 2.0]
    assert list(backoff_delays(1, 0.5)) == [0.0]
    for n, b in ((1, 0.5), (4, 0.5), (6, 0.01), (3, 2.0)):
        assert list(backoff_delays(n, b)) == list(jrpc.backoff_delays(n, b))


def test_raise_typed_preserves_class_and_degrades_multiarg():
    with pytest.raises(InjectedFailure):
        raise_typed({"error": "InjectedFailure", "msg": "boom"})
    # MalformedAccessError's 3-arg constructor can't rebuild from one
    # message: it degrades to the base fault with the name kept
    with pytest.raises(Exception, match="MalformedAccessError"):
        raise_typed({"error": "MalformedAccessError", "msg": "bad ptrs"})


def test_program_spec_roundtrip():
    """Round trip in the port, and the reference's spec JSON read by the
    port gives an equal program (and back)."""
    import json
    prog = _program()
    back = spec_to_program(program_to_spec(prog))
    assert back.signature() == prog.signature()
    assert back.name == prog.name
    for m in (jops, tops):
        built = m.EmbeddingProgram("disagg_prog", (
            ("sls0", m.EmbeddingOp("sls", 8, 64, 16, avg_lookups=4,
                                   weighted=True)),
            ("g0", m.EmbeddingOp("gather", 6, 32, 16, block_rows=2)),
            ("g1", m.EmbeddingOp("gather", 6, 32, 16, block_rows=2)),
            ("mx", m.EmbeddingOp("sls", 3, 9, 5, avg_lookups=2,
                                 semiring=m.Semiring("max")))),
            shared_tables=(("g0", "g1"),))
        if m is jops:
            spec = json.loads(json.dumps(jes.program_to_spec(built)))
    ported = spec_to_program(spec)
    assert ported.name == built.name
    assert ported.signature() == built.signature()
    assert program_to_spec(ported) == spec


# ---------------------------------------------------------------------------
# End to end: bit identity, replay, failover, re-warm
# ---------------------------------------------------------------------------

def test_disagg_bit_identical_to_inproc(pool):
    prog = _program()
    ins = _inputs(prog, 3)
    ref = executor_for(prog, device="cpu").run_steps([ins] * 3)
    ex = executor_for(prog, device="cpu", service="disagg",
                      service_pool=pool)
    out = ex.run_steps([ins] * 3)
    for r, o in zip(ref, out):
        _assert_outputs_equal(r, o)
    assert ex.stats["rpc_steps"] == 3 and ex.stats["table_stacks"] == 1
    assert ex.stats["table_rebinds"] == 0       # tables shipped once


def test_disagg_matches_the_references_inproc_executor(pool):
    """The replicas' outputs (plain versions) against the JAX package's
    in-process executor on the same seeded inputs: the gather exact, the
    f32 SLS within 2e-5."""
    jprog = _program(jops)
    host = jops.make_program_inputs(jprog, seed=11)
    want = jexecutor_for(jprog, backend="jax").step(host)
    ex = executor_for(_program(), device="cpu", service="disagg",
                      service_pool=pool)
    got = ex.step(program_inputs_to_torch(host, "cpu"))
    np.testing.assert_array_equal(got["g0"].numpy(), np.asarray(want["g0"]))
    np.testing.assert_allclose(got["sls0"].numpy(),
                               np.asarray(want["sls0"]), **TOL)


def test_bf16_tables_travel_by_their_bits():
    """A bf16 table is shipped as its bits, and the replica's bf16 output
    comes back as the in-process executor's dtype and bits.  (Its own
    pool: a pool serves the program bound last.)"""
    prog = EmbeddingProgram("bf16_prog", (
        ("sls0", EmbeddingOp("sls", 8, 64, 16, avg_lookups=4)),
        ("g0", EmbeddingOp("gather", 6, 32, 16, block_rows=2))))
    ins = _inputs(prog, 12)
    for n in ins:
        ins[n]["table"] = ins[n]["table"].bfloat16()
    ref = executor_for(prog, device="cpu").step(ins)
    with ServicePool(1, **BACKOFF) as pool:
        got = executor_for(prog, device="cpu", service="disagg",
                           service_pool=pool).step(ins)
    _assert_outputs_equal(ref, got)
    assert got["g0"].dtype == torch.bfloat16


def test_step_replay_is_idempotent(pool):
    """Re-sending an already-executed sequence number (the lost-reply retry
    shape) returns the cached reply without running the step again."""
    prog = _program()
    ins = _inputs(prog, 4)
    ex = executor_for(prog, device="cpu", service="disagg",
                      service_pool=pool)
    ex.step(ins)                        # makes sure the tables are bound
    r = next(r for r in pool.replicas if r.state == "live")
    cli = RpcClient("127.0.0.1", r.port, timeout_s=30.0)
    streams = {}
    for name, op in prog.ops:
        tkey = "x" if op.kind == "fusedmm" else "table"
        streams.update({f"{name}/{k}": np.asarray(v)
                        for k, v in ins[name].items() if k != tkey})
    meta = {"client": "replay-test", "seq": 1}
    m1, out1 = cli.call("step", meta, streams)
    steps_after_first = m1["steps"]
    m2, out2 = cli.call("step", meta, streams)     # same seq: replayed
    _assert_outputs_equal(out1, out2)
    ping, _ = cli.call("ping")
    assert ping["replays"] >= 1
    assert ping["steps"] == steps_after_first + 1  # did NOT run again
    # a stale (lower) seq is a typed protocol error, not silence
    cli.call("step", {"client": "replay-test", "seq": 2}, streams)
    with pytest.raises(RpcError, match="stale"):
        cli.call("step", meta, streams)
    cli.close()


def test_replica_ping_reports_its_device_and_launches(pool):
    """A replica's ping: its device, its kernel launches by variant (the
    plain versions count none), its peak device memory, and no module of
    the JAX package or of JAX in its process."""
    prog = _program()
    executor_for(prog, device="cpu", service="disagg",
                 service_pool=pool).step(_inputs(prog, 5))
    for r in pool.replicas:
        ping, _ = r.hb.call("ping")
        assert ping["device"] == "cpu" and ping["peak_bytes"] == 0
        assert ping["foreign_modules"] == []
        assert set(ping["variant_launches"]) >= {"sls", "block_gather"}
        assert ping["launches"]["block_gather"] == 0


def test_kill_replica_fails_over_and_rewarms(pool):
    """SIGKILL one replica mid-traffic: steps keep answering through the
    live peer (bounded retry, zero failures), the circuit opens, and the
    respawned replica re-warms from the checkpoint artifact -- never a
    re-bind RPC."""
    prog = _program()
    ins = _inputs(prog, 5)
    ref = executor_for(prog, device="cpu").step(ins)
    ex = executor_for(prog, device="cpu", service="disagg",
                      service_pool=pool)
    _assert_outputs_equal(ref, ex.step(ins))

    victim = next(i for i, r in enumerate(pool.replicas)
                  if r.state == "live")
    pool.kill_replica(victim)
    for _ in range(4):                  # round-robin hits the corpse
        _assert_outputs_equal(ref, ex.step(ins))
    assert pool.stats()["breaker_open"] >= 1

    _revive(pool, victim)
    s = pool.stats()
    assert s["respawns"] >= 1
    assert s["warm_sources"][-1] == "artifact"     # re-warmed, not re-bound
    assert s["recoveries_s"], "recovery time not recorded"
    for _ in range(3):                  # the revived replica serves
        _assert_outputs_equal(ref, ex.step(ins))


# ---------------------------------------------------------------------------
# Degradation while every replica is dark
# ---------------------------------------------------------------------------

def _dark_pool():
    return ServicePool(1, auto_respawn=False, **BACKOFF)


def test_dark_pool_degrade_fail_is_typed():
    prog = _sls_program("s")
    ins = _inputs(prog, 6)
    with _dark_pool() as pool:
        ex = executor_for(prog, device="cpu", service="disagg",
                          service_pool=pool)
        ex.step(ins)
        pool.kill_replica(0)
        time.sleep(0.1)
        with pytest.raises(ServiceUnavailable):
            ex.step(ins)
        assert ex.stats["degraded_failed_steps"] == 1


def test_dark_pool_degrade_stale_serves_locally():
    prog = _sls_program("s")
    ins = _inputs(prog, 7)
    ref = executor_for(prog, device="cpu").step(ins)
    with _dark_pool() as pool:
        ex = executor_for(prog, device="cpu", service="disagg",
                          service_pool=pool, degrade_policy="stale")
        _assert_outputs_equal(ref, ex.step(ins))
        pool.kill_replica(0)
        time.sleep(0.1)
        _assert_outputs_equal(ref, ex.step(ins))   # stale = local tables
        assert ex.stats["stale_steps"] == 1


def test_dark_pool_hot_slab_serves_under_fail_policy():
    """An all-hot step (every index in the client's hot slab) serves
    locally even under ``degrade_policy="fail"``: only cold lookups pay
    the policy."""
    prog = _sls_program("s")
    ins = _inputs(prog, 8)
    ref = executor_for(prog, device="cpu").step(ins)
    with _dark_pool() as pool:
        ex = executor_for(prog, device="cpu", service="disagg",
                          service_pool=pool,
                          hot_rows={"s": np.arange(32)})   # whole vocab hot
        _assert_outputs_equal(ref, ex.step(ins))
        pool.kill_replica(0)
        time.sleep(0.1)
        _assert_outputs_equal(ref, ex.step(ins))
        assert ex.stats["hot_local_steps"] == 1
        assert ex.stats["degraded_failed_steps"] == 0


# ---------------------------------------------------------------------------
# Chaos: deterministic replay on the rpc sites
# ---------------------------------------------------------------------------

def _chaos_run(seed: int) -> tuple:
    seed = int(os.environ.get("CHAOS_SEED", seed))
    prog = _sls_program("c")
    ins = _inputs(prog, 9)
    ref = executor_for(prog, device="cpu").step(ins)
    faults = FaultInjector([FaultSpec("rpc_send", at=(4,)),
                            FaultSpec("rpc_recv", at=(3,))], seed=seed)
    with ServicePool(2, faults=faults, **BACKOFF) as pool:
        ex = executor_for(prog, device="cpu", service="disagg",
                          service_pool=pool)
        for _ in range(5):
            _assert_outputs_equal(ref, ex.step(ins))
        stats = pool.stats()
    return faults.stats(), stats["retries"] + stats["failovers"]


def test_rpc_chaos_replays_deterministically():
    """A pinned-seed schedule severing an rpc_send and an rpc_recv fires at
    the same call ordinals across runs, and the bounded retry heals every
    step -- no request-visible failure."""
    s1, healed1 = _chaos_run(seed=7)
    s2, healed2 = _chaos_run(seed=7)
    assert s1["log"] == s2["log"] and s1["fired"] == 2
    assert healed1 >= 1 and healed1 == healed2


def test_service_crash_site_respawns_clean():
    """A --crash-at schedule makes the replica exit (os._exit) at a step
    ordinal; the pool heals the step and the respawned process runs
    WITHOUT the schedule -- recovery ends."""
    prog = _sls_program("k")
    ins = _inputs(prog, 10)
    ref = executor_for(prog, device="cpu").step(ins)
    with ServicePool(2, crash_at={0: (2,)}, chaos_seed=7,
                     **BACKOFF) as pool:
        ex = executor_for(prog, device="cpu", service="disagg",
                          service_pool=pool)
        for _ in range(6):              # replica 0 dies at its 2nd step
            _assert_outputs_equal(ref, ex.step(ins))
        t0 = time.perf_counter()
        while any(r.state != "live" for r in pool.replicas):
            pool.heartbeat_once()
            time.sleep(0.05)
            assert time.perf_counter() - t0 < REVIVE_S, "revive timed out"
        assert pool.replicas[0].spawns == 2       # exactly one extra life
        for _ in range(3):
            _assert_outputs_equal(ref, ex.step(ins))


# ---------------------------------------------------------------------------
# Adaptive hot slab: a swap republishes; a killed replica re-warms with it
# ---------------------------------------------------------------------------

def test_disagg_swap_republish_and_rewarm():
    prog = EmbeddingProgram("adapt1", (
        ("t", EmbeddingOp("sls", 4, 64, 8, avg_lookups=4)),))
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))

    def step_ins(lo, hi):
        lens = np.full(4, 4, np.int64)
        ptrs = np.zeros(5, np.int64)
        np.cumsum(lens, out=ptrs[1:])
        return {"t": {"table": table, "ptrs": ptrs,
                      "idxs": rng.integers(lo, hi, 16).astype(np.int32)}}

    ref = ProgramExecutor(compile_program(prog, "O3", use_cache=False),
                          device="cpu")
    cfg = AdaptiveHotConfig(window_steps=4, num_windows=2,
                            drift_threshold=0.6, min_swap_interval=4,
                            refine_passes=0)
    with ServicePool(1, **BACKOFF) as pool:
        ex = ProgramExecutor(
            compile_program(prog, "O3", use_cache=False), device="cpu",
            service="disagg", service_pool=pool,
            hot_rows={"t": tuple(range(16))}, adaptive=cfg)

        def check(ins):
            assert torch.equal(ex.step(ins)["t"], ref.step(ins)["t"])

        for _ in range(6):                 # reference window: all hot
            check(step_ins(0, 16))
        for _ in range(8):                 # drift to a disjoint head
            check(step_ins(32, 48))
        assert ex.stats["hot_swaps"] >= 1
        published = pool.pool_stats["hot_publishes"]
        assert published >= 1
        assert set(np.asarray(ex._svc_hot["t"])) & set(range(32, 48))

        # kill the only replica right after the swap's republish; the
        # revived replica must re-warm from the rewritten artifact --
        # carrying the POST-swap slab spec, never the bind-time one
        pool.kill_replica(0)
        r = pool.replicas[0]
        spawns0 = r.spawns
        t0 = time.perf_counter()
        while r.spawns == spawns0 or r.state != "live":
            pool.heartbeat_once()
            time.sleep(0.05)
            assert time.perf_counter() - t0 < REVIVE_S, "revive timed out"
        s = pool.stats()
        assert s["warm_sources"][-1] == "artifact"
        ping = pool.replicas[0].hb.call("ping")[0]
        assert ping["hot_epoch"] == published
        check(step_ins(0, 64))             # and it still serves, identical


# ---------------------------------------------------------------------------
# The server over the tier, and the card refused
# ---------------------------------------------------------------------------

def test_disagg_server_equals_the_inproc_server():
    """A reduced LM served with its decode-embed pipeline over two replicas
    emits the in-process server's tokens, and every wave's replica outputs
    are the in-process group's bits and ``embed[tokens]``."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.lm import LM
    from repro_torch.runtime.server import DecodeServer, Request
    lm = LM(get_reduced("stablelm-3b"), device="cpu", seed=2)
    prompts = [np.arange(n, dtype=np.int32) + 3 for n in (3, 6, 4)]

    def drive(**kw):
        srv = DecodeServer(lm, batch_slots=2, max_len=32, prefill_chunk=4,
                           pipeline=True, **kw)
        grp = srv.pipeline_group
        seen = []
        submit_wave = grp.submit_wave

        def spy(wave):
            hs = submit_wave(wave)
            seen.append((wave, hs))
            return hs
        grp.submit_wave = spy
        reqs = [Request(prompt=p.copy(), max_new_tokens=3) for p in prompts]
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        assert all(r.status == "ok" for r in reqs)
        return srv, reqs, [(w, {n: h.result() for n, h in hs.items()})
                           for w, hs in seen]

    _, want_reqs, want_waves = drive()
    with ServicePool(2, **BACKOFF) as pool:
        srv, reqs, waves = drive(service="disagg", service_pool=pool,
                                 degrade_policy="stale")
        assert [r.out for r in reqs] == [r.out for r in want_reqs]
        assert len(waves) == len(want_waves) == srv.serve_stats["waves"]
        name = srv.pipeline_group.names[0]
        for (wave, got), (_, want) in zip(waves, want_waves):
            _assert_outputs_equal(got[name], want[name])
            toks = torch.from_numpy(wave[name]["tok_embed"]["idxs"]).long()
            assert torch.equal(got[name]["tok_embed"][:, 0], lm.embed[toks])
        ex = srv.pipeline_group.executor(name)
        assert ex.service == "disagg" and ex.stats["stale_steps"] == 0
        assert pool.stats()["rpc_steps"] == ex.stats["rpc_steps"] > 0


def test_a_replica_asked_for_the_card_never_runs_on_the_cpu():
    """With no card, a replica asked for one exits at startup, and the pool
    raises typed (and stops what it started)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(ServiceUnavailable, match="died"):
        ServicePool(1, spawn_attempts=1, backoff_s=0.01)


def test_failover_with_two_steps_in_flight():
    """Two steps in flight, one on each replica; the replica holding the
    older one dies taking it (its ``service_crash`` site: no reply).
    Rerouted to the peer, which has served the newer seq already, the
    older step runs there (marked ``failover``) instead of being refused
    as stale, and both results are the in-process bits."""
    prog = _sls_program("f")
    ins = _inputs(prog, 13)
    ref = executor_for(prog, device="cpu").step(ins)
    with ServicePool(2, crash_at={1: (1,)}, chaos_seed=7, **BACKOFF) as pool:
        ex = executor_for(prog, device="cpu", service="disagg",
                          service_pool=pool)
        _assert_outputs_equal(ref, ex.step(ins))   # binds; seq 1: replica 0
        h1, h2 = ex.submit(ins), ex.submit(ins)    # seq 2: replica 1, seq 3: 0
        assert [sorted(r.pending) for r in pool.replicas] == [[3], [2]]
        _assert_outputs_equal(ref, h2.result())    # replica 0 served seq 3
        _assert_outputs_equal(ref, h1.result())    # seq 2, rerouted to it
        assert pool.stats()["failovers"] == 1
        assert ex.stats["stale_steps"] == ex.stats["degraded_failed_steps"] == 0
        ping = pool.replicas[0].hb.call("ping")[0]
        assert ping["steps"] == 3                  # seq 1, seq 3, seq 2
