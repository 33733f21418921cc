"""Tensor and expert parallelism of the port's LM against the JAX package's
sharded LM.

The reference runs once (one subprocess with a forced 2-device CPU mesh
``(1, 2)`` over ``("data", "model")``, as the ``run_on_mesh`` fixture
starts it, its params placed by ``param_specs``, results into an npz): the forward, the
teacher-forced ``decode_step``, a masked ``wave_step`` and its caches, and
``DecodeServer`` of ``LM(cfg, ShardCtx(mesh))`` for the ``dense``,
``dense_local`` and ``moe`` kinds' reduced configs, its expert-parallel
``moe_ffn`` on both paths, and its three sharded lookup strategies.  The
port runs the same on two gloo ranks on the CPU (``launch.mesh.run_ranks``,
one spawn for every model, while the reference's subprocess runs; each
rank loads its slices of the reference's weights with
``convert.lm_params_from_reference(mesh=)``).  Outputs are held at
the reference tests' f32 bound (2e-5); the served tokens, the lookups and
the cache's integer leaves exactly.  (Model-parallel training of the dense
kinds is held in ``tests/test_torch_mp_train.py``; an MoE model's loss
over a mesh raises, naming ROADMAP.md item 6e.)  The port alone: the ranks' slices of
``LM(seed, shard=)`` join to ``LM(seed)`` bit for bit, the ranks agree bit
for bit, the sharded embedding executor reads the rank's own rows, what is
outside the port's tensor parallelism raises, and the kinds and head
counts earlier slices refused build (the head plan, the MLA and
encoder-decoder kinds: ``tests/test_torch_tp_heads.py`` and
``tests/test_torch_tp_kinds.py`` hold them against the reference).
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import run_ranks

F32 = dict(rtol=2e-5, atol=2e-5)
ARCHS = ("chatglm3-6b", "h2o-danube-1.8b", "gemma3-4b",
         "qwen3-moe-235b-a22b")
SERVED = ("chatglm3-6b", "qwen3-moe-235b-a22b")
MOE = "qwen3-moe-235b-a22b"
SEED, B, S, MAX_LEN, STEPS = 3, 2, 16, 24, 4
WAVE_LENS = (5, 3)
STRATEGIES = ("masked_psum", "masked_psum_scatter", "one_hot")
EP_PATHS = ("split", "rep")
#: the kinds outside the port's tensor parallelism (ROADMAP.md Queue 1
#: item 6d-2 b)
OUT_OF_SLICE = ("xlstm-1.3b",)
#: what earlier slices refused and builds now: the MLA and encoder-decoder
#: kinds, zamba2's mamba and shared attention, and 3 KV heads over 2
#: ranks (the head plan)
BUILT = ("deepseek-v2-lite-16b", "whisper-large-v3", "zamba2-7b", "heads")


# ---------------------------------------------------------------------------
# Inputs, made with numpy, equal in both packages
# ---------------------------------------------------------------------------

def tokens(cfg) -> np.ndarray:
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def requests(cfg) -> list:
    """(prompt, max_new_tokens) of the served drive."""
    rng = np.random.default_rng(11)
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
            for n, m in ((6, 4), (9, 3), (4, 5))]


SERVER_KW = dict(batch_slots=2, max_len=32, prefill_chunk=4)


def moe_inputs(d_model: int) -> dict:
    """The expert-parallel cases: S divisible by the axis (seq-split) and
    decode-shaped (replicated tokens)."""
    rng = np.random.default_rng(13)
    return {"split": rng.standard_normal((2, 6, d_model)).astype(np.float32),
            "rep": rng.standard_normal((3, 1, d_model)).astype(np.float32)}


def lookup_inputs() -> tuple:
    rng = np.random.default_rng(17)
    table = rng.standard_normal((512, 16)).astype(np.float32)
    ids = rng.integers(0, 512, (2, 8)).astype(np.int32)
    return table, ids


# ---------------------------------------------------------------------------
# The reference, once, on a forced 2-device CPU mesh
# ---------------------------------------------------------------------------

_REF_CODE = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, "tests")
import test_torch_tensor_parallel as T
from repro.configs import get_reduced
from repro.core import embedding_engine as jee
from repro.launch import sharding as shd
from repro.launch.mesh import axis_types_kw
from repro.models import moe as jmoe
from repro.models.lm import LM, ShardCtx
from repro.runtime.server import DecodeServer, Request
from repro_torch.convert import caches_from_reference

mesh = jax.make_mesh((1, 2), ("data", "model"), **axis_types_kw(2))
out = {{}}


def place(tree):
    specs = shd.sanitize_specs(shd.param_specs(tree), tree, mesh)
    return jax.device_put(tree, shd.to_shardings(mesh, specs))


for arch in T.ARCHS:
    cfg = get_reduced(arch)
    params = place(LM(cfg).init(jax.random.PRNGKey(T.SEED)))
    lm = LM(cfg, ShardCtx(mesh=mesh))
    toks = jnp.asarray(T.tokens(cfg))
    h, aux = jax.jit(lm.forward)(params, {{"tokens": toks}})
    out[f"{{arch}}/fwd"], out[f"{{arch}}/aux"] = np.asarray(h), np.asarray(aux)
    step = jax.jit(lm.decode_step)
    caches = lm.init_caches(T.B, T.MAX_LEN)
    for t in range(T.STEPS):
        lg, caches = step(params, toks[:, t:t + 1], caches)
        out[f"{{arch}}/dec/{{t}}"] = np.asarray(lg)
    lg, caches = jax.jit(lm.wave_step)(
        params, toks[:, :max(T.WAVE_LENS)], jnp.asarray(T.WAVE_LENS),
        lm.init_caches(T.B, T.MAX_LEN))
    out[f"{{arch}}/wave"] = np.asarray(lg)
    port = caches_from_reference(jax.tree.map(np.asarray, caches), cfg, "cpu")
    for li, layer in enumerate(port):
        for k, v in layer.items():
            out[f"{{arch}}/cache/{{li}}/{{k}}"] = v.numpy()
    if arch in T.SERVED:
        srv = DecodeServer(lm, params, **T.SERVER_KW)
        reqs = [Request(prompt=p, max_new_tokens=m)
                for p, m in T.requests(cfg)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        for i, r in enumerate(reqs):
            out[f"{{arch}}/srv/{{i}}"] = np.asarray(r.out, np.int64)
        out[f"{{arch}}/srv/shards"] = np.asarray(
            srv.compile_stats["executor"]["shards"])
    if arch == T.MOE:
        p_moe = jax.tree.map(lambda a: a[0], params["scan"][0]["moe"])
        p_moe = place({{"rest": [{{"moe": p_moe}}]}})["rest"][0]["moe"]
        for path, x in T.moe_inputs(cfg.d_model).items():
            o, a = jmoe.moe_ffn(p_moe, jnp.asarray(x), cfg, mesh=mesh,
                                ep_axis="model", data_axes=())
            out[f"moe/{{path}}/out"], out[f"moe/{{path}}/aux"] = \\
                np.asarray(o), np.asarray(a)
table, ids = T.lookup_inputs()
table = place({{"embed": jnp.asarray(table)}})["embed"]
for s in T.STRATEGIES:
    out[f"lookup/{{s}}"] = np.asarray(jee.lookup(
        table, jnp.asarray(ids), mesh=mesh, vocab_axis="model", strategy=s))
np.savez({path!r}, **out)
print("REF_OK")
"""

_MEMO: dict = {}
_REPO = Path(__file__).resolve().parent.parent


def _start_reference(path: Path, log: Path):
    """The reference's subprocess, started in the background with a forced
    2-device CPU platform (``benchmarks._mesh``; the child prints the
    ``MESH_SKIP`` sentinel where the count is not honoured)."""
    from benchmarks._mesh import forced_device_env
    env = forced_device_env(2)
    env["PYTHONPATH"] = os.pathsep.join(
        ["src", str(_REPO)] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    body = ("from benchmarks._mesh import require_devices\n"
            "if not require_devices(2):\n    raise SystemExit(0)\n" +
            _REF_CODE.format(path=str(path)))
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-c", body], stdout=f,
                                stderr=subprocess.STDOUT, env=env,
                                cwd=str(_REPO))


@pytest.fixture
def results(tmp_path_factory) -> tuple:
    """(the reference's npz as a dict, ``{arch: [rank 0's results, rank
    1's]}``): the reference's subprocess and the port's two ranks run
    side by side, once."""
    if "res" not in _MEMO:
        from benchmarks._mesh import MESH_SKIP
        tmp = tmp_path_factory.mktemp("tp")
        proc = _start_reference(tmp / "ref.npz", tmp / "ref.log")
        try:
            ranks = run_ranks(_port_all, 2)
            proc.wait(timeout=900)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out = (tmp / "ref.log").read_text()
        if MESH_SKIP in out:
            pytest.skip(f"forced 2-device CPU mesh not honored: "
                        f"{out.strip().splitlines()[-1]}")
        assert "REF_OK" in out, out[-4000:]
        with np.load(tmp / "ref.npz") as z:
            ref = dict(z)
        _MEMO["res"] = (ref, {a: [r[a] for r in ranks] for a in ARCHS})
    return _MEMO["res"]


@pytest.fixture
def reference(results) -> dict:
    return results[0]


@pytest.fixture
def port(results) -> dict:
    return results[1]


# ---------------------------------------------------------------------------
# The port, on two gloo ranks
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _port_model(rank: int, world: int, arch: str) -> dict:
    """One rank: its slices of the reference's weights, the forward, the
    teacher-forced decode steps, the masked wave and its caches, the
    server, and (seeded) ``LM(seed, shard=)``'s own slices."""
    import jax
    from repro.configs import get_reduced as jget_reduced
    from repro.models.lm import LM as JLM
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM, ShardCtx
    from repro_torch.runtime.server import DecodeServer, Request
    cfg = get_reduced(arch)
    mesh = make_host_mesh(world, device="cpu")
    shard = ShardCtx(mesh)
    params = jax.tree.map(np.asarray, JLM(jget_reduced(arch)).init(
        jax.random.PRNGKey(SEED)))
    lm = LM(cfg, device="cpu", shard=shard)
    lm.load_state_dict(lm_params_from_reference(params, cfg, "cpu",
                                                mesh=mesh))
    out = {"seeded": {k: _np(v) for k, v in LM(
        cfg, device="cpu", seed=SEED, shard=shard).state_dict().items()}}
    toks = torch.from_numpy(tokens(cfg)).long()
    h, aux = lm.forward(toks, with_aux=True)
    out["fwd"], out["aux"] = _np(h), float(aux)
    caches = lm.init_caches(B, MAX_LEN)
    for t in range(STEPS):
        lg, _ = lm.decode_step(toks[:, t:t + 1], caches)
        out[f"dec/{t}"] = _np(lg)
    caches = lm.init_caches(B, MAX_LEN)
    lg, _ = lm.wave_step(toks[:, :max(WAVE_LENS)].numpy(),
                         np.asarray(WAVE_LENS), caches)
    out["wave"] = _np(lg)
    out["cache"] = [{k: _np(v) for k, v in c.items()} for c in caches]
    if arch in SERVED:
        srv = DecodeServer(lm, **SERVER_KW)
        reqs = [Request(prompt=p, max_new_tokens=m)
                for p, m in requests(cfg)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        ex = srv.compile_stats["executor"]
        out["srv"] = [list(r.out) for r in reqs]
        out["srv_stats"] = {
            "shards": ex["shards"], "exchange": ex["exchange"],
            "replicate_outputs": ex["replicate_outputs"],
            "access_plans": "access_plans" in srv.compile_stats,
            "wave_graph": srv.serve_stats["wave_graph"],
            "collectives": lm.collective_stats["collectives"]}
    if arch == "chatglm3-6b":
        out["executor"] = _executor_case(lm)
    if arch == MOE:
        out.update(_ops(lm, params, mesh))
    return out


def _executor_case(lm) -> dict:
    """The model's sharded embedding executor stepped over the rank's own
    vocab rows, against the rows of the gathered table."""
    ex = lm.embedding_executor(B, S)
    ids = tokens(lm.cfg).reshape(-1)
    tables = lm.embedding_table_inputs()
    ins = {n: {"table": tables[n]["table"], "idxs": ids} for n in tables}
    got = ex.full_outputs(ex.step(ins))
    full = lm.tp.gather(lm.embed, 0)
    want = full[torch.from_numpy(ids).long()]
    return {"shards": ex.shards,
            "equal": all(torch.equal(got[n].reshape(want.shape), want)
                         for n in tables)}


def _ops(lm, params, mesh) -> dict:
    """Expert parallelism on both paths, the three lookups, and what
    raises."""
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.core import embedding_engine as ee
    from repro_torch.models import moe as tmoe
    from repro_torch.models.lm import LM, ShardCtx
    cfg = lm.cfg
    out = {}
    for path, x in moe_inputs(cfg.d_model).items():
        o, a = tmoe.moe_ffn(lm.blocks[0].moe, torch.from_numpy(x), cfg,
                            mesh=mesh, ep_axis="model")
        # the reference's moe_ffn returns the aux pmeaned over the axis
        a = tmoe.mean_aux(a, mesh, "model", (), x.shape[1])
        out[f"moe/{path}/out"], out[f"moe/{path}/aux"] = _np(o), float(a)
    table, ids = lookup_inputs()
    r = lm.tp.rank
    local = torch.from_numpy(table[r * 256:(r + 1) * 256])
    for s in STRATEGIES:
        out[f"lookup/{s}"] = _np(ee.lookup(
            local, torch.from_numpy(ids), mesh=mesh, vocab_axis="model",
            strategy=s))
    raised = {}

    def why(fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            return f"{type(e).__name__}: {e}"
        return "nothing"

    shard = ShardCtx(mesh)
    for arch in OUT_OF_SLICE:
        raised[arch] = why(lambda a=arch: LM(get_reduced(a), device="cpu",
                                             shard=shard))
    for arch in BUILT[:3]:
        raised[arch] = _built(get_reduced(arch), shard)
    raised["pipeline"] = why(lambda: __import__(
        "repro_torch.runtime.server", fromlist=["DecodeServer"]
    ).DecodeServer(lm, batch_slots=2, pipeline=True))
    toks = torch.from_numpy(tokens(cfg)).long()
    # the MoE loss over the mesh runs since expert-parallel training
    loss = lm.loss(toks, toks)
    raised["loss"] = "ran: a finite loss" if bool(torch.isfinite(loss)) \
        else f"ran: loss {float(loss)}"
    odd = dataclasses.replace(get_reduced("chatglm3-6b"), num_heads=6,
                              num_kv_heads=3)
    raised["heads"] = _built(odd, shard)
    raised["meta"] = why(lambda: LM(get_reduced("chatglm3-6b"),
                                    device="meta", shard=shard))
    out["raised"] = raised
    out["full_params"] = {k: _np(v) for k, v in lm_params_from_reference(
        params, cfg, "cpu").items() if k.startswith("blocks.0.moe.")}
    return out


def _built(cfg, shard) -> str:
    """Build the rank's slices of ``LM(cfg, seed)``: ``"built: ..."`` with
    the rank's query and KV heads (the head plan's) where its forward is
    finite, else what went wrong."""
    from repro_torch.launch.sharding import head_plan
    from repro_torch.models.lm import LM
    try:
        lm = LM(cfg, device="cpu", seed=SEED, shard=shard)
        kw = {}
        if cfg.enc_layers:
            kw["enc_embeds"] = torch.zeros((B, S, cfg.d_model))
        with torch.no_grad():
            h = lm.forward(torch.from_numpy(tokens(cfg)).long(), **kw)
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    attn = lm.shared["attn"] if hasattr(lm, "shared") else lm.blocks[0].attn
    mla = "w_uk" in attn
    q = (attn["w_uk"] if mla else attn["wq"]).shape[1] // cfg.hd
    kv = q if mla else attn["wk"].shape[1] // cfg.hd
    plan = head_plan(cfg, lm.tp.size, lm.tp.rank)
    if (q, kv) != (plan.q[1] - plan.q[0], plan.kv[1] - plan.kv[0]) or \
            not bool(torch.isfinite(h).all()):
        return f"wrong: {q} query and {kv} KV heads, plan {plan}"
    return f"built: {q} query heads over {kv} KV heads"


def _port_all(rank: int, world: int) -> dict:
    return {a: _port_model(rank, world, a) for a in ARCHS}


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_references_mesh(reference, port, arch):
    for res in port[arch]:
        np.testing.assert_allclose(res["fwd"], reference[f"{arch}/fwd"],
                                   **F32)
        np.testing.assert_allclose(res["aux"], reference[f"{arch}/aux"],
                                   **F32)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_the_references_mesh(reference, port, arch,
                                                step):
    for res in port[arch]:
        np.testing.assert_allclose(res[f"dec/{step}"],
                                   reference[f"{arch}/dec/{step}"], **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_wave_matches_the_references_mesh(reference, port, arch):
    for res in port[arch]:
        np.testing.assert_allclose(res["wave"], reference[f"{arch}/wave"],
                                   **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_caches_its_kv_heads(reference, port, arch):
    """A rank's cache holds its KV heads (dim 1 of the head-major K/V)
    of the reference's cache after the wave; ``len`` whole and exact."""
    for rank, res in enumerate(port[arch]):
        for li, layer in enumerate(res["cache"]):
            for k, got in layer.items():
                want = reference[f"{arch}/cache/{li}/{k}"]
                if k == "len":
                    np.testing.assert_array_equal(got, want)
                    continue
                h = got.shape[1]
                assert want.shape[1] == 2 * h
                np.testing.assert_allclose(
                    got, want[:, rank * h:(rank + 1) * h], **F32)


@pytest.mark.parametrize("arch", SERVED)
def test_server_tokens_equal_the_references(reference, port, arch):
    for res in port[arch]:
        for i, toks in enumerate(res["srv"]):
            assert toks == reference[f"{arch}/srv/{i}"].tolist(), i
        st = res["srv_stats"]
        assert st["shards"] == int(reference[f"{arch}/srv/shards"]) == 2
        assert st["access_plans"] and st["exchange"] == "collective"
        assert not st["wave_graph"] and st["collectives"] > 0


@pytest.mark.parametrize("path", EP_PATHS)
def test_expert_parallel_paths_match_the_references(reference, port, path):
    for res in port[MOE]:
        np.testing.assert_allclose(res[f"moe/{path}/out"],
                                   reference[f"moe/{path}/out"], **F32)
        np.testing.assert_allclose(res[f"moe/{path}/aux"],
                                   reference[f"moe/{path}/aux"], **F32)


@pytest.mark.parametrize("path", EP_PATHS)
def test_ep_plain_is_the_references_sharded_function(reference, port, path):
    """``moe_ffn_ep_plain`` in one process on the full weights: the
    reference's 2-device ``moe_ffn``, the seq-split path included (where
    the single device differs)."""
    from repro_torch.models import moe as tmoe
    from repro_torch.models.lm import ParamTree
    cfg = get_reduced(MOE)
    full = port[MOE][0]["full_params"]
    tree = {k.split(".", 3)[3]: torch.from_numpy(v) for k, v in full.items()}
    p = ParamTree({"router": tree["router"], "wi_gate": tree["wi_gate"],
                   "wi_up": tree["wi_up"], "wo": tree["wo"]})
    x = torch.from_numpy(moe_inputs(cfg.d_model)[path])
    o, a = tmoe.moe_ffn_ep_plain(p, x, cfg, 2)
    np.testing.assert_allclose(o.numpy(), reference[f"moe/{path}/out"],
                               **F32)
    np.testing.assert_allclose(float(a), reference[f"moe/{path}/aux"],
                               **F32)
    single, _ = tmoe.moe_ffn(p, x, cfg)
    same = np.allclose(single.numpy(), reference[f"moe/{path}/out"], **F32)
    assert same == (path == "rep")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_lookups_match_the_reference(reference, port, strategy):
    want = reference[f"lookup/{strategy}"]
    for rank, res in enumerate(port[MOE]):
        got = res[f"lookup/{strategy}"]
        if strategy == "masked_psum_scatter":
            s = want.shape[1] // 2
            want_r = want[:, rank * s:(rank + 1) * s]
        else:
            want_r = want
        np.testing.assert_array_equal(got, want_r)


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_init_joins_to_the_single_device_bit_for_bit(port, arch):
    from repro_torch.convert import lm_params_gathered
    from repro_torch.models.lm import LM
    ranks = [{k: torch.from_numpy(v) for k, v in r["seeded"].items()}
             for r in port[arch]]
    got = lm_params_gathered(ranks, get_reduced(arch))
    want = LM(get_reduced(arch), device="cpu", seed=SEED).state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # the rank holds half of every split leaf
    r0 = ranks[0]
    assert r0["embed"].shape[0] * 2 == want["embed"].shape[0]
    assert r0["blocks.0.attn.wq"].shape[1] * 2 == \
        want["blocks.0.attn.wq"].shape[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_the_ranks_agree_bit_for_bit(port, arch):
    r0, r1 = port[arch]
    for key in ["fwd", "wave"] + [f"dec/{t}" for t in range(STEPS)]:
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    if arch in SERVED:
        assert r0["srv"] == r1["srv"]


def test_sharded_embedding_executor_reads_the_ranks_own_rows(port):
    for res in port["chatglm3-6b"]:
        assert res["executor"] == {"shards": 2, "equal": True}


@pytest.mark.parametrize("case,match", [
    *((a, "NotImplementedError: .*item 6d") for a in OUT_OF_SLICE),
    # these four raised before the head plan, the MLA and encoder-decoder
    # kinds and zamba2's kinds were split; they keep their case ids
    pytest.param("zamba2-7b", "built: 2 query heads over 2 KV",
                 id="zamba2-7b-NotImplementedError: .*item 6d"),
    pytest.param("deepseek-v2-lite-16b", "built: 2 query heads over 2 KV",
                 id="deepseek-v2-lite-16b-NotImplementedError: .*item 6d"),
    pytest.param("whisper-large-v3", "built: 2 query heads over 2 KV",
                 id="whisper-large-v3-NotImplementedError: .*item 6d"),
    pytest.param("heads", "built: [42] query heads over [21] KV",
                 id="heads-ValueError: .*num_kv_heads 3 does not split"),
    ("pipeline", "NotImplementedError: .*item 6d"),
    # the MoE loss over a mesh raised before expert-parallel training; the
    # case keeps its id
    pytest.param("loss", "ran: a finite loss",
                 id="loss-NotImplementedError: .*item 6e"),
    ("meta", "ValueError: a sharded LM is built on its mesh's device")])
def test_what_this_slice_leaves_out_raises(port, case, match):
    """What the port's tensor parallelism leaves out raises, naming its
    ROADMAP item; what earlier slices refused builds, each rank holding
    the head plan's heads."""
    import re
    for res in port[MOE]:
        assert re.match(match, res["raised"][case]), res["raised"][case]
