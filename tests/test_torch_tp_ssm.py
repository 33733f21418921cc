"""zamba2's ``mamba`` and ``shared_attn`` kinds over a (data, model) mesh,
against the JAX package's sharded LM on forced 2- and 4-device CPU meshes.

Reduced zamba2 (8 layers ``mamba, mamba, shared_attn`` x 2 + 2 ``mamba``,
d_model 64, 4 heads, ssm_state 8, fp32) on ``(1, 2)``, ``(1, 4)`` and
``(2, 2)``: a mamba layer split by SSM head (its ``w_in`` as the rank's x,
z and dt columns around the B | C block every rank copies), the shared
attention set by the head plan, its MLP by column and row.  Held against
the reference's sharded LM: the forward, teacher-forced ``decode_step``s,
a masked ``wave_step`` and its caches (the rank's heads of the reference's
``state``, ``conv`` and K/V), ``DecodeServer``'s tokens, the loss and the
clipped global norm, and every leaf's gradient, stepped parameter and
AdamW moments after one step (ZeRO-1 moments on ``(2, 2)``).  A sharded
checkpoint crosses both ways: the reference's, saved from ``(1, 2)``,
restores onto each port rank's slices bit for bit, and the port ranks'
(from every mesh) restores in the reference on one device bit for bit.
The reference runs in one subprocess a device count, the port on gloo
ranks on the CPU (one spawn a mesh, beside the subprocesses), each rank's
slices cut from the reference's weights by
``convert.lm_params_from_reference(mesh=)``.

Tolerances: the whole-model outputs (hidden states, logits, caches) and
the loss at ``MODEL`` (1e-4), the bound ``tests/test_torch_zamba2.py``
holds the single-device port to the reference at; every gradient leaf at
1e-4 relative L2 (that file's bound for ``jax.grad``), or at twice the
reference's own distance between its mesh's gradient and its one
device's where that is larger (a mamba layer's four ``dt_bias`` sums
move by 1.4e-4 between the reference's ``(1, 2)`` mesh and its one
device); the stepped
parameters and moments at ``F32`` (2e-5) -- except where a clipped
gradient is within a few ``eps`` of zero, where AdamW's ``m / (sqrt(v) +
eps)`` turns a 1e-4 relative gradient difference into a larger step
difference (those elements are counted and bounded, not skipped: see
``test_every_leaf_after_a_step_matches_the_references_mesh``).  The ranks
agree bit for bit; the served tokens, the caches' integer leaves and the
checkpoints' crossings exactly.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import run_ranks

ARCH = "zamba2-7b"
MODEL = dict(rtol=1e-4, atol=1e-4)
F32 = dict(rtol=2e-5, atol=2e-5)
GRAD_REL_L2 = 1e-4
#: device count -> its (data, model) meshes
MESHES = {2: ((1, 2),), 4: ((1, 4), (2, 2))}
SHAPES = [m for ms in MESHES.values() for m in ms]
IDS = [f"{d}x{m}" for d, m in SHAPES]
SEED, B, S, MAX_LEN, STEPS = 3, 2, 16, 24, 4
WAVE_LENS = (5, 3)
BATCH, LR, CLIP = 4, 1e-3, 0.05
SERVER_KW = dict(batch_slots=2, max_len=32, prefill_chunk=4)
WHAT = ("grad", "param", "mu", "nu")
CKPT_STEP = 1
_REPO = Path(__file__).resolve().parent.parent


def tag(shape: tuple) -> str:
    return f"{shape[0]}x{shape[1]}"


def tokens(cfg) -> np.ndarray:
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def batch(cfg) -> dict:
    """The global training batch: step 0 of the port's synthetic token
    stream."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    return SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                      global_batch=BATCH)).batch_at(0)


def requests(cfg) -> list:
    rng = np.random.default_rng(11)
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
            for n, m in ((6, 4), (9, 3), (4, 5))]


# ---------------------------------------------------------------------------
# The reference: one subprocess a device count
# ---------------------------------------------------------------------------

_REF_CODE = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, "tests")
import test_torch_tp_ssm as T
from repro.checkpoint import save_checkpoint
from repro.configs import get_reduced
from repro.launch import sharding as shd
from repro.launch.mesh import axis_types_kw
from repro.models.lm import LM, ShardCtx
from repro.optim.adamw import AdamW, AdamWState, apply_updates
from repro.runtime.server import DecodeServer, Request
from repro_torch.convert import caches_from_reference, lm_params_from_reference
from repro_torch.core.shard_plan import DryMesh

out = {{}}
cfg = get_reduced(T.ARCH)
params = LM(cfg).init(jax.random.PRNGKey(T.SEED))


def port_names(tree):
    return {{k: v.numpy() for k, v in lm_params_from_reference(
        jax.tree.map(np.asarray, tree), cfg, "cpu").items()}}


if {devices} == 2:      # the reference's own gradient on one device
    one = {{k: jnp.asarray(v) for k, v in T.batch(cfg).items()}}
    for k, v in port_names(jax.jit(jax.grad(LM(cfg).loss))(
            params, one)).items():
        out[f"one/grad/{{k}}"] = v


for shape in T.MESHES[{devices}]:
    mesh = jax.make_mesh(shape, ("data", "model"), **axis_types_kw(2))
    rep = NamedSharding(mesh, P())
    key = T.tag(shape)
    p_specs = shd.sanitize_specs(shd.param_specs(params), params, mesh)
    specs = shd.to_shardings(mesh, p_specs)
    ps = jax.device_put(params, specs)
    lm = LM(cfg, ShardCtx(mesh=mesh, data_axes=("data",)))
    toks = jnp.asarray(T.tokens(cfg))
    out[f"{{key}}/fwd"] = np.asarray(jax.jit(lm.forward)(
        ps, {{"tokens": toks}})[0])
    dec = jax.jit(lm.decode_step)
    caches = lm.init_caches(T.B, T.MAX_LEN)
    for t in range(T.STEPS):
        lg, caches = dec(ps, toks[:, t:t + 1], caches)
        out[f"{{key}}/dec/{{t}}"] = np.asarray(lg)
    lg, caches = jax.jit(lm.wave_step)(
        ps, toks[:, :max(T.WAVE_LENS)], jnp.asarray(T.WAVE_LENS),
        lm.init_caches(T.B, T.MAX_LEN))
    out[f"{{key}}/wave"] = np.asarray(lg)
    tree = jax.tree.map(np.asarray, caches)
    for li, layer in enumerate(caches_from_reference(tree, cfg, "cpu")):
        for k, v in layer.items():
            out[f"{{key}}/cache/{{li}}/{{k}}"] = v.numpy()
    for r in range(shape[1]):       # each model rank's slices
        rank = DryMesh(dict(zip(("data", "model"), shape)), r)
        for li, layer in enumerate(caches_from_reference(tree, cfg, "cpu",
                                                         mesh=rank)):
            for k, v in layer.items():
                out[f"{{key}}/rcache/{{r}}/{{li}}/{{k}}"] = v.numpy()
    srv = DecodeServer(lm, ps, **T.SERVER_KW)
    reqs = [Request(prompt=p, max_new_tokens=m) for p, m in T.requests(cfg)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    for i, r in enumerate(reqs):
        out[f"{{key}}/srv/{{i}}"] = np.asarray(r.out, np.int64)
    opt = AdamW(lr=T.LR, grad_clip=T.CLIP)
    b = {{k: jnp.asarray(v) for k, v in T.batch(cfg).items()}}
    b_specs = shd.batch_specs(b, T.BATCH, mesh, ("data",))
    mu = shd.zero1_specs(params, p_specs, ("data",), mesh)
    o_specs = AdamWState(P(), mu, mu)

    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(lm.loss)(params, batch)
        gn = jnp.sqrt(sum(jnp.sum(jnp.square(g))
                          for g in jax.tree.leaves(grads)))
        upd, opt_state = opt.update(grads, opt_state, params)
        return loss, grads, gn, apply_updates(params, upd), opt_state
    shard = (specs, shd.to_shardings(mesh, o_specs),
             shd.to_shardings(mesh, b_specs))
    loss, grads, gn, new, ost = jax.jit(step, in_shardings=shard)(
        ps, jax.device_put(opt.init(params), shard[1]),
        jax.device_put(b, shard[2]))
    out[f"{{key}}/loss"], out[f"{{key}}/gn"] = np.asarray(loss), np.asarray(gn)
    for what, tree in (("grad", grads), ("param", new), ("mu", ost.mu),
                       ("nu", ost.nu)):
        for k, v in port_names(tree).items():
            out[f"{{key}}/{{what}}/{{k}}"] = v
    if shape == (1, 2):
        save_checkpoint({ckpt!r}, T.CKPT_STEP, {{
            "params": new, "opt": ost,
            "ef": jax.device_put(jax.tree.map(
                lambda p: jnp.zeros((), jnp.float32), params), rep)}})
np.savez({path!r}, **out)
print("REF_OK")
"""


def _start_reference(devices: int, path: Path, ckpt: Path, log: Path):
    from benchmarks._mesh import forced_device_env
    env = forced_device_env(devices)
    env["PYTHONPATH"] = os.pathsep.join(
        ["src", str(_REPO)] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    body = ("from benchmarks._mesh import require_devices\n"
            f"if not require_devices({devices}):\n    raise SystemExit(0)\n"
            + _REF_CODE.format(devices=devices, path=str(path),
                               ckpt=str(ckpt)))
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-c", body], stdout=f,
                                stderr=subprocess.STDOUT, env=env,
                                cwd=str(_REPO))


# ---------------------------------------------------------------------------
# The port: one spawn of gloo ranks a mesh
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _port_rank(rank: int, world: int, shape: tuple, params: dict,
               ckpt: str) -> dict:
    """One rank of ``shape``'s mesh: its slices of the reference's
    ``params`` (numpy, made once in the test process), then the drives
    the tests read."""
    from repro_torch.convert import (lm_params_from_reference,
                                     train_state_to_reference)
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import train_specs
    from repro_torch.models.lm import LM, ShardCtx
    from repro_torch.optim.adamw import AdamW, global_sq_norm
    from repro_torch.runtime.server import DecodeServer, Request
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = get_reduced(ARCH)
    mesh = make_host_mesh(shape[1], device="cpu")
    lm = LM(cfg, device="cpu", shard=ShardCtx(mesh))
    lm.load_state_dict(lm_params_from_reference(params, cfg, "cpu",
                                                mesh=mesh))
    toks = torch.from_numpy(tokens(cfg)).long()
    out = {"index": (mesh.get_local_rank("data"),
                     mesh.get_local_rank("model"))}
    with torch.no_grad():
        out["fwd"] = _np(lm.forward(toks))
    caches = lm.init_caches(B, MAX_LEN)
    for t in range(STEPS):
        lg, _ = lm.decode_step(toks[:, t:t + 1], caches)
        out[f"dec/{t}"] = _np(lg)
    caches = lm.init_caches(B, MAX_LEN)
    lg, _ = lm.wave_step(toks[:, :max(WAVE_LENS)].numpy(),
                         np.asarray(WAVE_LENS), caches)
    out["wave"] = _np(lg)
    out["cache"] = [{k: _np(v) for k, v in c.items()} for c in caches]
    out["held"] = {k: tuple(v.shape) for k, v in lm.state_dict().items()}
    srv = DecodeServer(lm, pipeline=False, **SERVER_KW)
    reqs = [Request(prompt=p, max_new_tokens=m) for p, m in requests(cfg)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    out["srv"] = [list(r.out) for r in reqs]
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                      global_batch=BATCH))
    tr = Trainer(lm, data, TrainerConfig(ckpt_dir=ckpt, lr=LR),
                 in_shardings=train_specs(cfg, mesh, BATCH, S))
    tr.opt = AdamW(lr=LR, grad_clip=CLIP)
    state = tr.init_state()
    loss, grads = tr.loss_and_grads(state["params"],
                                    tr.local_batch(batch(cfg)))
    out["gn"] = float(torch.sqrt(global_sq_norm(grads, tr.shards)))
    state["opt"] = tr.opt.apply_(state["params"], grads, state["opt"],
                                 tr.shards)
    out.update(loss=float(loss), grad={k: _np(g) for k, g in grads.items()},
               param={k: _np(p) for k, p in state["params"].items()},
               mu={k: _np(v) for k, v in state["opt"].mu.items()},
               nu={k: _np(v) for k, v in state["opt"].nu.items()},
               zero1=sorted(tr.shards.zero1), repeat=sorted(tr.shards.repeat),
               counted=dict(tr.shards.counted), copies=sorted(tr._copies),
               shards=tr._ckpt_shards())
    tr.ckpt.async_save = False
    tr.ckpt.save(CKPT_STEP, state, transform=lambda t:
                 train_state_to_reference(t, cfg, shards=tr._ckpt_shards()))
    return out


_MEMO: dict = {}


@pytest.fixture
def results(tmp_path_factory) -> dict:
    """``{"ref": the reference's npzs as one dict, "<d>x<m>": [each rank's
    results], "dir": the temporary directory}``: both reference
    subprocesses and the port's three spawns run side by side, once."""
    if "res" not in _MEMO:
        import jax
        from benchmarks._mesh import MESH_SKIP
        from repro.configs import get_reduced as jget_reduced
        from repro.models.lm import LM as JLM
        tmp = tmp_path_factory.mktemp("tp_ssm")
        procs = {n: _start_reference(n, tmp / f"ref{n}.npz", tmp / "ref_ckpt",
                                     tmp / f"ref{n}.log") for n in MESHES}
        res: dict = {"dir": tmp}
        params = jax.tree.map(np.asarray, JLM(jget_reduced(ARCH)).init(
            jax.random.PRNGKey(SEED)))
        try:
            for shape in SHAPES:
                res[tag(shape)] = run_ranks(
                    _port_rank, shape[0] * shape[1],
                    (shape, params, str(tmp / f"ckpt{tag(shape)}")))
            for p in procs.values():
                p.wait(timeout=900)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ref: dict = {}
        for n in MESHES:
            out = (tmp / f"ref{n}.log").read_text()
            if MESH_SKIP in out:
                pytest.skip(f"forced {n}-device CPU mesh not honored: "
                            f"{out.strip().splitlines()[-1]}")
            assert "REF_OK" in out, out[-4000:]
            with np.load(tmp / f"ref{n}.npz") as z:
                ref.update(dict(z))
        res["ref"] = ref
        _MEMO["res"] = res
    return _MEMO["res"]


def _rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _model_ranks(ranks: list) -> list:
    """The ranks of data coordinate 0, in model order."""
    return sorted((r for r in ranks if r["index"][0] == 0),
                  key=lambda r: r["index"][1])


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_forward_matches_the_references_mesh(results, shape):
    ref = results["ref"]
    for res in results[tag(shape)]:
        np.testing.assert_allclose(res["fwd"], ref[f"{tag(shape)}/fwd"],
                                   **MODEL)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_decode_steps_match_the_references_mesh(results, shape, step):
    ref = results["ref"]
    for res in results[tag(shape)]:
        np.testing.assert_allclose(res[f"dec/{step}"],
                                   ref[f"{tag(shape)}/dec/{step}"], **MODEL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_masked_wave_and_its_caches_match_the_references_mesh(results,
                                                              shape):
    """The wave's logits; each rank's caches the rank's slices of the
    reference's (``caches_from_reference(mesh=)``: a mamba layer's
    ``state`` heads and ``conv`` columns, a shared attention layer's K/V
    heads), ``len`` exactly; the ranks'
    caches joined into the reference's tree (``caches_to_reference`` of
    the ranks' caches) are the reference's whole."""
    from repro_torch.convert import caches_to_reference
    from repro_torch.models.lm import layer_kinds
    ref = results["ref"]
    cfg = get_reduced(ARCH)
    key = tag(shape)
    kinds = layer_kinds(cfg)
    for res in results[key]:
        np.testing.assert_allclose(res["wave"], ref[f"{key}/wave"], **MODEL)
        rank = res["index"][1]
        for li, layer in enumerate(res["cache"]):
            assert set(layer) == ({"state", "conv"} if kinds[li] == "mamba"
                                  else {"k", "v", "len"})
            for k, got in layer.items():
                want = ref[f"{key}/rcache/{rank}/{li}/{k}"]
                if k == "len":
                    np.testing.assert_array_equal(got, want)
                else:
                    np.testing.assert_allclose(got, want, **MODEL)
    got = caches_to_reference([[{k: torch.from_numpy(v)
                                 for k, v in c.items()} for c in r["cache"]]
                               for r in _model_ranks(results[key])], cfg)
    want = caches_to_reference([
        {k: torch.from_numpy(ref[f"{key}/cache/{li}/{k}"])
         for k in layer} for li, layer in enumerate(results[key][0]["cache"])],
        cfg)
    import jax
    got_l, want_l = (jax.tree_util.tree_flatten_with_path(t)[0]
                     for t in (got, want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        np.testing.assert_allclose(g, w, err_msg=str(path), **MODEL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_server_tokens_equal_the_references(results, shape):
    ref = results["ref"]
    for res in results[tag(shape)]:
        for i, toks in enumerate(res["srv"]):
            assert toks == ref[f"{tag(shape)}/srv/{i}"].tolist(), i


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_loss_and_clipped_norm_match_the_references_mesh(results, shape):
    ref = results["ref"]
    for res in results[tag(shape)]:
        np.testing.assert_allclose(res["loss"], ref[f"{tag(shape)}/loss"],
                                   **MODEL)
        np.testing.assert_allclose(res["gn"], ref[f"{tag(shape)}/gn"],
                                   rtol=GRAD_REL_L2)
        assert res["gn"] > CLIP


def _gathered(ranks: list, what: str, zero1: set) -> dict:
    """Every leaf of ``what`` joined: the model ranks of data coordinate 0
    by the plan; a ZeRO-1 moment's rows over the data ranks."""
    from repro_torch.convert import lm_params_gathered
    model = _model_ranks(ranks)
    got = lm_params_gathered([{k: torch.from_numpy(v)
                               for k, v in r[what].items()} for r in model],
                             get_reduced(ARCH))
    if what in ("mu", "nu"):
        rows = sorted((r for r in ranks if r["index"][1] == 0),
                      key=lambda r: r["index"][0])
        for k in zero1:
            got[k] = torch.from_numpy(np.concatenate([r[what][k]
                                                      for r in rows]))
    return {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("what", WHAT)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_every_leaf_after_a_step_matches_the_references_mesh(results, shape,
                                                             what):
    """Every gradient leaf within GRAD_REL_L2 relative L2 of the
    reference's, or twice the reference's own relative L2 between this
    mesh and one device where that is larger (``norm_z``'s zero both);
    every parameter and moment after
    the clipped step at F32, the elements whose clipped gradient is within
    ten ``eps`` (1e-8) of zero excepted from the elementwise bound -- there
    AdamW's first step ``g / (|g| + eps)`` amplifies the gradients' 1e-4
    difference -- and those held instead to their leaf's step size (``lr``,
    the most a first step moves a parameter) and counted: under 1 % of the
    leaf."""
    ref = results["ref"]
    key = tag(shape)
    ranks = results[key]
    got = _gathered(ranks, what, set(ranks[0]["zero1"]))
    names = sorted(k for k in ref if k.startswith(f"{key}/{what}/"))
    assert sorted(f"{key}/{what}/{k}" for k in got) == names
    g_ref = {k: ref[f"{key}/grad/{k}"] * min(1.0, CLIP / float(
        ref[f"{key}/gn"])) for k in got}
    for k, v in got.items():
        want = ref[f"{key}/{what}/{k}"]
        if what == "grad":
            if not want.any():
                assert not v.any(), k
                continue
            bound = max(GRAD_REL_L2, 2 * _rel_l2(want, ref[f"one/grad/{k}"]))
            assert _rel_l2(v, want) <= bound, (k, _rel_l2(v, want), bound)
            continue
        tiny = np.abs(g_ref[k]) < 10 * 1e-8
        close = np.isclose(v, want, **F32)
        assert (close | tiny).all(), (what, k, np.abs(v - want)[~tiny].max())
        scale = LR if what == "param" else \
            float(np.abs(want).max()) or 1.0
        assert (np.abs(v - want) <= scale).all(), (what, k)
        assert (~close).mean() < 0.01, (what, k, (~close).mean())


# ---------------------------------------------------------------------------
# The checkpoint both ways
# ---------------------------------------------------------------------------

def _meta(tree):
    from repro_torch.checkpoint.ckpt import tree_map
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def _local_state(res: dict) -> dict:
    from repro_torch.optim.adamw import AdamWState

    def t(tree):
        return {k: torch.from_numpy(v) for k, v in tree.items()}
    return {"params": t(res["param"]),
            "opt": AdamWState(torch.tensor(CKPT_STEP, dtype=torch.int32),
                              t(res["mu"]), t(res["nu"])), "ef": None}


def test_the_references_checkpoint_restores_onto_each_ranks_slices(results):
    """The reference's checkpoint of its stepped state, saved from the
    ``(1, 2)`` mesh, read onto each port rank's placement (``shardings=``):
    every parameter and moment is that rank's slice of the reference's
    state, bit for bit -- a mamba layer's ``w_in`` joined from its four
    segments, B | C on both ranks."""
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    from repro_torch.convert import (train_state_from_reference,
                                     train_state_to_reference)
    from repro_torch.launch.sharding import local_leaf
    ref, cfg = results["ref"], get_reduced(ARCH)
    for res in results["1x2"]:
        place = train_state_to_reference(_meta(_local_state(res)), cfg,
                                         shards=res["shards"])
        tree, step = restore_checkpoint(results["dir"] / "ref_ckpt", place,
                                        shardings=place)
        assert step == CKPT_STEP
        got = train_state_from_reference(tree, cfg, "cpu")
        rank = res["index"][1]
        for what, leaves in (("param", got["params"]),
                             ("mu", got["opt"].mu), ("nu", got["opt"].nu)):
            assert leaves.keys() == res[what].keys()
            for k, v in leaves.items():
                want = local_leaf(torch.from_numpy(ref[f"1x2/{what}/{k}"]),
                                  k, cfg, 2, rank)
                assert torch.equal(v, want), (rank, what, k)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_the_ranks_checkpoint_restores_in_the_reference(results, shape):
    """The port ranks' sharded checkpoint (every rank its segments, a copy
    written once by its first holder; ZeRO-1 moments by their data rows on
    ``(2, 2)``) read by the reference's ``restore_checkpoint`` on one
    device: every leaf bit-equal to the ranks' slices joined."""
    import jax
    from repro.checkpoint import restore_checkpoint as jrestore
    from repro.configs import get_reduced as jget_reduced
    from repro.models.lm import LM as JLM
    from repro.optim.adamw import AdamW as JAdamW
    from repro_torch.convert import lm_params_from_reference
    ranks = results[tag(shape)]
    params = JLM(jget_reduced(ARCH)).init(jax.random.PRNGKey(SEED))
    like = {"params": params, "opt": JAdamW().init(params),
            "ef": jax.tree.map(lambda p: np.zeros((), np.float32), params)}
    back, step = jrestore(results["dir"] / f"ckpt{tag(shape)}", like)
    assert step == CKPT_STEP
    cfg = get_reduced(ARCH)
    zero1 = set(ranks[0]["zero1"])
    for what, tree in (("param", back["params"]), ("mu", back["opt"].mu),
                       ("nu", back["opt"].nu)):
        want = _gathered(ranks, what, zero1)
        got = lm_params_from_reference(jax.tree.map(np.asarray, tree), cfg,
                                       "cpu")
        assert got.keys() == want.keys()
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), want[k],
                                          err_msg=f"{what} {k}")
    assert int(np.asarray(back["opt"].step)) == CKPT_STEP


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_the_ranks_agree_and_hold_the_plans_slices(results, shape):
    """Every output bit-equal across the ranks; each rank holds its SSM
    heads' leaves and the shared set's heads (4 heads, 16 wide)."""
    ranks = results[tag(shape)]
    cfg = get_reduced(ARCH)
    n = shape[1]
    for key in ["fwd", "wave"] + [f"dec/{t}" for t in range(STEPS)]:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)
    for r in ranks[1:]:
        assert r["srv"] == ranks[0]["srv"] and r["loss"] == ranks[0]["loss"]
    h, ns, d = cfg.num_heads // n, cfg.ssm_state, cfg.d_model
    per = 2 * d // cfg.num_heads
    held = ranks[0]["held"]
    assert held["blocks.0.mamba.w_in"] == (d, 2 * h * per + 2 * ns + h)
    assert held["blocks.0.mamba.conv_w"] == (4, h * per)
    assert held["blocks.0.mamba.w_out"] == (h * per, d)
    assert held["blocks.0.mamba.A_log"] == (h,)
    assert held["blocks.0.mamba.norm_z"] == (2 * d,)
    assert held["shared.attn.wq"] == (d, h * cfg.hd)
    assert held["shared.attn.wo"] == (h * cfg.hd, d)
    assert held["shared.mlp.wi_up"] == (d, cfg.d_ff // n)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_the_b_c_copies_stay_bit_equal_and_count_once(results, shape):
    """Every rank's B | C columns of each mamba layer's ``w_in`` -- their
    gradient, stepped value and moments -- are the same bits on every
    rank; rank 0 writes and counts them, the others count only their own
    columns (``Shards.counted``); the global norm each rank computed is
    the joined gradient's, B | C counted once."""
    ranks = results[tag(shape)]
    cfg = get_reduced(ARCH)
    n, ns = shape[1], cfg.ssm_state
    per = 2 * cfg.d_model // cfg.num_heads
    di = per * cfg.num_heads // n
    bc = slice(2 * di, 2 * di + 2 * ns)
    names = [k for k in ranks[0]["param"] if k.endswith("mamba.w_in")]
    assert len(names) == 6
    for what in WHAT:
        for k in names:
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[what][k][:, bc],
                                              ranks[0][what][k][:, bc])
    for r in ranks:
        first = r["index"][1] == 0
        assert not r["copies"] and not r["repeat"]
        assert set(r["counted"]) == (set() if first else set(names))
        for k in names if not first else ():
            dim, spans = r["counted"][k]
            assert dim == 1 and bc.start not in [lo for lo, _ in spans]
            assert sum(hi - lo for lo, hi in spans) == 2 * di + di // per
    g = _gathered(ranks, "grad", set())
    want = float(np.sqrt(sum(np.sum(np.square(v.astype(np.float64)))
                             for v in g.values())))
    for r in ranks:
        np.testing.assert_allclose(r["gn"], want, rtol=1e-6)


def _leaves(cfg) -> dict:
    from repro_torch.models.lm import LM
    return LM(cfg, device="cpu", seed=SEED).state_dict()


@pytest.mark.parametrize("n", (2, 4, 8, 16))
def test_the_ranks_slices_join_to_every_leaf_bit_for_bit(n):
    """Reduced zamba2's ``state_dict`` cut by ``local_leaf`` for every rank
    of a model axis of ``n`` (at 8 and 16 some ranks hold no SSM head and
    copy a KV head) and joined by ``join_leaf``: every leaf back, bit for
    bit, each written segment exactly once."""
    from repro_torch.launch.sharding import join_leaf, leaf_blocks, local_leaf
    cfg = get_reduced(ARCH)
    for k, t in _leaves(cfg).items():
        blk = leaf_blocks(k, tuple(t.shape), cfg, n)
        parts = [local_leaf(t, k, cfg, n, r).clone() for r in range(n)]
        assert torch.equal(join_leaf(parts, blk), t), k
        if blk is not None:
            written = sorted((lo, hi) for segs in blk.segments
                             for lo, hi, w in segs if w)
            assert [lo for lo, _ in written] == \
                [0] + [hi for _, hi in written[:-1]], k
            assert written[-1][1] == blk.size, k


@pytest.mark.parametrize("n", (2, 4, 16))
def test_the_full_configs_leaves_follow_the_plan_on_meta(n):
    """zamba2-7b at its published widths, one rank of each of ``n`` built
    on the dry run's meta mesh: every leaf's shape is the width
    ``leaf_blocks`` gives the rank, and the written segments of every
    split leaf cover its dim exactly once."""
    from repro_torch.configs import get_config
    from repro_torch.core.shard_plan import DryMesh
    from repro_torch.launch.sharding import leaf_blocks
    from repro_torch.models.lm import LM, ShardCtx
    cfg = get_config(ARCH)
    full = {k: tuple(t.shape) for k, t in
            LM(cfg, device="meta").state_dict().items()}
    for rank in sorted({0, n - 1}):
        lm = LM(cfg, device="meta", shard=ShardCtx(
            DryMesh({"data": 1, "model": n}, rank)))
        for k, t in lm.state_dict().items():
            blk = leaf_blocks(k, full[k], cfg, n)
            want = list(full[k])
            if blk is not None:
                want[blk.dim] = sum(hi - lo
                                    for lo, hi, _ in blk.segments[rank])
                written = sorted((lo, hi) for segs in blk.segments
                                 for lo, hi, w in segs if w)
                assert sum(hi - lo for lo, hi in written) == blk.size, k
                assert len(set(written)) == len(written), k
            assert tuple(t.shape) == tuple(want), k
        assert lm.blocks[0].mamba["A_log"].shape == (32 // n,)


@pytest.mark.parametrize("heads,n", [(32, 3), (32, 5), (4, 3), (4, 8),
                                     (32, 64), (32, 16)])
def test_ssm_plan_takes_whole_contiguous_heads_at_any_axis(heads, n):
    """``ssm_plan`` at axes that do not divide the heads: whole heads,
    contiguous, in rank order, earlier ranks the larger blocks (one more
    at most), every head once; past the head count a rank holds none."""
    import dataclasses
    from repro_torch.launch.sharding import ssm_plan
    cfg = dataclasses.replace(get_reduced(ARCH), num_heads=heads)
    plans = [ssm_plan(cfg, n, r) for r in range(n)]
    sizes = [h1 - h0 for h0, h1 in plans]
    assert sum(sizes) == heads and max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)
    at = 0
    for h0, h1 in plans:
        if h1 > h0:
            assert h0 == at
            at = h1
    assert at == heads


def test_zamba2_splits_and_xlstm_still_refuses():
    """``LM(shard=)`` builds zamba2 on a model axis that splits its vocab
    and d_ff (the shared MLP's) and refuses one that does not; xLSTM's
    kinds still raise, naming ROADMAP item 6d-2 b."""
    import dataclasses
    from repro_torch.core.shard_plan import DryMesh
    from repro_torch.models.lm import LM, ShardCtx
    cfg = get_reduced(ARCH)

    def dry(c, n):
        return LM(c, device="meta", shard=ShardCtx(
            DryMesh({"data": 1, "model": n}, 0)))
    assert dry(cfg, 4).tp.size == 4
    with pytest.raises(ValueError, match="d_ff"):
        dry(dataclasses.replace(cfg, d_ff=130), 4)
    with pytest.raises(NotImplementedError, match="6d-2 b"):
        dry(get_reduced("xlstm-1.3b"), 2)


def test_a_rank_without_ssm_heads_makes_the_same_collectives():
    """Over a model axis of 8, wider than reduced zamba2's 4 SSM heads (at
    64-wide attention heads, a kernel width), rank 7 holds no SSM head and
    no query head: on the dry run's meta mesh its forward, loss backward
    and decode step run, keep every output's shape, and make exactly the
    collectives rank 0 makes -- so no rank would wait on another."""
    import dataclasses
    from repro_torch.core.shard_plan import DryMesh
    from repro_torch.models.lm import LM, ShardCtx
    cfg = dataclasses.replace(get_reduced(ARCH), d_model=256, d_ff=512)
    made = {}
    for rank in (0, 7):
        lm = LM(cfg, device="meta", shard=ShardCtx(
            DryMesh({"data": 1, "model": 8}, rank)))
        toks = torch.zeros((B, S), dtype=torch.long, device="meta")
        with torch.no_grad():
            assert lm.forward(toks).shape == (B, S, cfg.d_model)
        lm.requires_grad_(True)
        lm.loss(toks, toks).backward()
        caches = lm.init_caches(B, MAX_LEN)
        lg, _ = lm.decode_step(toks[:, :1], caches)
        assert lg.shape == (B, 1, cfg.vocab_size)
        made[rank] = dict(lm.collective_stats)
        heads = lm.blocks[0].mamba["A_log"].shape[0]
        assert heads == (1 if rank == 0 else 0)
        assert caches[0]["state"].shape[1] == heads
    assert made[0]["collectives"] == made[7]["collectives"] > 0
