"""Model-parallel training of the port's LM against the JAX package's
sharded train step.

The reference runs in two subprocesses, one a device count (a forced
2-device CPU platform for the meshes ``(1, 2)`` and ``(2, 1)``, a forced
4-device one for ``(2, 2)``, plain and with ZeRO-1 opt shardings), each
started in the background as the ``run_on_mesh`` fixture starts its
child: for reduced chatglm3-6b (``dense``) and h2o-danube-1.8b
(``dense_local``), both fp32, ``jax.value_and_grad(lm.loss)`` of
``LM(cfg, ShardCtx(mesh))`` on the mesh-placed params and batch, then
``opt.update`` + ``apply_updates`` (as ``launch.steps.build_train_bundle``
places them), and ``xent_vocab_parallel`` alone.  The port runs the same
on gloo ranks on the CPU (``launch.mesh.run_ranks``, one spawn a mesh;
each rank loads its slices of the reference's weights with ``convert``)
through its ``Trainer`` (``loss_and_grads``, then ``AdamW.apply_`` with
the trainer's shards).  Held at the reference tests' f32 bound (2e-5):
the loss, every leaf's gradient (the ranks' slices joined), the params
and both moments after one step whose clipping engages (the global norm
is asserted above ``CLIP``), and the cross entropy's value and
gradients.  The ranks agree bit for bit.
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

F32 = dict(rtol=2e-5, atol=2e-5)
ARCHS = ("chatglm3-6b", "h2o-danube-1.8b")
#: (data, model) meshes by forced device count
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
#: the cases: a mesh, and whether the opt specs are ZeRO-1's
CASES = (((1, 2), False), ((2, 1), False), ((2, 2), False), ((2, 2), True))
SEED, BATCH, SEQ, LR = 3, 4, 16, 1e-3
#: a clipping bound below the initial gradients' global norm, so the
#: clipped step scales every gradient (asserted)
CLIP = 0.05
_REPO = Path(__file__).resolve().parent.parent


def tag(mesh: tuple, zero1: bool) -> str:
    return f"{mesh[0]}x{mesh[1]}" + ("z" if zero1 else "")


def batch(cfg) -> dict:
    """The global batch: step 0 of the port's synthetic token stream."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    return SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=SEQ,
                                      global_batch=BATCH)).batch_at(0)


def xent_inputs(cfg) -> tuple:
    rng = np.random.default_rng(19)
    x = rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32)
    table = (0.1 * rng.standard_normal((cfg.padded_vocab, cfg.d_model))
             ).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return x, table, labels


# ---------------------------------------------------------------------------
# The reference: one subprocess a device count
# ---------------------------------------------------------------------------

_REF_CODE = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, "tests")
import test_torch_mp_train as T
from repro.configs import get_reduced
from repro.core import embedding_engine as jee
from repro.launch import sharding as shd
from repro.launch.mesh import axis_types_kw
from repro.models.lm import LM, ShardCtx
from repro.optim.adamw import AdamW, AdamWState, apply_updates
from repro_torch.convert import lm_params_from_reference

out = {{}}


def port_names(tree):
    return {{k: v.numpy() for k, v in lm_params_from_reference(
        jax.tree.map(np.asarray, tree), cfg, "cpu").items()}}


for mesh_shape in T.MESHES[{devices}]:
    mesh = jax.make_mesh(mesh_shape, ("data", "model"), **axis_types_kw(2))
    for arch in T.ARCHS:
        cfg = get_reduced(arch)
        params = LM(cfg).init(jax.random.PRNGKey(T.SEED))
        p_specs = shd.sanitize_specs(shd.param_specs(params), params, mesh)
        b = {{k: jnp.asarray(v) for k, v in T.batch(cfg).items()}}
        b_specs = shd.batch_specs(b, T.BATCH, mesh, ("data",))
        lm = LM(cfg, ShardCtx(mesh=mesh, data_axes=("data",)))
        opt = AdamW(lr=T.LR, grad_clip=T.CLIP)
        for zero1 in (False, True) if mesh_shape == (2, 2) else (False,):
            mu = (shd.zero1_specs(params, p_specs, ("data",), mesh)
                  if zero1 else p_specs)
            o_specs = AdamWState(jax.sharding.PartitionSpec(), mu, mu)

            def step(params, opt_state, batch):
                loss, grads = jax.value_and_grad(lm.loss)(params, batch)
                gn = jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in
                                  jax.tree.leaves(grads)))
                upd, opt_state = opt.update(grads, opt_state, params)
                return loss, grads, gn, apply_updates(params, upd), opt_state
            shard = (shd.to_shardings(mesh, p_specs),
                     shd.to_shardings(mesh, o_specs),
                     shd.to_shardings(mesh, b_specs))
            ps = jax.device_put(params, shard[0])
            loss, grads, gn, new, ost = jax.jit(step, in_shardings=shard)(
                ps, jax.device_put(opt.init(params), shard[1]),
                jax.device_put(b, shard[2]))
            key = f"{{T.tag(mesh_shape, zero1)}}/{{arch}}"
            out[f"{{key}}/loss"], out[f"{{key}}/gn"] = np.asarray(loss), \\
                np.asarray(gn)
            for what, tree in (("grad", grads), ("param", new),
                               ("mu", ost.mu), ("nu", ost.nu)):
                for k, v in port_names(tree).items():
                    out[f"{{key}}/{{what}}/{{k}}"] = v
        x, table, labels = T.xent_inputs(cfg)
        fn = jax.value_and_grad(
            lambda x_, t_: jee.xent_vocab_parallel(
                x_, t_, jnp.asarray(labels), mesh=mesh, vocab_axis="model",
                data_axes=("data",)), argnums=(0, 1))
        loss, (dx, dt) = jax.jit(fn)(jnp.asarray(x), jnp.asarray(table))
        key = f"{{T.tag(mesh_shape, False)}}/{{arch}}/xent"
        out[f"{{key}}/loss"], out[f"{{key}}/dx"], out[f"{{key}}/dt"] = \\
            np.asarray(loss), np.asarray(dx), np.asarray(dt)
np.savez({path!r}, **out)
print("REF_OK")
"""


def _start_reference(devices: int, path: Path, log: Path):
    from benchmarks._mesh import forced_device_env
    env = forced_device_env(devices)
    env["PYTHONPATH"] = os.pathsep.join(
        ["src", str(_REPO)] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    body = ("from benchmarks._mesh import require_devices\n"
            f"if not require_devices({devices}):\n    raise SystemExit(0)\n"
            + _REF_CODE.format(devices=devices, path=str(path)))
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-c", body], stdout=f,
                                stderr=subprocess.STDOUT, env=env,
                                cwd=str(_REPO))


# ---------------------------------------------------------------------------
# The port: one spawn of gloo ranks a mesh
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _port_rank(rank: int, world: int, mesh_shape: tuple, zeros: tuple,
               ckpt: str) -> dict:
    import jax
    from repro.configs import get_reduced as jget_reduced
    from repro.models.lm import LM as JLM
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.core import embedding_engine as ee
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import train_specs
    from repro_torch.models.lm import LM, ShardCtx
    from repro_torch.optim.adamw import AdamW, global_sq_norm
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    mesh = make_host_mesh(mesh_shape[1], device="cpu")
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    out = {}
    for arch in ARCHS:
        cfg = get_reduced(arch)
        params = jax.tree.map(np.asarray, JLM(jget_reduced(arch)).init(
            jax.random.PRNGKey(SEED)))
        data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=BATCH))
        for zero1 in zeros:
            lm = LM(cfg, device="cpu", shard=ShardCtx(mesh))
            lm.load_state_dict(lm_params_from_reference(params, cfg, "cpu",
                                                        mesh=mesh))
            tr = Trainer(lm, data, TrainerConfig(ckpt_dir=ckpt, lr=LR),
                         in_shardings=train_specs(cfg, mesh, BATCH, SEQ,
                                                  zero1=zero1))
            tr.opt = AdamW(lr=LR, grad_clip=CLIP)
            state = tr.init_state()
            loss, grads = tr.loss_and_grads(
                state["params"], tr.local_batch(tr.data.batch_at(0)))
            gn = float(torch.sqrt(global_sq_norm(grads, tr.shards)))
            state["opt"] = tr.opt.apply_(state["params"], grads,
                                         state["opt"], tr.shards)
            out[f"{tag(mesh_shape, zero1)}/{arch}"] = {
                "loss": float(loss), "gn": gn,
                "grad": {k: _np(g) for k, g in grads.items()},
                "param": {k: _np(p) for k, p in state["params"].items()},
                "mu": {k: _np(v) for k, v in state["opt"].mu.items()},
                "nu": {k: _np(v) for k, v in state["opt"].nu.items()},
                "zero1": sorted(tr.shards.zero1)}
        x, table, labels = xent_inputs(cfg)
        v = table.shape[0] // mesh_shape[1]
        b = BATCH // mesh_shape[0]
        xl = torch.from_numpy(x[d * b:(d + 1) * b]).requires_grad_()
        tl = torch.from_numpy(table[m * v:(m + 1) * v]).requires_grad_()
        loss = ee.xent_vocab_parallel(
            xl, tl, torch.from_numpy(labels[d * b:(d + 1) * b]), mesh=mesh,
            vocab_axis="model", data_axes=("data",))
        loss.backward()
        out[f"{tag(mesh_shape, False)}/{arch}/xent"] = {
            "loss": float(loss.detach()), "dx": _np(xl.grad),
            "dt": _np(tl.grad)}
    return out


_MEMO: dict = {}


@pytest.fixture
def results(tmp_path_factory) -> tuple:
    """(the reference's npz as one dict, ``{case tag: [each rank's
    results]}``): the two reference subprocesses and the port's spawns run
    side by side, once."""
    if "res" not in _MEMO:
        from benchmarks._mesh import MESH_SKIP
        tmp = tmp_path_factory.mktemp("mp")
        procs = {n: _start_reference(n, tmp / f"ref{n}.npz",
                                     tmp / f"ref{n}.log") for n in MESHES}
        port: dict = {}
        try:
            for shape in ((1, 2), (2, 1), (2, 2)):
                zeros = (False, True) if shape == (2, 2) else (False,)
                ranks = run_ranks(_port_rank, shape[0] * shape[1],
                                  (shape, zeros, str(tmp / "ckpt")))
                for key in ranks[0]:
                    port[key] = [r[key] for r in ranks]
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
        _MEMO["res"] = (ref, port)
    return _MEMO["res"]


def _joined(ranks: list, shape: tuple, what: str, name: str,
            zero1: set) -> np.ndarray:
    """The global leaf from the ranks' slices: the model-axis ranks of
    data coordinate 0 joined along the dim the spec splits; a ZeRO-1
    moment's rows joined over the data ranks (model coordinate 0)."""
    from repro_torch.launch.sharding import concat_shards, param_spec
    dd, mm = shape
    if what in ("mu", "nu") and name in zero1:
        return np.concatenate([ranks[d * mm][what][name]
                               for d in range(dd)])
    parts = [torch.from_numpy(ranks[m][what][name]) for m in range(mm)]
    return concat_shards(parts, param_spec(name, parts[0].dim())).numpy()


IDS = [tag(m, z) for m, z in CASES]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_loss_and_clipped_norm_match_the_references_mesh(results, case,
                                                         arch):
    ref, port = results
    key = f"{tag(*case)}/{arch}"
    for r in port[key]:
        np.testing.assert_allclose(r["loss"], ref[f"{key}/loss"], **F32)
        np.testing.assert_allclose(r["gn"], ref[f"{key}/gn"], **F32)
        assert r["gn"] > CLIP          # the step's clipping engaged


@pytest.mark.parametrize("what", ("grad", "param", "mu", "nu"))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_every_leaf_matches_the_references_mesh(results, case, arch, what):
    """Every gradient, and every parameter and moment after the clipped
    step, the ranks' slices joined, against the reference's leaf."""
    ref, port = results
    key = f"{tag(*case)}/{arch}"
    ranks = port[key]
    zero1 = set(ranks[0]["zero1"])
    assert bool(zero1) == case[1]
    names = sorted(ranks[0][what])
    assert len(names) == len([k for k in ref if
                              k.startswith(f"{key}/{what}/")])
    for name in names:
        got = _joined(ranks, case[0], what, name, zero1)
        np.testing.assert_allclose(got, ref[f"{key}/{what}/{name}"],
                                   err_msg=f"{what} {name}", **F32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_ranks_agree_bit_for_bit(results, case, arch):
    """Losses equal on every rank; every leaf equal on the ranks that hold
    the same slice of it (the data ranks of a model coordinate, and every
    rank for a replicated leaf)."""
    from repro_torch.launch.sharding import param_spec
    ranks = results[1][f"{tag(*case)}/{arch}"]
    dd, mm = case[0]
    zero1 = set(ranks[0]["zero1"])
    assert len({r["loss"] for r in ranks}) == 1
    for what in ("grad", "param", "mu", "nu"):
        for name, v in ranks[0][what].items():
            split = any(a is not None for a in param_spec(name, v.ndim))
            for r, res in enumerate(ranks):
                d, m = divmod(r, mm)
                if what in ("mu", "nu") and name in zero1:
                    same = ranks[d * mm]
                else:
                    same = ranks[m] if split else ranks[0]
                np.testing.assert_array_equal(res[what][name],
                                              same[what][name],
                                              err_msg=f"{what} {name} {r}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", ((1, 2), (2, 1), (2, 2)),
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_xent_vocab_parallel_alone_matches_the_reference(results, mesh,
                                                         arch):
    """The cross entropy's value and its gradients: dx of the rank's data
    block (the reference's global-mean gradient is the rank's own tokens'
    mean's over the data width) and dtable of its vocab rows (meaned over
    the data ranks)."""
    ref, port = results
    key = f"{tag(mesh, False)}/{arch}/xent"
    ranks = port[key]
    dd, mm = mesh
    b = BATCH // dd
    v = ref[f"{key}/dt"].shape[0] // mm
    for r, res in enumerate(ranks):
        d, m = divmod(r, mm)
        np.testing.assert_allclose(res["loss"], ref[f"{key}/loss"], **F32)
        np.testing.assert_allclose(res["dx"] / dd,
                                   ref[f"{key}/dx"][d * b:(d + 1) * b],
                                   **F32)
        dt = np.mean([ranks[e * mm + m]["dt"] for e in range(dd)], axis=0)
        np.testing.assert_allclose(dt, ref[f"{key}/dt"][m * v:(m + 1) * v],
                                   **F32)


def test_the_moe_loss_over_a_mesh_and_compression_raise(tmp_path):
    """An MoE model's loss over a mesh runs and its backward reaches the
    experts (expert-parallel training; it raised, naming item 6e, before
    ``tests/test_torch_ep_train.py`` held it to the reference, and the
    test keeps its name); gradient compression over a mesh (item 6f)
    raises before any work; param specs that disagree with the LM's
    layout raise."""
    res = run_ranks(_refusals, 2, (str(tmp_path),))
    for r in res:
        assert r["moe"] == "ran: a finite loss, every expert reached", \
            r["moe"]
        assert "item 6f" in r["compress"], r["compress"]
        assert "disagree with the LM's layout" in r["specs"], r["specs"]


def _refusals(rank: int, world: int, ckpt: str) -> dict:
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import train_specs
    from repro_torch.models.lm import LM, ShardCtx
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    mesh = make_host_mesh(world, device="cpu")
    out = {}
    moe = LM(get_reduced("qwen3-moe-235b-a22b"), device="cpu",
             shard=ShardCtx(mesh)).requires_grad_(True)
    toks = torch.arange(8, dtype=torch.long)[None]
    try:
        loss = moe.loss(toks, toks)
        loss.backward()
        reached = all(p.grad is not None and bool(p.grad.any())
                      for k, p in moe.named_parameters() if ".moe." in k)
        out["moe"] = (f"ran: a {'' if torch.isfinite(loss) else 'non-'}"
                      f"finite loss, "
                      f"{'every' if reached else 'not every'} expert reached")
    except NotImplementedError as e:
        out["moe"] = str(e)
    cfg = get_reduced("h2o-danube-1.8b")
    lm = LM(cfg, device="cpu", shard=ShardCtx(mesh))
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=8, global_batch=2))
    for key, kw in (("compress", {"tcfg": TrainerConfig(
                        ckpt_dir=ckpt, grad_compression=True)}),
                    ("specs", {"tcfg": TrainerConfig(ckpt_dir=ckpt),
                               "in_shardings": _wrong(train_specs(
                                   cfg, mesh, 2, 8))})):
        try:
            Trainer(lm, data, kw["tcfg"],
                    in_shardings=kw.get("in_shardings"))
            out[key] = "nothing"
        except (NotImplementedError, ValueError) as e:
            out[key] = str(e)
    return out


def _wrong(specs: tuple) -> tuple:
    p, o, b = specs
    p = dict(p)
    p["blocks.0.attn.wq"] = ("model", None)
    return p, o, b
