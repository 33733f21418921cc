"""Expert-parallel training of the port's LM against the JAX package's
sharded train step.

Reduced qwen3-moe-235b-a22b (``moe``: GQA attention + the routed experts)
and DeepSeek-V2-Lite (``mla`` + routed and shared experts), both fp32, on
the meshes ``(1, 2)``, ``(2, 1)``, ``(2, 2)`` and ``(2, 2)`` with ZeRO-1
moments, and once more on ``(1, 2)`` with a sequence that does not divide
by 2 (``1x2r``: the replicated-token expert path instead of the seq-split
one).  The reference runs in one subprocess a forced device count, started
in the background as the ``run_on_mesh`` fixture starts its child:
``jax.value_and_grad(lm.loss)`` of ``LM(cfg, ShardCtx(mesh))`` on the
mesh-placed params and batch, then ``opt.update`` + ``apply_updates``
(as ``launch.steps.build_train_bundle`` places them); the ZeRO-1 case
saves its stepped state as a sharded checkpoint.  The port runs the same
on gloo ranks on the CPU (``launch.mesh.run_ranks``, one spawn a mesh;
each rank loads its slices of the reference's weights with ``convert``)
through its ``Trainer`` (``loss_and_grads``, then ``AdamW.apply_`` with
the trainer's shards); its ZeRO-1 ranks save theirs.

Held at the reference tests' f32 bound (2e-5): the loss, every leaf's
gradient (the ranks' slices joined by the plan), the params and both
moments after one step whose clipping engages (the global norm is asserted
above ``CLIP``).  No expert leaf's gradient is all zeros, and the ranks
agree bit for bit.  Each case asserts that its smallest router margin --
the k-th routed probability over the (k+1)-th, at every MoE layer of the
port's forward -- lies above ``MARGIN``, so that agreement means the same
experts were chosen (on these seeds the smallest is 6.8e-5, the
replicated-token qwen3-moe case's, so no case needs its routing pinned).
The sharded checkpoints cross: the reference restores
the port ranks' one on one device, and the port restores the reference's
onto each rank's slices, leaf for leaf bit-equal to the state saved.
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
ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-lite-16b")
#: the cases: (data, model) mesh, ZeRO-1 moments, sequence length
SEQ, SEQ_ODD = 16, 15
CASES = {"1x2": ((1, 2), False, SEQ), "2x1": ((2, 1), False, SEQ),
         "2x2": ((2, 2), False, SEQ), "2x2z": ((2, 2), True, SEQ),
         "1x2r": ((1, 2), False, SEQ_ODD)}
#: forced device count -> its cases
DEVICES = {2: ("1x2", "2x1", "1x2r"), 4: ("2x2", "2x2z")}
#: the case whose stepped state crosses as a sharded checkpoint
CKPT_CASE = "2x2z"
SEED, BATCH, LR = 3, 4, 1e-3
#: a clipping bound below the initial gradients' global norm (asserted)
CLIP = 0.05
#: the smallest router margin (k-th over (k+1)-th probability) under which
#: a routing decision is too close to call across frameworks
MARGIN = 1e-5
_REPO = Path(__file__).resolve().parent.parent


def batch(cfg, seq: int) -> dict:
    """The global batch: step 0 of the port's synthetic token stream."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    return SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=seq,
                                      global_batch=BATCH)).batch_at(0)


# ---------------------------------------------------------------------------
# The reference: one subprocess a device count
# ---------------------------------------------------------------------------

_REF_CODE = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, "tests")
import test_torch_ep_train as T
from repro.checkpoint import save_checkpoint
from repro.configs import get_reduced
from repro.launch import sharding as shd
from repro.launch.mesh import axis_types_kw
from repro.models.lm import LM, ShardCtx
from repro.optim.adamw import AdamW, AdamWState, apply_updates
from repro_torch.convert import lm_params_from_reference

out = {{}}


def port_names(tree):
    return {{k: v.numpy() for k, v in lm_params_from_reference(
        jax.tree.map(np.asarray, tree), cfg, "cpu").items()}}


for case in T.DEVICES[{devices}]:
    mesh_shape, zero1, seq = T.CASES[case]
    mesh = jax.make_mesh(mesh_shape, ("data", "model"), **axis_types_kw(2))
    for arch in T.ARCHS:
        cfg = get_reduced(arch)
        params = LM(cfg).init(jax.random.PRNGKey(T.SEED))
        p_specs = shd.sanitize_specs(shd.param_specs(params), params, mesh)
        b = {{k: jnp.asarray(v) for k, v in T.batch(cfg, seq).items()}}
        b_specs = shd.batch_specs(b, T.BATCH, mesh, ("data",))
        lm = LM(cfg, ShardCtx(mesh=mesh, data_axes=("data",)))
        opt = AdamW(lr=T.LR, grad_clip=T.CLIP)
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
        key = f"{{case}}/{{arch}}"
        out[f"{{key}}/loss"], out[f"{{key}}/gn"] = np.asarray(loss), \\
            np.asarray(gn)
        for what, tree in (("grad", grads), ("param", new),
                           ("mu", ost.mu), ("nu", ost.nu)):
            for k, v in port_names(tree).items():
                out[f"{{key}}/{{what}}/{{k}}"] = v
        if case == T.CKPT_CASE:
            save_checkpoint({ckpt!r} + "/" + arch, 1, {{
                "params": new, "opt": ost,
                "ef": jax.tree.map(lambda _: jnp.zeros((), jnp.float32),
                                   new)}})
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


def _routing(margins: list):
    """``moe.route`` and its stand-in recording each call's smallest margin
    (the k-th probability over the (k+1)-th, fp32)."""
    from repro_torch.models import moe
    route = moe.route

    def recorded(x2d, router, k):
        probs, topw, tope = route(x2d, router, k)
        top = torch.topk(probs.detach(), k + 1, dim=-1).values
        margins.append(float((top[:, k - 1] - top[:, k]).min()))
        return probs, topw, tope
    return route, recorded


def _port_rank(rank: int, world: int, cases: tuple, ckpt: str) -> dict:
    import jax
    from repro.configs import get_reduced as jget_reduced
    from repro.models.lm import LM as JLM
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.convert import (lm_params_from_reference,
                                     train_state_to_reference)
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import train_specs
    from repro_torch.models import moe
    from repro_torch.models.lm import LM, ShardCtx
    from repro_torch.optim.adamw import AdamW, global_sq_norm
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    out = {}
    for case in cases:
        mesh_shape, zero1, seq = CASES[case]
        mesh = make_host_mesh(mesh_shape[1], device="cpu")
        for arch in ARCHS:
            cfg = get_reduced(arch)
            params = jax.tree.map(np.asarray, JLM(jget_reduced(arch)).init(
                jax.random.PRNGKey(SEED)))
            data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                              seq_len=seq,
                                              global_batch=BATCH))
            lm = LM(cfg, device="cpu", shard=ShardCtx(mesh))
            lm.load_state_dict(lm_params_from_reference(params, cfg, "cpu",
                                                        mesh=mesh))
            tr = Trainer(lm, data, TrainerConfig(ckpt_dir=ckpt, lr=LR),
                         in_shardings=train_specs(cfg, mesh, BATCH, seq,
                                                  zero1=zero1))
            tr.opt = AdamW(lr=LR, grad_clip=CLIP)
            state = tr.init_state()
            margins: list = []
            route, routed = _routing(margins)
            moe.route = routed
            try:
                loss, grads = tr.loss_and_grads(
                    state["params"], tr.local_batch(tr.data.batch_at(0)))
            finally:
                moe.route = route
            gn = float(torch.sqrt(global_sq_norm(grads, tr.shards)))
            state["opt"] = tr.opt.apply_(state["params"], grads,
                                         state["opt"], tr.shards)
            if case == CKPT_CASE:
                save_checkpoint(f"{ckpt}/{arch}", 1, train_state_to_reference(
                    state, cfg, shards=tr._ckpt_shards()))
            out[f"{case}/{arch}"] = {
                "loss": float(loss), "gn": gn, "margin": min(margins),
                "routes": len(margins),
                "grad": {k: _np(g) for k, g in grads.items()},
                "param": {k: _np(p) for k, p in state["params"].items()},
                "mu": {k: _np(v) for k, v in state["opt"].mu.items()},
                "nu": {k: _np(v) for k, v in state["opt"].nu.items()},
                "zero1": sorted(tr.shards.zero1),
                "split": sorted(tr.shards.split)}
    return out


_MEMO: dict = {}


@pytest.fixture
def results(tmp_path_factory) -> tuple:
    """(the reference's npzs as one dict, ``{"<case>/<arch>": [each rank's
    results]}``, the checkpoints' directory): both reference subprocesses
    and the port's spawns run side by side, once."""
    if "res" not in _MEMO:
        from benchmarks._mesh import MESH_SKIP
        tmp = tmp_path_factory.mktemp("ep")
        procs = {n: _start_reference(n, tmp / f"ref{n}.npz", tmp / "ref_ckpt",
                                     tmp / f"ref{n}.log") for n in DEVICES}
        port: dict = {}
        try:
            for shape in ((1, 2), (2, 1), (2, 2)):
                cases = tuple(c for c, v in CASES.items() if v[0] == shape)
                ranks = run_ranks(_port_rank, shape[0] * shape[1],
                                  (cases, str(tmp / "port_ckpt")))
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
        for n in DEVICES:
            out = (tmp / f"ref{n}.log").read_text()
            if MESH_SKIP in out:
                pytest.skip(f"forced {n}-device CPU mesh not honored: "
                            f"{out.strip().splitlines()[-1]}")
            assert "REF_OK" in out, out[-4000:]
            with np.load(tmp / f"ref{n}.npz") as z:
                ref.update(dict(z))
        _MEMO["res"] = (ref, port, tmp)
    return _MEMO["res"]


def _joined(ranks: list, case: str, arch: str, what: str) -> dict:
    """Every global leaf of ``what`` from the ranks' slices: the model-axis
    ranks of data coordinate 0 joined by the plan
    (``convert.lm_params_gathered``); a ZeRO-1 moment's rows joined over
    the data ranks (model coordinate 0)."""
    from repro_torch.convert import lm_params_gathered
    (dd, mm), _, _ = CASES[case]
    got = {k: v.numpy() for k, v in lm_params_gathered(
        [{k: torch.from_numpy(v) for k, v in r[what].items()}
         for r in ranks[:mm]], get_reduced(arch)).items()}
    if what in ("mu", "nu"):
        for name in ranks[0]["zero1"]:
            got[name] = np.concatenate([ranks[d * mm][what][name]
                                        for d in range(dd)])
    return got


def _port(results, case: str, arch: str) -> list:
    return results[1][f"{case}/{arch}"]


IDS = list(CASES)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", IDS)
def test_loss_and_clipped_norm_match_the_references_mesh(results, case,
                                                         arch):
    """The loss (cross entropy + 0.01 x the aux meaned over the mesh) and
    the global gradient norm; the routing's smallest margin above
    MARGIN at every MoE layer."""
    ref, _, _ = results
    key = f"{case}/{arch}"
    for r in _port(results, case, arch):
        np.testing.assert_allclose(r["loss"], ref[f"{key}/loss"], **F32)
        np.testing.assert_allclose(r["gn"], ref[f"{key}/gn"], **F32)
        assert r["gn"] > CLIP          # the step's clipping engaged
        assert r["routes"] == get_reduced(arch).num_layers
        assert r["margin"] > MARGIN, (key, r["margin"])


@pytest.mark.parametrize("what", ("grad", "param", "mu", "nu"))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", IDS)
def test_every_leaf_matches_the_references_mesh(results, case, arch, what):
    """Every gradient (the experts', the router's, the shared experts' and
    MLA's whole latent leaves among them), and every parameter and moment
    after the clipped step, the ranks' slices joined, against the
    reference's leaf."""
    ref, _, _ = results
    key = f"{case}/{arch}"
    got = _joined(_port(results, case, arch), case, arch, what)
    names = sorted(k for k in ref if k.startswith(f"{key}/{what}/"))
    assert sorted(f"{key}/{what}/{k}" for k in got) == names
    for name, v in got.items():
        np.testing.assert_allclose(v, ref[f"{key}/{what}/{name}"],
                                   err_msg=f"{what} {name}", **F32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", IDS)
def test_no_expert_gradient_is_zero(results, case, arch):
    """Every rank's slice of every expert leaf (and the router, the shared
    experts) has a nonzero gradient: the experts stay in the graph through
    the all-to-alls and the gather of the output blocks."""
    for rank, r in enumerate(_port(results, case, arch)):
        moe = [k for k in r["grad"] if ".moe." in k]
        assert any(".moe.wi_gate" in k for k in moe)
        for k in moe:
            assert np.any(r["grad"][k]), (rank, k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", IDS)
def test_the_ranks_agree_bit_for_bit(results, case, arch):
    """Losses equal on every rank; every leaf equal on the ranks that hold
    the same slice of it (the data ranks of a model coordinate, and every
    rank for a leaf whole on every rank: norms, the router, the shared
    experts, MLA's ``w_dkv`` and ``w_kr``); the experts split over the
    model axis."""
    ranks = _port(results, case, arch)
    (dd, mm), _, _ = CASES[case]
    zero1, split = set(ranks[0]["zero1"]), set(ranks[0]["split"])
    assert len({r["loss"] for r in ranks}) == 1
    if mm > 1:
        assert {k for k in ranks[0]["grad"] if ".moe.wi_" in k or
                k.endswith(".moe.wo")} <= split
        assert not any(".shared." in k or k.endswith(("router", "w_dkv",
                                                      "w_kr"))
                       for k in split)
    for what in ("grad", "param", "mu", "nu"):
        for name in ranks[0][what]:
            for r, res in enumerate(ranks):
                d, m = divmod(r, mm)
                if what in ("mu", "nu") and name in zero1:
                    same = ranks[d * mm]
                else:
                    same = ranks[m] if name in split else ranks[0]
                np.testing.assert_array_equal(res[what][name],
                                              same[what][name],
                                              err_msg=f"{what} {name} {r}")


def _ref_like(arch: str):
    """The reference's trainer-state tree for ``arch`` (the leaves'
    structure a restore reads into)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jget_reduced
    from repro.models.lm import LM as JLM
    from repro.optim.adamw import AdamW as JAdamW
    params = JLM(jget_reduced(arch)).init(jax.random.PRNGKey(SEED))
    return {"params": params, "opt": JAdamW().init(params),
            "ef": jax.tree.map(lambda _: jnp.zeros((), jnp.float32), params)}


@pytest.mark.parametrize("arch", ARCHS)
def test_the_ranks_checkpoint_restores_in_the_reference(results, arch):
    """The sharded checkpoint the four ZeRO-1 ranks wrote after their step
    (experts split over ``model``, ZeRO-1 moments over ``data``), restored
    by the reference's ``restore_checkpoint`` on one device: every leaf
    bit-equal to the ranks' stepped state, joined."""
    import jax
    from repro.checkpoint import restore_checkpoint as jrestore
    from repro_torch.convert import train_state_from_reference
    _, _, tmp = results
    back, step = jrestore(tmp / "port_ckpt" / arch, _ref_like(arch))
    assert step == 1
    got = train_state_from_reference(jax.tree.map(np.asarray, back),
                                     get_reduced(arch), "cpu")
    ranks = _port(results, CKPT_CASE, arch)
    for what, tree in (("param", got["params"]), ("mu", got["opt"].mu),
                       ("nu", got["opt"].nu)):
        want = _joined(ranks, CKPT_CASE, arch, what)
        assert tree.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(tree[k].numpy(), v,
                                          err_msg=f"{what} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_the_references_checkpoint_restores_onto_each_ranks_slices(
        results, arch):
    """The reference's sharded checkpoint of its ZeRO-1 step on a forced
    4-device (2, 2) mesh, restored by the port with ``shardings=`` onto
    each rank's slices (the plan's for the model axis, ZeRO-1's rows for
    the moments of the leaves whole over it): every leaf bit-equal to
    the reference's stepped state cut the same way."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.checkpoint.ckpt import tree_map
    from repro_torch.convert import (train_state_from_reference,
                                     train_state_to_reference)
    from repro_torch.launch.sharding import local_leaf, train_specs
    from repro_torch.optim.adamw import AdamWState
    ref, _, tmp = results
    cfg = get_reduced(arch)
    (dd, mm), _, seq = CASES[CKPT_CASE]
    sizes = {"data": dd, "model": mm}
    p_specs, o_specs, _ = train_specs(cfg, sizes, BATCH, seq)
    ranks = _port(results, CKPT_CASE, arch)
    key = f"{CKPT_CASE}/{arch}"
    zero1 = set(ranks[0]["zero1"])
    assert zero1
    for r, res in enumerate(ranks):
        index = dict(zip(("data", "model"), divmod(r, mm)))

        def want(what, k):
            full = torch.from_numpy(ref[f"{key}/{what}/{k}"])
            if what != "param" and k in zero1:
                rows = full.shape[0] // dd
                return full[index["data"] * rows:(index["data"] + 1) * rows]
            return local_leaf(full, k, cfg, mm, index["model"])
        local = {"params": {k: torch.empty(v.shape) for k, v in
                            res["param"].items()},
                 "opt": AdamWState(torch.tensor(1, dtype=torch.int32),
                                   *({k: torch.empty(v.shape)
                                      for k, v in res[m].items()}
                                     for m in ("mu", "nu"))),
                 "ef": None}
        place = train_state_to_reference(
            tree_map(lambda t: torch.empty_like(t, device="meta"), local),
            cfg, shards=(p_specs, o_specs.mu, sizes, index))
        tree, step = restore_checkpoint(tmp / "ref_ckpt" / arch, place,
                                        shardings=place)
        assert step == 1
        got = train_state_from_reference(tree, cfg, "cpu")
        for what, t in (("param", got["params"]), ("mu", got["opt"].mu),
                        ("nu", got["opt"].nu)):
            for k, v in t.items():
                assert torch.equal(v, want(what, k)), (r, what, k)
