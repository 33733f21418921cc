"""Checkpoints and the trainer of the port on the CPU, against the JAX
package and the reference's contracts.

* Both directions on the reduced (f32) configs: a trainer state saved by
  the port restores in the reference and the reference's restores in the
  port, leaf for leaf bit-equal, with equal ``manifest.json``; a bf16
  leaf's npz member is byte-equal to the reference's, and bf16 round-trips
  port to port (the reference's own restore cannot read it: ROADMAP.md,
  reference caveat (e)).
* The single-device contracts of ``tests/test_checkpoint.py``: the torn
  step skipped, a re-save, async errors raised from ``wait`` and from the
  next save, the host snapshot taken before the caller updates in place.
* Sharded checkpoints (model-parallel training): the manifest of two port
  ranks' checkpoint equals the reference's from the same 2-device mesh in
  paths, shapes, dtypes and shard offsets; the reference restores the
  port ranks' checkpoints (two ranks, and four with ZeRO-1 moments) on
  one device; the port restores the reference's and its own onto one
  device and, with ``shardings=``, onto each rank of a ``(1, 2)`` mesh.
* The trainer's contracts of ``tests/test_system.py``,
  ``tests/test_faults.py`` and ``tests/test_executor.py``: the loss
  decreases, restart continuity, the supervised restart, the watchdog,
  compressed training, the ``step`` fault site, and the train-serve
  handoff without a restack; the launcher on one device and over a mesh.
"""
from __future__ import annotations

import json
import os
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore, \
    save_checkpoint as jsave
from repro.configs import get_reduced as jget_reduced
from repro.models.lm import LM as JLM
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.checkpoint import (CheckpointManager, committed_steps,
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.ckpt import tree_flatten_with_path
from repro_torch.configs import get_reduced
from repro_torch.convert import (train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models.lm import LM
from repro_torch.runtime.faults import FaultInjector, FaultSpec
from repro_torch.runtime.trainer import (InjectedFailure, StragglerTimeout,
                                         Trainer, TrainerConfig,
                                         run_supervised)

REPO = Path(__file__).resolve().parent.parent


def _ref_state(arch: str, compressed: bool = False) -> dict:
    """A reference trainer state after one AdamW update from random
    gradients (nonzero moments, step 1), as jax arrays."""
    cfg = jget_reduced(arch)
    params = JLM(cfg).init(jax.random.PRNGKey(0))
    opt = JAdamW()
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    upd, ost = opt.update(grads, opt.init(params), params)
    params = jax.tree.map(lambda p, u: p + u, params, upd)
    ef = (jax.tree.map(lambda p: jnp.full(p.shape, 1e-3, jnp.float32),
                       params) if compressed else
          jax.tree.map(lambda _: jnp.zeros((), jnp.float32), params))
    return {"params": params, "opt": ost, "ef": ef}


def _members(npz) -> dict:
    with zipfile.ZipFile(npz) as z:
        return {n: z.read(n) for n in z.namelist()}


def _ref_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree) -> dict:
    return {p: x.numpy() for p, x in tree_flatten_with_path(tree)}


@pytest.mark.parametrize("arch,compressed", [
    ("stablelm-3b", False), ("gemma3-4b", True),
    ("deepseek-v2-lite-16b", False), ("llava-next-34b", False),
    ("whisper-large-v3", True), ("zamba2-7b", False),
    ("xlstm-1.3b", False)])
def test_checkpoints_cross_between_the_packages(tmp_path, arch, compressed):
    jstate = _ref_state(arch, compressed)
    cfg = get_reduced(arch)
    state = train_state_from_reference(jstate, cfg, "cpu")
    assert (state["ef"] is None) != compressed
    jsave(tmp_path / "ref", 3, jstate)
    save_checkpoint(tmp_path / "port", 3, train_state_to_reference(state, cfg))
    step_dir = "step_000000003"
    manifests = [json.loads((tmp_path / d / step_dir / "manifest.json")
                            .read_text()) for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    ref_npz = _members(tmp_path / "ref" / step_dir / "shard_00000.npz")
    port_npz = _members(tmp_path / "port" / step_dir / "shard_00000.npz")
    assert ref_npz == port_npz          # every member, byte for byte
    # the reference restores the port's checkpoint ...
    back, step = jrestore(tmp_path / "port", jstate)
    assert step == 3
    want = _ref_leaves(jstate)
    for k, v in _ref_leaves(back).items():
        assert v.dtype == want[k].dtype
        np.testing.assert_array_equal(v, want[k])
    # ... and the port the reference's
    like = train_state_to_reference(state, cfg)
    tree, step = restore_checkpoint(tmp_path / "ref", like)
    assert step == 3
    got = _port_leaves(tree)
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k])
    again = train_state_from_reference(tree, cfg, "cpu")
    for k, t in state["params"].items():
        assert torch.equal(again["params"][k], t)
    assert int(again["opt"].step) == 1


def test_bf16_leaf_is_written_as_the_reference_writes_it(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((5, 7)).astype(np.float32)
    jsave(tmp_path / "ref", 0, {"w": jnp.asarray(w, jnp.bfloat16)})
    t = torch.from_numpy(w).bfloat16()
    save_checkpoint(tmp_path / "port", 0, {"w": t})
    npz = "step_000000000/shard_00000.npz"
    assert _members(tmp_path / "ref" / npz) == \
        _members(tmp_path / "port" / npz)
    man = json.loads((tmp_path / "port" / "step_000000000" /
                      "manifest.json").read_text())
    assert man["leaves"][0]["dtype"] == "bfloat16"
    for d in ("ref", "port"):          # the port reads either
        got, _ = restore_checkpoint(tmp_path / d, {"w": t})
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"], t)


def test_bf16_round_trip_and_the_reference_cannot_restore_it(tmp_path):
    """The port restores its bf16 leaves bit for bit; the reference's
    restore_checkpoint cannot (reference caveat (e): numpy has no cast from
    the ``|V2`` bytes to ml_dtypes' bfloat16)."""
    t = torch.randn(4, 9).bfloat16()
    save_checkpoint(tmp_path, 1, {"a": t, "b": torch.arange(3)})
    got, _ = restore_checkpoint(tmp_path, {"a": t, "b": t})
    assert torch.equal(got["a"], t) and torch.equal(got["b"], torch.arange(3))
    with pytest.raises((ValueError, TypeError)):
        jrestore(tmp_path, {"a": np.zeros(()), "b": np.zeros(())})


# ---------------------------------------------------------------------------
# The single-device contracts of tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def _tree(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"emb": torch.randn((16, 8), generator=g),
            "bias": torch.randn((8,), generator=g)}


def _like() -> dict:
    return {"emb": 0, "bias": 0}


def _equal(a: dict, b: dict) -> None:
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_torn_step_skipped_and_falls_back(tmp_path):
    d = tmp_path / "ckpt"
    t1, t2 = _tree(1), _tree(2)
    save_checkpoint(d, 1, t1)
    save_checkpoint(d, 2, t2)
    assert committed_steps(d) == [1, 2]
    (d / "step_000000002" / "manifest.json").unlink()
    assert committed_steps(d) == [1] and latest_step(d) == 1
    restored, step = restore_checkpoint(d, _like())
    assert step == 1
    _equal(restored, t1)
    with pytest.raises(FileNotFoundError, match="torn"):
        restore_checkpoint(d, _like(), step=2)


def test_resave_retires_stale_marker_first(tmp_path):
    d = tmp_path / "ckpt"
    save_checkpoint(d, 5, _tree(1))
    t_new = _tree(9)
    save_checkpoint(d, 5, t_new)
    assert committed_steps(d) == [5]
    restored, _ = restore_checkpoint(d, _like(), step=5)
    _equal(restored, t_new)


def test_all_steps_torn_is_no_checkpoint(tmp_path):
    d = tmp_path / "ckpt"
    save_checkpoint(d, 1, _tree(1))
    (d / "step_000000001" / "manifest.json").unlink()
    assert latest_step(d) is None
    with pytest.raises(FileNotFoundError, match="no committed"):
        restore_checkpoint(d, _like())


@pytest.mark.parametrize("where", ["wait", "next_save"])
def test_async_save_error_is_raised(tmp_path, where):
    root = tmp_path / "not_a_dir"
    root.write_text("occupied")
    mgr = CheckpointManager(root / "ckpt", async_save=True)
    mgr.save(1, _tree(1))
    with pytest.raises(OSError):
        mgr.wait() if where == "wait" else mgr.save(2, _tree(2))
    mgr.wait()          # consumed: raised once


def test_sync_save_error_raises_immediately(tmp_path):
    root = tmp_path / "not_a_dir"
    root.write_text("occupied")
    mgr = CheckpointManager(root / "ckpt", async_save=False)
    with pytest.raises(OSError):
        mgr.save(1, _tree(1))
    mgr.wait()


def test_async_save_keeps_what_was_saved_when_updated_in_place(tmp_path):
    """The donation contract: the save copies to host memory before it
    returns, so an optimizer step updating the tensor in place right after
    does not reach the checkpoint; keep-N retention drops old steps."""
    mgr = CheckpointManager(tmp_path / "ckpt", keep=2, async_save=True)
    w = torch.arange(64, dtype=torch.float32)
    expect = w.clone()
    mgr.save(1, {"w": w})
    w.add_(1.0)                      # what AdamW.apply_ does to parameters
    mgr.wait()
    restored, step = mgr.restore({"w": w})
    assert step == 1 and torch.equal(restored["w"], expect)
    for s in (2, 3):
        mgr.save(s, {"w": w})
    mgr.wait()
    assert committed_steps(tmp_path / "ckpt") == [2, 3]


def test_tree_paths_are_jax_keystr():
    from repro_torch.optim.adamw import AdamWState
    tree = {"params": {"b": torch.zeros(1), "a": (torch.zeros(2),)},
            "opt": AdamWState(torch.zeros(()), {"x": torch.zeros(1)},
                              {"x": torch.zeros(1)}), "ef": None}
    paths = [p for p, _ in tree_flatten_with_path(tree)]
    from repro.optim.adamw import AdamWState as JState
    jtree = {"params": {"b": 0, "a": (0,)},
             "opt": JState(0, {"x": 0}, {"x": 0}), "ef": None}
    assert paths == [jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert paths[0] == "['opt'].step"


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

def _mk(tmp_path, arch="stablelm-3b", steps=24, seed=0, **kw):
    cfg = get_reduced(arch)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                      global_batch=8))
    tcfg = TrainerConfig(total_steps=steps, ckpt_every=8,
                         ckpt_dir=str(tmp_path / "ckpt"), **kw)
    return Trainer(LM(cfg, device="cpu", seed=seed), data, tcfg)


@pytest.mark.parametrize("compress", [False, True])
def test_training_loss_decreases(tmp_path, compress):
    losses = _mk(tmp_path, steps=30, grad_compression=compress).run()[
        "losses"]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.03, losses


def test_checkpoint_restart_continuity(tmp_path):
    """A fresh trainer (other initial weights) resumes from the committed
    step, runs only the remaining steps, and repeats the first run's
    losses there bit for bit, from the restored state."""
    out1 = _mk(tmp_path, steps=16).run()
    assert out1["final_step"] == 15
    more = _mk(tmp_path / "more", steps=20).run()
    out2 = _mk(tmp_path, steps=20, seed=5).run()
    assert out2["final_step"] == 19 and len(out2["losses"]) == 4
    assert out2["losses"] == more["losses"][16:]


def test_supervised_restart_after_injected_failures(tmp_path):
    out = run_supervised(lambda: _mk(tmp_path, steps=30),
                         failure_schedule={10, 20})
    assert out["restarts"] == 2 and out["final_step"] == 29
    # the last restart resumed from the step-15 checkpoint: its losses,
    # steps 16-29, are those of an uninterrupted run bit for bit
    clean = _mk(tmp_path / "clean", steps=30).run()["losses"]
    assert out["losses"] == clean[16:]


def test_straggler_watchdog(tmp_path):
    with pytest.raises(StragglerTimeout):
        _mk(tmp_path, steps=5, step_deadline_s=1e-9).run()


def test_trainer_step_site_fires(tmp_path):
    inj = FaultInjector([FaultSpec("step", at=(3,))])
    t = _mk(tmp_path, steps=6)
    t.faults = inj
    with pytest.raises(InjectedFailure, match="site=step call=3"):
        t.run()
    assert inj.counts["step"] == 3


def test_trainer_feed_keeps_executor_fresh_no_restacks(tmp_path):
    """The embed table is updated in place every step, so the handoff to
    the embedding executor binds once and never restacks or rebinds (the
    reference rebinds each step's new array instead), and a serve step on
    the same executor reads the trained table."""
    from repro_torch.core.executor import clear_executor_cache
    clear_executor_cache()       # executors are memoized per signature
    trainer = _mk(tmp_path, steps=3)
    out = trainer.run()
    ex = trainer.emb_executor
    n_units = len(ex.compiled.units)
    assert ex.stats["table_stacks"] == n_units
    assert ex.stats["table_restacks"] == 0
    assert ex.stats["table_rebinds"] == 0
    embed = out["state"]["params"]["embed"]
    tokens = np.arange(128, dtype=np.int32) % trainer.lm.cfg.padded_vocab
    with torch.no_grad():
        got = ex.step({"tok_embed": {"table": embed, "idxs": tokens},
                       "label_gather": {"table": embed, "idxs": tokens}})
    assert ex.stats["table_restacks"] == 0
    assert ex.stats["table_rebinds"] == 0
    torch.testing.assert_close(got["tok_embed"].reshape(128, -1),
                               embed.detach()[tokens])


def test_train_launcher_runs_on_the_cpu_and_refuses_a_mesh(tmp_path):
    """The launcher trains on the CPU, on one device and over a mesh
    (``--model-parallel 2``: two gloo ranks, sharded checkpoints), and a
    mesh run resumes from its own checkpoint; it refuses to run without a
    checkpoint directory."""
    from repro_torch.launch import train
    out = train.main(["--arch", "h2o-danube-1.8b", "--reduced", "--steps",
                      "4", "--seq", "12", "--global-batch", "2", "--device",
                      "cpu", "--ckpt-dir", str(tmp_path / "one")])
    assert out["final_step"] == 3 and np.isfinite(out["losses"]).all()
    mp = ["--arch", "h2o-danube-1.8b", "--reduced", "--model-parallel", "2",
          "--seq", "12", "--global-batch", "2", "--device", "cpu",
          "--ckpt-dir", str(tmp_path / "mp")]
    out = train.main(mp + ["--steps", "4"])
    assert out["final_step"] == 3 and len(out["losses"]) == 4
    assert np.isfinite(out["losses"]).all()
    assert latest_step(tmp_path / "mp") == 3
    manifest = json.loads((tmp_path / "mp" / "step_000000003" /
                           "manifest.json").read_text())
    embed = next(e for e in manifest["leaves"]
                 if e["path"] == "['params']['embed']")
    assert [s["index"][0] for s in embed["shards"]] == [[0, 128],
                                                        [128, 256]]
    out = train.main(mp + ["--steps", "6"])        # resumes after step 3
    assert out["final_step"] == 5 and len(out["losses"]) == 2
    # no shared default checkpoint directory: the launcher and the config
    # both require one
    with pytest.raises(SystemExit):
        train.main(["--arch", "h2o-danube-1.8b", "--reduced", "--device",
                    "cpu"])
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.lm import LM
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = get_reduced("h2o-danube-1.8b")
    with pytest.raises(ValueError, match="ckpt_dir is required"):
        Trainer(LM(cfg, device="cpu"), SyntheticTokens(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)),
            TrainerConfig(total_steps=1))


# ---------------------------------------------------------------------------
# Sharded checkpoints: written from ranks, with the reference's offsets
# ---------------------------------------------------------------------------

SHARDED_ARCH = "h2o-danube-1.8b"
_SHARDED: dict = {}

_REF_SHARDED_SAVE = """
import pickle
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import save_checkpoint
from repro.launch import sharding as shd
from repro.launch.mesh import axis_types_kw

mesh = jax.make_mesh((1, 2), ("data", "model"), **axis_types_kw(2))
with open({state!r}, "rb") as f:
    st = pickle.load(f)
specs = shd.to_shardings(mesh, shd.sanitize_specs(
    shd.param_specs(st["params"]), st["params"], mesh))
rep = NamedSharding(mesh, P())
opt = st["opt"]
save_checkpoint({path!r}, 3, {{
    "params": jax.device_put(st["params"], specs),
    "opt": type(opt)(jax.device_put(opt.step, rep),
                     jax.device_put(opt.mu, specs),
                     jax.device_put(opt.nu, specs)),
    "ef": jax.device_put(st["ef"], rep)}})
print("REF_SHARDED_SAVED")
"""


def _full_state(host: dict) -> dict:
    """The port's full trainer state from :func:`_host_state`'s arrays."""
    from repro_torch.optim.adamw import AdamWState

    def t(tree):
        return {k: torch.from_numpy(v) for k, v in tree.items()}
    return {"params": t(host["params"]),
            "opt": AdamWState(torch.tensor(host["step"], dtype=torch.int32),
                              t(host["mu"]), t(host["nu"])), "ef": None}


def _host_state(full: dict) -> dict:
    opt = full["opt"]
    return {"params": {k: v.numpy() for k, v in full["params"].items()},
            "mu": {k: v.numpy() for k, v in opt.mu.items()},
            "nu": {k: v.numpy() for k, v in opt.nu.items()},
            "step": int(opt.step)}


def _sharded_state(host: dict, mesh_shape: tuple, zero1: bool,
                   index: dict) -> tuple:
    """The full state (:func:`_full_state`) and the slices of it that the
    rank at ``index`` of a ``mesh_shape`` (data, model) mesh holds, with
    the specs: ``(full, local, shards)``, ``shards`` as
    ``train_state_to_reference`` takes them."""
    from repro_torch.launch.sharding import local_shard, train_specs
    from repro_torch.optim.adamw import AdamWState
    cfg = get_reduced(SHARDED_ARCH)
    full = _full_state(host)
    sizes = dict(zip(("data", "model"), mesh_shape))
    p_specs, o_specs, _ = train_specs(cfg, sizes, 2, 8, zero1=zero1)

    def cut(tree, specs):
        return {k: local_shard(t, specs[k], sizes, index).contiguous()
                for k, t in tree.items()}
    opt = full["opt"]
    local = {"params": cut(full["params"], p_specs),
             "opt": AdamWState(opt.step, cut(opt.mu, o_specs.mu),
                               cut(opt.nu, o_specs.mu)), "ef": None}
    return full, local, (p_specs, o_specs.mu, sizes, index)


def _save_rank(rank: int, world: int, host: dict, path: str,
               mesh_shape: tuple, zero1: bool) -> int:
    """One rank writes its part of a sharded checkpoint of step 3."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import mesh_index
    mesh = make_host_mesh(mesh_shape[1], device="cpu")
    _, local, shards = _sharded_state(host, mesh_shape, zero1,
                                      mesh_index(mesh))
    save_checkpoint(path, 3, train_state_to_reference(
        local, get_reduced(SHARDED_ARCH), shards=shards))
    return rank


@pytest.fixture
def sharded(tmp_path_factory) -> dict:
    """Step 3 of one trainer state (:func:`_ref_state`, reduced danube)
    saved three ways, once: by the reference from a 2-device ``(1, 2)``
    mesh (its subprocess runs beside the ranks), by two port ranks on the
    same mesh, and by four port ranks on ``(2, 2)`` with ZeRO-1
    moments."""
    if not _SHARDED:
        import pickle
        import subprocess
        import sys
        from benchmarks._mesh import MESH_SKIP, forced_device_env
        from repro_torch.launch.mesh import run_ranks
        tmp = tmp_path_factory.mktemp("sharded")
        jstate = jax.tree.map(np.asarray, _ref_state(SHARDED_ARCH))
        with open(tmp / "state.pkl", "wb") as f:
            pickle.dump(jstate, f)
        host = _host_state(train_state_from_reference(
            jstate, get_reduced(SHARDED_ARCH), "cpu"))
        env = forced_device_env(2)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO / "src"), str(REPO)] + ([env["PYTHONPATH"]]
                                              if env.get("PYTHONPATH")
                                              else []))
        code = ("from benchmarks._mesh import require_devices\n"
                "if not require_devices(2):\n    raise SystemExit(0)\n" +
                _REF_SHARDED_SAVE.format(state=str(tmp / "state.pkl"),
                                         path=str(tmp / "ref")))
        proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                cwd=str(REPO), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            run_ranks(_save_rank, 2, (host, str(tmp / "port"), (1, 2),
                                      False))
            run_ranks(_save_rank, 4, (host, str(tmp / "zero1"), (2, 2),
                                      True))
            out, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if MESH_SKIP in out:
            pytest.skip(f"forced 2-device CPU mesh not honored: {out}")
        assert "REF_SHARDED_SAVED" in out, out[-4000:]
        _SHARDED.update(ref=tmp / "ref", port=tmp / "port",
                        zero1=tmp / "zero1", host=host, jstate=jstate)
    return _SHARDED


def _manifest(d) -> dict:
    return json.loads((d / "step_000000003" / "manifest.json").read_text())


def test_sharded_manifests_equal_the_references(sharded):
    """Paths, shapes, dtypes and every shard's global offsets of the port's
    two-rank checkpoint equal the reference's from the same mesh (the
    member names differ: ``_s<rank>_0`` against the reference's
    ``_s<host>_<device>``); a stacked leaf is whole on its layer dim."""
    ref, port = _manifest(sharded["ref"]), _manifest(sharded["port"])
    assert len(ref["leaves"]) == len(port["leaves"])
    for a, b in zip(ref["leaves"], port["leaves"]):
        assert (a["path"], a["shape"], a["dtype"]) == \
            (b["path"], b["shape"], b["dtype"])
        assert sorted(s["index"] for s in a["shards"]) == \
            sorted(s["index"] for s in b["shards"]), a["path"]
    wq = next(e for e in port["leaves"]
              if e["path"] == "['params']['scan'][0]['attn']['wq']")
    assert [s["index"] for s in wq["shards"]] == [
        [[0, 2], [0, 64], [0, 32]], [[0, 2], [0, 64], [32, 64]]]
    assert sorted(p.name for p in (sharded["port"] / "step_000000003")
                  .glob("shard_*.npz")) == ["shard_00000.npz",
                                            "shard_00001.npz"]


@pytest.mark.parametrize("which", ("port", "zero1"))
def test_a_ranks_checkpoint_restores_in_the_reference(sharded, which):
    """The reference's ``restore_checkpoint`` on one device reads the
    checkpoint two (and four, ZeRO-1) port ranks wrote, leaf for leaf
    bit-equal to the state they were cut from."""
    jstate = sharded["jstate"]
    back, step = jrestore(sharded[which], jstate)
    assert step == 3
    want = _ref_leaves(jstate)
    got = _ref_leaves(back)
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("which", ("ref", "port", "zero1"))
def test_sharded_checkpoints_restore_onto_one_device(sharded, which):
    """Onto one device (no ``shardings``): the whole leaves, from the
    reference's two-device save and the port ranks' ones alike."""
    from repro_torch.checkpoint.ckpt import tree_map
    cfg = get_reduced(SHARDED_ARCH)
    full = _full_state(sharded["host"])
    like = train_state_to_reference(tree_map(
        lambda t: torch.empty_like(t, device="meta"), full), cfg)
    tree, step = restore_checkpoint(sharded[which], like)
    assert step == 3
    want = _port_leaves(train_state_to_reference(full, cfg))
    got = _port_leaves(tree)
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("which", ("ref", "port", "zero1"))
@pytest.mark.parametrize("rank", (0, 1))
def test_sharded_checkpoints_restore_onto_a_ranks_slices(sharded, which,
                                                         rank):
    """Onto rank ``rank`` of a ``(1, 2)`` mesh (``shardings=``, the rank's
    placements): each leaf is exactly that rank's slice of the state --
    from the reference's save, from two ranks, and elastically from the
    four ranks' ``(2, 2)`` ZeRO-1 save (moments cut by rows there, by the
    params' specs here)."""
    from repro_torch.checkpoint.ckpt import tree_map
    cfg = get_reduced(SHARDED_ARCH)
    _, local, shards = _sharded_state(sharded["host"], (1, 2), False,
                                      {"data": 0, "model": rank})
    place = train_state_to_reference(tree_map(
        lambda t: torch.empty_like(t, device="meta"), local), cfg,
        shards=shards)
    tree, step = restore_checkpoint(sharded[which], place, shardings=place)
    assert step == 3
    got = train_state_from_reference(tree, cfg, "cpu")
    for k, t in local["params"].items():
        assert torch.equal(got["params"][k], t), k
    for k in local["opt"].mu:
        assert torch.equal(got["opt"].mu[k], local["opt"].mu[k]), k
        assert torch.equal(got["opt"].nu[k], local["opt"].nu[k]), k
    assert int(got["opt"].step) == int(local["opt"].step)
