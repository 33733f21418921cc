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
* The trainer's contracts of ``tests/test_system.py``,
  ``tests/test_faults.py`` and ``tests/test_executor.py``: the loss
  decreases, restart continuity, the supervised restart, the watchdog,
  compressed training, the ``step`` fault site, and the train-serve
  handoff without a restack.
"""
from __future__ import annotations

import json
import zipfile

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
    from repro_torch.launch import train
    out = train.main(["--arch", "h2o-danube-1.8b", "--reduced", "--steps",
                      "4", "--seq", "12", "--global-batch", "2", "--device",
                      "cpu", "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 3 and np.isfinite(out["losses"]).all()
    with pytest.raises(NotImplementedError, match="item 6"):
        train.main(["--arch", "h2o-danube-1.8b", "--reduced",
                    "--model-parallel", "2", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)])
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
