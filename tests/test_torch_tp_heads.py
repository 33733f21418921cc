"""The head plan over a model axis of 4: KV heads fewer than the axis, head
counts that do not divide it, and fewer query heads than ranks, against
the JAX package's sharded LM on a forced 4-device CPU mesh.

Three reduced configs (fp32, ``CASES``): chatglm3-6b's (8 query heads over
2 KV heads: each KV group is copied on 2 of the 4 ranks), one whose 6
query heads do not divide the axis (2 KV heads), and one with 2 query
heads over 1 KV head (two ranks hold no attention head at all).  The
reference runs once (one subprocess, the ``run_on_mesh`` fixture's forced
device count, params placed by ``param_specs``): the forward, the loss,
every gradient and one clipped AdamW step of each; for chatglm3-6b also
the teacher-forced ``decode_step``, a masked ``wave_step`` and its caches,
``DecodeServer``'s tokens, and a sharded checkpoint of the stepped state
written from its mesh; and the forward of every other attention family's
reduced config over the same axis (``FAMILIES``: 2 KV heads, or
whisper's 4 heads, over 4 ranks).  The port runs the same on four gloo
ranks on the
CPU (one spawn, beside the reference's subprocess), each rank's slices
cut from the reference's weights by ``convert.lm_params_from_reference(
mesh=)``, the step through its ``Trainer`` (``loss_and_grads``, which sums
each KV copy's gradient over its holders, then ``AdamW.apply_`` with the
trainer's shards), and writes its own sharded checkpoint.  Held at the
reference tests' f32 bound (2e-5): outputs, the loss, the clipped global
norm, every leaf's gradient and the stepped parameters and moments (the
ranks' slices joined by the plan); served tokens and the caches' integer
leaves exactly.  The port alone: the KV copies' gradients, parameters and
moments bit-equal across their group; the checkpoints cross both ways
(the reference restores the ranks' one, and each rank's placement reads
the reference's, the copies from one member); ``LM(seed, shard=)``'s
slices join to ``LM(seed)`` with the copies equal.
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
N = 4                       # the model axis
#: name -> the overrides of reduced chatglm3-6b
CASES = {"glm": {},
         "h6kv2": dict(num_heads=6, num_kv_heads=2, head_dim=8),
         "h2kv1": dict(num_heads=2, num_kv_heads=1)}
SEED, B, S, MAX_LEN, STEPS = 3, 2, 16, 24, 4
WAVE_LENS = (5, 3)
BATCH, LR, CLIP = 4, 1e-3, 0.05
SERVER_KW = dict(batch_slots=2, max_len=32, prefill_chunk=4)
WHAT = ("grad", "param", "mu", "nu")
#: the other attention families, forward over the axis
#: (DeepSeek-V2-Lite's over 4 is ``tests/test_torch_tp_kinds.py``'s)
FAMILIES = ("gemma3-4b", "h2o-danube-1.8b", "llava-next-34b",
            "qwen3-moe-235b-a22b", "whisper-large-v3")
_REPO = Path(__file__).resolve().parent.parent


def config(name: str, get=get_reduced):
    """The case's config from ``get`` (either package's ``get_reduced``)."""
    return dataclasses.replace(get("chatglm3-6b"), **CASES[name])


def tokens(cfg) -> np.ndarray:
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def batch(cfg) -> dict:
    """The global batch: step 0 of the port's synthetic token stream."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    return SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                      global_batch=BATCH)).batch_at(0)


def family_batch(cfg) -> dict:
    """A family's forward inputs: tokens, and frames for an encoder."""
    out = {"tokens": tokens(cfg)}
    if cfg.enc_layers:
        out["enc_embeds"] = np.random.default_rng(19).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return out


def requests(cfg) -> list:
    rng = np.random.default_rng(11)
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
            for n, m in ((6, 4), (9, 3), (4, 5))]


# ---------------------------------------------------------------------------
# The reference, once, on a forced 4-device CPU mesh
# ---------------------------------------------------------------------------

_REF_CODE = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, "tests")
import test_torch_tp_heads as T
from repro.checkpoint import save_checkpoint
from repro.configs import get_reduced
from repro.launch import sharding as shd
from repro.launch.mesh import axis_types_kw
from repro.models.lm import LM, ShardCtx
from repro.optim.adamw import AdamW, AdamWState, apply_updates
from repro.runtime.server import DecodeServer, Request
from repro_torch.convert import caches_from_reference, lm_params_from_reference

mesh = jax.make_mesh((1, T.N), ("data", "model"), **axis_types_kw(2))
rep = NamedSharding(mesh, P())
out = {{}}


def port_names(tree, cfg):
    return {{k: v.numpy() for k, v in lm_params_from_reference(
        jax.tree.map(np.asarray, tree), cfg, "cpu").items()}}


for name in T.CASES:
    cfg = T.config(name, get_reduced)
    params = LM(cfg).init(jax.random.PRNGKey(T.SEED))
    specs = shd.to_shardings(mesh, shd.sanitize_specs(
        shd.param_specs(params), params, mesh))
    ps = jax.device_put(params, specs)
    lm = LM(cfg, ShardCtx(mesh=mesh))
    toks = jnp.asarray(T.tokens(cfg))
    out[f"{{name}}/fwd"] = np.asarray(jax.jit(lm.forward)(
        ps, {{"tokens": toks}})[0])
    opt = AdamW(lr=T.LR, grad_clip=T.CLIP)

    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(lm.loss)(params, batch)
        gn = jnp.sqrt(sum(jnp.sum(jnp.square(g))
                          for g in jax.tree.leaves(grads)))
        upd, opt_state = opt.update(grads, opt_state, params)
        return loss, grads, gn, apply_updates(params, upd), opt_state
    b = jax.device_put({{k: jnp.asarray(v) for k, v in T.batch(cfg).items()}},
                       rep)
    o_specs = AdamWState(rep, specs, specs)
    loss, grads, gn, new, ost = jax.jit(step)(
        ps, jax.device_put(opt.init(params), o_specs), b)
    out[f"{{name}}/loss"], out[f"{{name}}/gn"] = np.asarray(loss), \\
        np.asarray(gn)
    for what, tree in (("grad", grads), ("param", new), ("mu", ost.mu),
                       ("nu", ost.nu)):
        for k, v in port_names(tree, cfg).items():
            out[f"{{name}}/{{what}}/{{k}}"] = v
    if name != "glm":
        continue
    save_checkpoint({ckpt!r}, 1, {{
        "params": new, "opt": ost,
        "ef": jax.device_put(jax.tree.map(
            lambda a: np.zeros((), np.float32), params), rep)}})
    dec = jax.jit(lm.decode_step)
    caches = lm.init_caches(T.B, T.MAX_LEN)
    for t in range(T.STEPS):
        lg, caches = dec(ps, toks[:, t:t + 1], caches)
        out[f"glm/dec/{{t}}"] = np.asarray(lg)
    lg, caches = jax.jit(lm.wave_step)(
        ps, toks[:, :max(T.WAVE_LENS)], jnp.asarray(T.WAVE_LENS),
        lm.init_caches(T.B, T.MAX_LEN))
    out["glm/wave"] = np.asarray(lg)
    port = caches_from_reference(jax.tree.map(np.asarray, caches), cfg, "cpu")
    for li, layer in enumerate(port):
        for k, v in layer.items():
            out[f"glm/cache/{{li}}/{{k}}"] = v.numpy()
    srv = DecodeServer(lm, ps, **T.SERVER_KW)
    reqs = [Request(prompt=p, max_new_tokens=m) for p, m in T.requests(cfg)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    for i, r in enumerate(reqs):
        out[f"glm/srv/{{i}}"] = np.asarray(r.out, np.int64)
for arch in T.FAMILIES:
    cfg = get_reduced(arch)
    params = LM(cfg).init(jax.random.PRNGKey(T.SEED))
    ps = jax.device_put(params, shd.to_shardings(mesh, shd.sanitize_specs(
        shd.param_specs(params), params, mesh)))
    fb = {{k: jnp.asarray(v) for k, v in T.family_batch(cfg).items()}}
    out[f"{{arch}}/fwd"] = np.asarray(jax.jit(LM(cfg, ShardCtx(
        mesh=mesh)).forward)(ps, fb)[0])
np.savez({path!r}, **out)
print("REF_OK")
"""


def _start_reference(path: Path, ckpt: Path, log: Path):
    from benchmarks._mesh import forced_device_env
    env = forced_device_env(N)
    env["PYTHONPATH"] = os.pathsep.join(
        ["src", str(_REPO)] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    body = ("from benchmarks._mesh import require_devices\n"
            f"if not require_devices({N}):\n    raise SystemExit(0)\n" +
            _REF_CODE.format(path=str(path), ckpt=str(ckpt)))
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-c", body], stdout=f,
                                stderr=subprocess.STDOUT, env=env,
                                cwd=str(_REPO))


# ---------------------------------------------------------------------------
# The port, on four gloo ranks
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _port_case(name: str, mesh, ckpt: str) -> dict:
    """One rank, one config: the forward, the trainer's clipped step (and
    for chatglm3-6b the serving drives and the sharded checkpoint), and
    ``LM(seed, shard=)``'s own slices."""
    import jax
    from repro.configs import get_reduced as jget_reduced
    from repro.models.lm import LM as JLM
    from repro_torch.checkpoint.ckpt import save_checkpoint
    from repro_torch.convert import (lm_params_from_reference,
                                     train_state_to_reference)
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.lm import LM, ShardCtx
    from repro_torch.optim.adamw import AdamW, global_sq_norm
    from repro_torch.runtime.server import DecodeServer, Request
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = config(name)
    shard = ShardCtx(mesh)
    params = jax.tree.map(np.asarray, JLM(config(name, jget_reduced)).init(
        jax.random.PRNGKey(SEED)))
    lm = LM(cfg, device="cpu", shard=shard)
    lm.load_state_dict(lm_params_from_reference(params, cfg, "cpu",
                                                mesh=mesh))
    out = {"seeded": {k: _np(v) for k, v in LM(
        cfg, device="cpu", seed=SEED, shard=shard).state_dict().items()},
        "heads": [tuple(blk.attn[w].shape) for blk in lm.blocks
                  for w in ("wq", "wk")]}
    toks = torch.from_numpy(tokens(cfg)).long()
    with torch.no_grad():
        out["fwd"] = _np(lm.forward(toks))
    if name == "glm":
        caches = lm.init_caches(B, MAX_LEN)
        for t in range(STEPS):
            lg, _ = lm.decode_step(toks[:, t:t + 1], caches)
            out[f"dec/{t}"] = _np(lg)
        caches = lm.init_caches(B, MAX_LEN)
        lg, _ = lm.wave_step(toks[:, :max(WAVE_LENS)].numpy(),
                             np.asarray(WAVE_LENS), caches)
        out["wave"] = _np(lg)
        out["cache"] = [{k: _np(v) for k, v in c.items()} for c in caches]
        srv = DecodeServer(lm, **SERVER_KW)
        reqs = [Request(prompt=p, max_new_tokens=m)
                for p, m in requests(cfg)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        out["srv"] = [list(r.out) for r in reqs]
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                      global_batch=BATCH))
    tr = Trainer(lm, data, TrainerConfig(ckpt_dir=ckpt, lr=LR))
    tr.opt = AdamW(lr=LR, grad_clip=CLIP)
    state = tr.init_state()
    c0 = lm.collective_stats["collectives"]
    loss, grads = tr.loss_and_grads(state["params"],
                                    tr.local_batch(data.batch_at(0)))
    out["step_collectives"] = lm.collective_stats["collectives"] - c0
    out["gn"] = float(torch.sqrt(global_sq_norm(grads, tr.shards)))
    state["opt"] = tr.opt.apply_(state["params"], grads, state["opt"],
                                 tr.shards)
    out.update(loss=float(loss), grad={k: _np(g) for k, g in grads.items()},
               param={k: _np(p) for k, p in state["params"].items()},
               mu={k: _np(v) for k, v in state["opt"].mu.items()},
               nu={k: _np(v) for k, v in state["opt"].nu.items()},
               copies=sorted(tr._copies), repeat=sorted(tr.shards.repeat))
    if name == "glm":
        save_checkpoint(ckpt, 1, train_state_to_reference(
            state, cfg, shards=tr._ckpt_shards()))
    return out


def _port_family(arch: str, mesh) -> np.ndarray:
    """A family's forward on the rank's slices of the reference's
    weights."""
    import jax
    from repro.configs import get_reduced as jget_reduced
    from repro.models.lm import LM as JLM
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.models.lm import LM, ShardCtx
    cfg = get_reduced(arch)
    params = jax.tree.map(np.asarray, JLM(jget_reduced(arch)).init(
        jax.random.PRNGKey(SEED)))
    lm = LM(cfg, device="cpu", shard=ShardCtx(mesh))
    lm.load_state_dict(lm_params_from_reference(params, cfg, "cpu",
                                                mesh=mesh))
    fb = {k: torch.from_numpy(v) for k, v in family_batch(cfg).items()}
    with torch.no_grad():
        return _np(lm.forward(fb.pop("tokens").long(), **fb))


def _port_all(rank: int, world: int, ckpt: str) -> dict:
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(world, device="cpu")
    out = {name: _port_case(name, mesh, ckpt) for name in CASES}
    out.update({arch: _port_family(arch, mesh) for arch in FAMILIES})
    return out


_MEMO: dict = {}


@pytest.fixture
def results(tmp_path_factory) -> tuple:
    """(the reference's npz as a dict, ``{case: [each rank's results]}``,
    the two checkpoints' directories): the reference's subprocess and the
    port's four ranks run side by side, once."""
    if "res" not in _MEMO:
        from benchmarks._mesh import MESH_SKIP
        tmp = tmp_path_factory.mktemp("tp_heads")
        dirs = {"ref": tmp / "ref_ckpt", "port": tmp / "port_ckpt"}
        proc = _start_reference(tmp / "ref.npz", dirs["ref"], tmp / "ref.log")
        try:
            ranks = run_ranks(_port_all, N, (str(dirs["port"]),))
            proc.wait(timeout=900)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out = (tmp / "ref.log").read_text()
        if MESH_SKIP in out:
            pytest.skip(f"forced {N}-device CPU mesh not honored: "
                        f"{out.strip().splitlines()[-1]}")
        assert "REF_OK" in out, out[-4000:]
        with np.load(tmp / "ref.npz") as z:
            ref = dict(z)
        _MEMO["res"] = (ref, {c: [r[c] for r in ranks]
                              for c in tuple(CASES) + FAMILIES}, dirs)
    return _MEMO["res"]


def _joined(ranks: list, cfg, what: str) -> dict:
    """The full leaves from the ranks' slices, joined by the plan."""
    from repro_torch.convert import lm_params_gathered
    return lm_params_gathered([{k: torch.from_numpy(v)
                                for k, v in r[what].items()} for r in ranks],
                              cfg)


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_the_plan_places_the_heads(results, case):
    """Each rank holds the plan's heads: chatglm3-6b 2 query heads and a
    copy of one KV head; 6 over 4 ranks 2, 1, 2, 1 (the earlier ranks of a
    group take the larger shares); 2 over 4 one head on ranks 0 and 2 and
    none (no columns at all) on ranks 1 and 3."""
    cfg = config(case)
    hd = cfg.hd
    want = {"glm": [(2, 1)] * 4, "h6kv2": [(2, 1), (1, 1), (2, 1), (1, 1)],
            "h2kv1": [(1, 1), (1, 1), (0, 0), (0, 0)]}[case]
    for rank, res in enumerate(results[1][case]):
        (wq, wk) = res["heads"][:2]
        assert (wq[1] // hd, wk[1] // hd) == want[rank], rank
    copies = results[1][case][0]["copies"]
    assert copies == sorted(f"blocks.{i}.attn.{w}" for i in range(2)
                            for w in ("wk", "wv"))


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_the_references_mesh(results, case):
    ref, port, _ = results
    for res in port[case]:
        np.testing.assert_allclose(res["fwd"], ref[f"{case}/fwd"], **F32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_attention_family_matches_the_references_mesh(results, arch):
    """The forward of each other attention family's reduced config over
    the 4-wide axis (KV copies for the 2-KV-head ones, whisper's encoder
    and decoder at one head a rank), bit-equal on every rank."""
    ref, port, _ = results
    for res in port[arch]:
        np.testing.assert_allclose(res, ref[f"{arch}/fwd"], **F32)
        np.testing.assert_array_equal(res, port[arch][0])


@pytest.mark.parametrize("step", range(STEPS))
def test_decode_steps_match_the_references_mesh(results, step):
    ref, port, _ = results
    for res in port["glm"]:
        np.testing.assert_allclose(res[f"dec/{step}"], ref[f"glm/dec/{step}"],
                                   **F32)


def test_masked_wave_and_its_caches_match_the_references_mesh(results):
    """The wave's logits, and each rank's KV heads of the reference's
    cache after it (its group's copy); ``len`` whole and exact."""
    from repro_torch.launch.sharding import head_plan
    ref, port, _ = results
    cfg = config("glm")
    for rank, res in enumerate(port["glm"]):
        np.testing.assert_allclose(res["wave"], ref["glm/wave"], **F32)
        k0, k1 = head_plan(cfg, N, rank).kv
        for li, layer in enumerate(res["cache"]):
            for k, got in layer.items():
                want = ref[f"glm/cache/{li}/{k}"]
                if k == "len":
                    np.testing.assert_array_equal(got, want)
                else:
                    np.testing.assert_allclose(got, want[:, k0:k1], **F32)


def test_server_tokens_equal_the_references(results):
    ref, port, _ = results
    for res in port["glm"]:
        for i, toks in enumerate(res["srv"]):
            assert toks == ref[f"glm/srv/{i}"].tolist(), i


@pytest.mark.parametrize("case", CASES)
def test_loss_and_clipped_norm_match_the_references_mesh(results, case):
    """The loss and the global gradient norm (each KV copy counted once);
    the norm is above the clip, so the step scales every gradient."""
    ref, port, _ = results
    for res in port[case]:
        np.testing.assert_allclose(res["loss"], ref[f"{case}/loss"], **F32)
        np.testing.assert_allclose(res["gn"], ref[f"{case}/gn"], **F32)
        assert res["gn"] > CLIP


@pytest.mark.parametrize("what", WHAT)
@pytest.mark.parametrize("case", CASES)
def test_every_leaf_matches_the_references_mesh(results, case, what):
    """Every gradient (a KV copy's summed over its holders), and every
    parameter and moment after the clipped step, the ranks' slices joined
    by the plan, against the reference's leaf."""
    ref, port, _ = results
    got = _joined(port[case], config(case), what)
    names = sorted(k for k in ref if k.startswith(f"{case}/{what}/"))
    assert sorted(f"{case}/{what}/{k}" for k in got) == names
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[f"{case}/{what}/{k}"],
                                   err_msg=f"{what} {k}", **F32)


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_the_copies_stay_bit_equal(results, case):
    """The ranks agree bit for bit on every output; a KV copy's gradient,
    parameter and moments are the same bits on every rank of its group;
    only the group's first rank counts the copy in the norm; the step
    made one collective a copied leaf beyond the forward and backward's."""
    from repro_torch.launch.sharding import head_plan
    ranks = results[1][case]
    cfg = config(case)
    assert len({r["loss"] for r in ranks}) == len({r["gn"] for r in ranks}) \
        == 1
    for key in ("fwd",) + (("wave",) if case == "glm" else ()):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], ranks[0][key])
    for rank, res in enumerate(ranks):
        group = head_plan(cfg, N, rank).group
        for k in res["copies"]:
            for what in WHAT:
                np.testing.assert_array_equal(
                    res[what][k], ranks[group[0]][what][k] if group
                    else res[what][k], err_msg=f"{what} {k} rank {rank}")
        first = bool(group) and group[0] == rank
        assert all((k in res["repeat"]) != first for k in res["copies"])
    per_rank = {r["step_collectives"] for r in ranks}
    assert len(per_rank) == 1


@pytest.mark.parametrize("case", CASES)
def test_sharded_init_joins_to_the_single_device_bit_for_bit(results, case):
    from repro_torch.models.lm import LM
    cfg = config(case)
    got = _joined(results[1][case], cfg, "seeded")
    want = LM(cfg, device="cpu", seed=SEED).state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _placement(cfg, rank: int):
    """Rank ``rank``'s placement tree of the trainer state (meta leaves,
    the plan's blocks), as ``Trainer._restore`` builds it."""
    from repro_torch.convert import train_state_to_reference
    from repro_torch.launch.sharding import local_leaf
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWState
    full = LM(cfg, device="meta").state_dict()
    local = {k: local_leaf(t, k, cfg, N, rank) for k, t in full.items()}
    specs = {k: (None,) * t.dim() for k, t in full.items()}
    moments = {k: torch.empty(t.shape, device="meta")
               for k, t in local.items()}
    state = {"params": local, "opt": AdamWState(
        torch.empty((), dtype=torch.int32, device="meta"), moments,
        dict(moments)), "ef": None}
    sizes, index = {"data": 1, "model": N}, {"data": 0, "model": rank}
    return train_state_to_reference(state, cfg,
                                    shards=(specs, specs, sizes, index))


def test_the_ranks_checkpoint_restores_in_the_reference(results):
    """The reference's ``restore_checkpoint`` on one device reads the four
    ranks' checkpoint (each KV copy written once, by its group's first
    rank): the ranks' joined state bit for bit, the reference's stepped
    state within f32."""
    from repro.checkpoint import restore_checkpoint as jrestore
    from repro.optim.adamw import AdamWState as JAdamWState
    from repro_torch.convert import (lm_params_from_reference,
                                     lm_params_to_reference)
    ref, port, dirs = results
    cfg = config("glm")
    joined = {w: _joined(port["glm"], cfg, w) for w in ("param", "mu", "nu")}
    like = {"params": lm_params_to_reference(joined["param"], cfg),
            "opt": JAdamWState(np.zeros((), np.int32),
                               lm_params_to_reference(joined["mu"], cfg),
                               lm_params_to_reference(joined["nu"], cfg))}
    like["ef"] = _ef_like(like)
    back, step = jrestore(dirs["port"], like)
    assert step == 1
    for what, tree in (("param", back["params"]), ("mu", back["opt"].mu),
                       ("nu", back["opt"].nu)):
        got = lm_params_from_reference(tree, cfg, "cpu")
        for k, v in got.items():
            assert torch.equal(v, joined[what][k]), (what, k)
            np.testing.assert_allclose(v.numpy(), ref[f"glm/{what}/{k}"],
                                       err_msg=f"{what} {k}", **F32)


def _ef_like(like: dict) -> dict:
    """The () fp32 zeros the trees keep in place of every parameter's
    error-feedback residual (no compression)."""
    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(zeros(v) for v in t)
        return np.zeros((), np.float32)
    return zeros(like["params"])


@pytest.mark.parametrize("which", ("ref", "port"))
@pytest.mark.parametrize("rank", range(N))
def test_checkpoints_restore_onto_each_ranks_slices(results, which, rank):
    """Each rank's placement (the plan's blocks) reads its slice of the
    reference's 4-device checkpoint (within f32 of the rank's own stepped
    state) and of the ranks' own (bit for bit, a copy read from its first
    holder's member)."""
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    from repro_torch.convert import train_state_from_reference
    _, port, dirs = results
    cfg = config("glm")
    place = _placement(cfg, rank)
    tree, step = restore_checkpoint(dirs[which], place, shardings=place)
    assert step == 1
    got = train_state_from_reference(tree, cfg, "cpu")
    mine = port["glm"][rank]
    for what, leaves in (("param", got["params"]), ("mu", got["opt"].mu),
                         ("nu", got["opt"].nu)):
        for k, t in leaves.items():
            want = mine[what][k]
            assert t.shape == want.shape, (what, k)
            if which == "port":
                np.testing.assert_array_equal(t.numpy(), want,
                                              err_msg=f"{what} {k}")
            else:
                np.testing.assert_allclose(t.numpy(), want,
                                           err_msg=f"{what} {k}", **F32)
