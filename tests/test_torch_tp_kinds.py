"""``mla``, ``enc_dense`` and ``xdec`` over a model axis, against the JAX
package's sharded LM on forced 2- and 4-device CPU meshes.

Reduced DeepSeek-V2-Lite (``mla`` + the MoE FFN: the query heads of
``wq`` / ``w_uk`` / ``w_uv`` and ``wo``'s rows split by the head plan, the
latent's ``w_dkv`` / ``w_kr`` and the latent cache whole on every rank,
the experts split) over 2 and over 4 ranks: the forward (its FFN on the
seq-split expert-parallel path), the teacher-forced ``decode_step``, a
masked ``wave_step`` and its latent cache, and ``DecodeServer``'s tokens.
Reduced whisper-large-v3 (``enc_dense`` + ``xdec``: the encoder's and the
decoder's self-attention, the cross-attention and every MLP split, the
front end and ``enc_norm`` whole) over 2 ranks: the forward, the
``decode_step`` with the encoder context (``batch_ctx``), a masked wave
with it, the loss, every gradient and one clipped AdamW step.  The
reference runs in one subprocess a device count (the ``run_on_mesh``
fixture's forced count, params placed by ``param_specs``), the port on
gloo ranks on the CPU (one spawn a mesh, beside the subprocesses), each
rank's slices cut from the reference's weights by
``convert.lm_params_from_reference(mesh=)``.  Held at the reference
tests' f32 bound (2e-5); served tokens and the caches' integer leaves
exactly; the ranks agree bit for bit.
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
MLA, XDEC = "deepseek-v2-lite-16b", "whisper-large-v3"
#: device count -> the archs run over a model axis of that width
MESHES = {2: (MLA, XDEC), 4: (MLA,)}
CASES = [(n, a) for n, archs in MESHES.items() for a in archs]
IDS = [f"{a}-{n}" for n, a in CASES]
SEED, B, S, MAX_LEN, STEPS, FRAMES = 3, 2, 16, 24, 4, 10
WAVE_LENS = (5, 3)
BATCH, LR, CLIP = 4, 1e-3, 0.05
SERVER_KW = dict(batch_slots=2, max_len=32, prefill_chunk=4)
WHAT = ("grad", "param", "mu", "nu")
_REPO = Path(__file__).resolve().parent.parent


def tokens(cfg) -> np.ndarray:
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def frames(cfg, b: int, n: int, seed: int) -> np.ndarray:
    """Frame embeddings (the encoder's input) or an encoder output."""
    return np.random.default_rng(seed).standard_normal(
        (b, n, cfg.d_model)).astype(np.float32)


def batch(cfg) -> dict:
    """The global training batch: step 0 of the port's synthetic token
    stream and frames of its length."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    b = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                   global_batch=BATCH)).batch_at(0)
    b["enc_embeds"] = frames(cfg, BATCH, S, 23)
    return b


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
import test_torch_tp_kinds as T
from repro.configs import get_reduced
from repro.launch import sharding as shd
from repro.launch.mesh import axis_types_kw
from repro.models.lm import LM, ShardCtx
from repro.optim.adamw import AdamW, AdamWState, apply_updates
from repro.runtime.server import DecodeServer, Request
from repro_torch.convert import caches_from_reference, lm_params_from_reference

n = {devices}
mesh = jax.make_mesh((1, n), ("data", "model"), **axis_types_kw(2))
rep = NamedSharding(mesh, P())
out = {{}}

for arch in T.MESHES[n]:
    cfg = get_reduced(arch)
    key = f"{{arch}}-{{n}}"
    params = LM(cfg).init(jax.random.PRNGKey(T.SEED))
    specs = shd.to_shardings(mesh, shd.sanitize_specs(
        shd.param_specs(params), params, mesh))
    ps = jax.device_put(params, specs)
    lm = LM(cfg, ShardCtx(mesh=mesh))
    toks = jnp.asarray(T.tokens(cfg))
    fb = {{"tokens": toks}}
    ctx = None
    if cfg.enc_layers:
        fb["enc_embeds"] = jnp.asarray(T.frames(cfg, T.B, T.S, 19))
        ctx = {{"enc_out": jnp.asarray(T.frames(cfg, T.B, T.FRAMES, 29))}}
    out[f"{{key}}/fwd"] = np.asarray(jax.jit(lm.forward)(ps, fb)[0])
    dec = jax.jit(lm.decode_step)
    caches = lm.init_caches(T.B, T.MAX_LEN)
    for t in range(T.STEPS):
        lg, caches = dec(ps, toks[:, t:t + 1], caches, ctx)
        out[f"{{key}}/dec/{{t}}"] = np.asarray(lg)
    lg, caches = jax.jit(lm.wave_step)(
        ps, toks[:, :max(T.WAVE_LENS)], jnp.asarray(T.WAVE_LENS),
        lm.init_caches(T.B, T.MAX_LEN), ctx)
    out[f"{{key}}/wave"] = np.asarray(lg)
    port = caches_from_reference(jax.tree.map(np.asarray, caches), cfg, "cpu")
    for li, layer in enumerate(port):
        for k, v in layer.items():
            out[f"{{key}}/cache/{{li}}/{{k}}"] = v.numpy()
    if not cfg.enc_layers:
        srv = DecodeServer(lm, ps, **T.SERVER_KW)
        reqs = [Request(prompt=p, max_new_tokens=m)
                for p, m in T.requests(cfg)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        for i, r in enumerate(reqs):
            out[f"{{key}}/srv/{{i}}"] = np.asarray(r.out, np.int64)
        continue
    opt = AdamW(lr=T.LR, grad_clip=T.CLIP)

    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(lm.loss)(params, batch)
        gn = jnp.sqrt(sum(jnp.sum(jnp.square(g))
                          for g in jax.tree.leaves(grads)))
        upd, opt_state = opt.update(grads, opt_state, params)
        return loss, grads, gn, apply_updates(params, upd), opt_state
    b = jax.device_put({{k: jnp.asarray(v) for k, v in T.batch(cfg).items()}},
                       rep)
    loss, grads, gn, new, ost = jax.jit(step)(
        ps, jax.device_put(opt.init(params), AdamWState(rep, specs, specs)),
        b)
    out[f"{{key}}/loss"], out[f"{{key}}/gn"] = np.asarray(loss), np.asarray(gn)
    for what, tree in (("grad", grads), ("param", new), ("mu", ost.mu),
                       ("nu", ost.nu)):
        for k, v in lm_params_from_reference(
                jax.tree.map(np.asarray, tree), cfg, "cpu").items():
            out[f"{{key}}/{{what}}/{{k}}"] = v.numpy()
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


def _port_arch(arch: str, mesh, ckpt: str) -> dict:
    import jax
    from repro.configs import get_reduced as jget_reduced
    from repro.models.lm import LM as JLM
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.lm import LM, ShardCtx
    from repro_torch.optim.adamw import AdamW, global_sq_norm
    from repro_torch.runtime.server import DecodeServer, Request
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = get_reduced(arch)
    params = jax.tree.map(np.asarray, JLM(jget_reduced(arch)).init(
        jax.random.PRNGKey(SEED)))
    lm = LM(cfg, device="cpu", shard=ShardCtx(mesh))
    lm.load_state_dict(lm_params_from_reference(params, cfg, "cpu",
                                                mesh=mesh))
    toks = torch.from_numpy(tokens(cfg)).long()
    kw, ctx, out = {}, None, {}
    if cfg.enc_layers:
        kw["enc_embeds"] = torch.from_numpy(frames(cfg, B, S, 19))
        ctx = {"enc_out": torch.from_numpy(frames(cfg, B, FRAMES, 29))}
    with torch.no_grad():
        out["fwd"] = _np(lm.forward(toks, **kw))
    caches = lm.init_caches(B, MAX_LEN)
    for t in range(STEPS):
        lg, _ = lm.decode_step(toks[:, t:t + 1], caches, batch_ctx=ctx)
        out[f"dec/{t}"] = _np(lg)
    caches = lm.init_caches(B, MAX_LEN)
    lg, _ = lm.wave_step(toks[:, :max(WAVE_LENS)].numpy(),
                         np.asarray(WAVE_LENS), caches, batch_ctx=ctx)
    out["wave"] = _np(lg)
    out["cache"] = [{k: _np(v) for k, v in c.items()} for c in caches]
    out["held"] = {k: tuple(v.shape) for k, v in lm.state_dict().items()}
    if not cfg.enc_layers:
        srv = DecodeServer(lm, **SERVER_KW)
        reqs = [Request(prompt=p, max_new_tokens=m)
                for p, m in requests(cfg)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        out["srv"] = [list(r.out) for r in reqs]
        return out
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                      global_batch=BATCH))
    tr = Trainer(lm, data, TrainerConfig(ckpt_dir=ckpt, lr=LR))
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
               nu={k: _np(v) for k, v in state["opt"].nu.items()})
    return out


def _port_mesh(rank: int, world: int, ckpt: str) -> dict:
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(world, device="cpu")
    return {a: _port_arch(a, mesh, ckpt) for a in MESHES[world]}


_MEMO: dict = {}


@pytest.fixture
def results(tmp_path_factory) -> tuple:
    """(the reference's npzs as one dict, ``{"<arch>-<n>": [each rank's
    results]}``): both reference subprocesses and the port's two spawns
    run side by side, once."""
    if "res" not in _MEMO:
        from benchmarks._mesh import MESH_SKIP
        tmp = tmp_path_factory.mktemp("tp_kinds")
        procs = {n: _start_reference(n, tmp / f"ref{n}.npz",
                                     tmp / f"ref{n}.log") for n in MESHES}
        port: dict = {}
        try:
            for n in MESHES:
                ranks = run_ranks(_port_mesh, n, (str(tmp / f"ckpt{n}"),))
                for a in MESHES[n]:
                    port[f"{a}-{n}"] = [r[a] for r in ranks]
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


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_matches_the_references_mesh(results, case):
    ref, port = results
    key = f"{case[1]}-{case[0]}"
    for res in port[key]:
        np.testing.assert_allclose(res["fwd"], ref[f"{key}/fwd"], **F32)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_decode_steps_match_the_references_mesh(results, case, step):
    """Teacher-forced micro-steps: MLA's over the whole latent cache on
    every rank, whisper's with the encoder context."""
    ref, port = results
    key = f"{case[1]}-{case[0]}"
    for res in port[key]:
        np.testing.assert_allclose(res[f"dec/{step}"],
                                   ref[f"{key}/dec/{step}"], **F32)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_masked_wave_and_its_caches_match_the_references_mesh(results,
                                                              case):
    """The wave's logits; MLA's latent ``c`` / ``kr`` whole on every rank,
    whisper's self-attention K/V the rank's heads of the reference's;
    ``len`` exactly."""
    from repro_torch.launch.sharding import head_plan
    ref, port = results
    n, arch = case
    key = f"{arch}-{n}"
    cfg = get_reduced(arch)
    for rank, res in enumerate(port[key]):
        np.testing.assert_allclose(res["wave"], ref[f"{key}/wave"], **F32)
        k0, k1 = head_plan(cfg, n, rank).kv
        for li, layer in enumerate(res["cache"]):
            assert set(layer) == ({"c", "kr", "len"} if arch == MLA
                                  else {"k", "v", "len"})
            for k, got in layer.items():
                want = ref[f"{key}/cache/{li}/{k}"]
                if k == "len":
                    np.testing.assert_array_equal(got, want)
                elif k in ("k", "v"):
                    np.testing.assert_allclose(got, want[:, k0:k1], **F32)
                else:
                    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("n", sorted(MESHES))
def test_mla_server_tokens_equal_the_references(results, n):
    ref, port = results
    key = f"{MLA}-{n}"
    for res in port[key]:
        for i, toks in enumerate(res["srv"]):
            assert toks == ref[f"{key}/srv/{i}"].tolist(), i


def test_whisper_loss_and_clipped_norm_match_the_references_mesh(results):
    ref, port = results
    key = f"{XDEC}-2"
    for res in port[key]:
        np.testing.assert_allclose(res["loss"], ref[f"{key}/loss"], **F32)
        np.testing.assert_allclose(res["gn"], ref[f"{key}/gn"], **F32)
        assert res["gn"] > CLIP


@pytest.mark.parametrize("what", WHAT)
def test_every_whisper_leaf_matches_the_references_mesh(results, what):
    """Every gradient (the encoder's, the cross-attention's and the front
    end's among them), and every parameter and moment after the clipped
    step, the ranks' slices joined, against the reference's leaf."""
    from repro_torch.convert import lm_params_gathered
    ref, port = results
    key = f"{XDEC}-2"
    got = lm_params_gathered([{k: torch.from_numpy(v)
                               for k, v in r[what].items()}
                              for r in port[key]], get_reduced(XDEC))
    names = sorted(k for k in ref if k.startswith(f"{key}/{what}/"))
    assert sorted(f"{key}/{what}/{k}" for k in got) == names
    assert any(k.startswith("enc_blocks.") for k in got)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[f"{key}/{what}/{k}"],
                                   err_msg=f"{what} {k}", **F32)


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_ranks_agree_and_hold_the_plans_slices(results, case):
    """Every output bit-equal across the ranks; each rank holds its query
    heads of MLA's ``wq`` / ``w_uk`` / ``w_uv`` and ``wo`` and the whole
    ``w_dkv``, ``w_kr`` and shared experts; whisper's encoder split like
    its decoder, ``frontend_proj`` and ``enc_norm`` whole."""
    n, arch = case
    ranks = results[1][f"{arch}-{n}"]
    cfg = get_reduced(arch)
    for key in ["fwd", "wave"] + [f"dec/{t}" for t in range(STEPS)]:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)
    held = ranks[0]["held"]
    h, hd = cfg.num_heads // n, cfg.hd
    if arch == MLA:
        rd, r = cfg.rope_head_dim, cfg.kv_lora_rank
        assert held["blocks.0.attn.wq"] == (cfg.d_model, h * (hd + rd))
        assert held["blocks.0.attn.w_uk"] == held["blocks.0.attn.w_uv"] == \
            (r, h * hd)
        assert held["blocks.0.attn.wo"] == (h * hd, cfg.d_model)
        assert held["blocks.0.attn.w_dkv"] == (cfg.d_model, r)
        assert held["blocks.0.attn.w_kr"] == (cfg.d_model, rd)
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        assert held["blocks.0.moe.shared.wi_gate"] == (cfg.d_model, fs)
        assert held["blocks.0.moe.wi_gate"][0] == cfg.num_experts // n
        for r_ in ranks[1:]:
            assert r_["srv"] == ranks[0]["srv"]
    else:
        for pre in ("blocks.0.attn", "blocks.0.xattn", "enc_blocks.0.attn"):
            assert held[f"{pre}.wq"] == (cfg.d_model, h * hd), pre
            assert held[f"{pre}.wo"] == (h * hd, cfg.d_model), pre
        assert held["enc_blocks.0.mlp.wi_up"] == (cfg.d_model, cfg.d_ff // n)
        assert held["frontend_proj"] == (cfg.d_model, cfg.d_model)
        assert held["enc_norm"] == (cfg.d_model,)
        assert len({r_["loss"] for r_ in ranks}) == 1


def _mla_state(cfg) -> dict:
    """A seeded one-device trainer state of ``cfg``'s LM (moments drawn
    with numpy)."""
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWState
    params = LM(cfg, device="cpu", seed=SEED).state_dict()
    rng = np.random.default_rng(SEED)

    def draw():
        return {k: torch.from_numpy(rng.standard_normal(
            tuple(t.shape)).astype(np.float32)) for k, t in params.items()}
    return {"params": params, "opt": AdamWState(
        torch.tensor(5, dtype=torch.int32), draw(), draw()), "ef": None}


@pytest.mark.parametrize("mesh_shape", ((1, 2), (1, 4), (2, 2)),
                         ids=lambda m: "x".join(map(str, m)))
def test_sharded_mla_checkpoint_places_leaves_by_the_plan(tmp_path,
                                                          mesh_shape):
    """A sharded checkpoint of reduced DeepSeek-V2-Lite written by every
    rank of a ``(data, model)`` mesh from its own slices, under the
    reference's specs (which split ``w_dkv`` and the shared experts over
    ``model``, where the port keeps them whole), ZeRO-1 moments on
    ``(2, 2)``: the manifest gives every leaf its global shape, the whole
    state reads back bit for bit, and each rank's placement reads back its
    own slices."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.checkpoint.ckpt import (restore_checkpoint,
                                             save_checkpoint, tree_map,
                                             tree_flatten_with_path)
    from repro_torch.convert import (train_state_from_reference,
                                     train_state_to_reference)
    from repro_torch.launch.sharding import (local_leaf, local_shard,
                                             train_specs)
    from repro_torch.optim.adamw import AdamWState
    cfg = get_reduced(MLA)
    full = _mla_state(cfg)
    sizes = dict(zip(("data", "model"), mesh_shape))
    p_specs, o_specs, _ = train_specs(cfg, sizes, 2, 8,
                                      zero1=mesh_shape[0] > 1)
    assert "model" in p_specs["blocks.0.attn.w_dkv"]
    assert any(o_specs.mu[k] != p_specs[k] for k in p_specs) == \
        (mesh_shape[0] > 1)
    shards = [{"data": d, "model": m} for d in range(mesh_shape[0])
              for m in range(mesh_shape[1])]

    def local(index):
        def cut(k, t, spec):
            if spec != p_specs[k]:                       # ZeRO-1 rows
                return local_shard(t, spec, sizes, index).contiguous()
            return local_leaf(t, k, cfg, sizes["model"],
                              index["model"]).contiguous()
        opt = full["opt"]
        return {"params": {k: cut(k, t, p_specs[k])
                           for k, t in full["params"].items()},
                "opt": AdamWState(opt.step, *({k: cut(k, t, o_specs.mu[k])
                                               for k, t in m.items()}
                                              for m in (opt.mu, opt.nu))),
                "ef": None}

    def tree(state, index):
        return train_state_to_reference(
            state, cfg, shards=(p_specs, o_specs.mu, sizes, index))

    with ThreadPoolExecutor(len(shards)) as pool:
        list(pool.map(lambda i: save_checkpoint(
            tmp_path, 1, tree(local(i), i)), shards))
    import json
    manifest = json.loads(
        (tmp_path / "step_000000001" / "manifest.json").read_text())
    want = tree_flatten_with_path(train_state_to_reference(full, cfg))
    assert [(e["path"], tuple(e["shape"])) for e in manifest["leaves"]] == \
        [(p, tuple(x.shape)) for p, x in want]
    meta = tree_map(lambda t: torch.empty_like(t, device="meta"), full)
    back, step = restore_checkpoint(tmp_path,
                                    train_state_to_reference(meta, cfg))
    assert step == 1
    got = train_state_from_reference(back, cfg, "cpu")

    def leaves(state):
        return (("params", state["params"]), ("mu", state["opt"].mu),
                ("nu", state["opt"].nu))
    for (what, g), (_, w) in zip(leaves(got), leaves(full)):
        for k, t in w.items():
            assert torch.equal(g[k], t), (what, k)
    for index in shards:
        mine = local(index)
        place = tree(tree_map(lambda t: torch.empty_like(t, device="meta"),
                              mine), index)
        back, _ = restore_checkpoint(tmp_path, place, shardings=place)
        got = train_state_from_reference(back, cfg, "cpu")
        for (what, g), (_, w) in zip(leaves(got), leaves(mine)):
            for k, t in w.items():
                assert torch.equal(g[k], t), (index, what, k)
