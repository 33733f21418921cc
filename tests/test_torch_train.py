"""The port's training path against the JAX package on the CPU.

The same numpy inputs go through both: ``LM.loss`` and its gradient for
every parameter of the reduced configs of every ported kind, from the reference's weights carried
across with ``repro_torch.convert``; AdamW, global-norm clipping, the cosine
schedule and int8 gradient compression on random trees; the synthetic data
stream; and the trainer's first losses.  (The kernels' own gradients:
``tests/test_torch_flash_backward.py``.)

Tolerances: f32 2e-5 and bf16 5e-2 (the reference's own); gradients of a whole model by relative L2 per leaf, 1e-4 at f32; the
trainer's losses at 1e-4 relative (five optimizer steps apart from the
same weights)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.data import pipeline as jpipe
from repro.models.lm import LM as JLM
from repro.optim import compress as jcompress, schedule as jschedule
from repro.optim.adamw import AdamW as JAdamW, \
    apply_updates as japply_updates, clip_by_global_norm as jclip
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_reference, \
    lm_params_to_reference
from repro_torch.data import pipeline as tpipe
from repro_torch.models.lm import LM
from repro_torch.optim import compress as tcompress, schedule as tschedule
from repro_torch.optim.adamw import AdamW as TAdamW, \
    clip_by_global_norm as tclip

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
#: the reduced config of every ported block kind (llava: the vision-stub
#: front end)
LOSS_ARCHS = ["stablelm-3b", "chatglm3-6b", "h2o-danube-1.8b", "gemma3-4b",
              "deepseek-v2-lite-16b", "qwen3-moe-235b-a22b",
              "llava-next-34b", "zamba2-7b", "xlstm-1.3b"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# LM.loss and its gradients
# ---------------------------------------------------------------------------

def _pair(arch: str, seed: int = 0):
    jcfg = jget_reduced(arch)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(seed))
    model = LM(get_reduced(arch), device="cpu")
    model.load_state_dict(lm_params_from_reference(
        jax.tree.map(np.asarray, params), jcfg, "cpu"))
    return jlm, params, model


def _batch(model, seed: int = 0, b: int = 2, s: int = 24):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, model.cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, model.cfg.vocab_size, (b, s)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    fe = None
    if model.cfg.modality == "vision-stub":
        fe = rng.standard_normal((b, 5, model.cfg.d_model)).astype(
            np.float32)
        jb["frontend_embeds"] = jnp.asarray(fe)
        fe = torch.from_numpy(fe)
    return jb, (torch.from_numpy(tokens), torch.from_numpy(labels), fe)


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_lm_loss_matches_the_reference(arch, monkeypatch):
    """The loss value; for the MoE kinds also the aux loss and every
    layer's routing decisions (the top-k expert ids), exactly equal -- read
    from the reference with jit off (its scan then runs on concrete
    arrays) and from the port's ``route``."""
    jlm, params, model = _pair(arch)
    jb, (tokens, labels, fe) = _batch(model)
    want = float(jax.jit(jlm.loss)(params, jb))
    got = model.loss(tokens, labels, fe)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, **F32)
    if not model.cfg.num_experts:
        return
    from repro_torch.models import moe as tmoe
    jroutes, troutes = [], []
    top_k, route = jax.lax.top_k, tmoe.route

    def jrecord(probs, k):
        out = top_k(probs, k)
        jroutes.append(np.asarray(out[1]))
        return out

    def trecord(x2d, router, k):
        out = route(x2d, router, k)
        troutes.append(out[2].numpy())
        return out
    monkeypatch.setattr(jax.lax, "top_k", jrecord)
    monkeypatch.setattr(tmoe, "route", trecord)
    with jax.disable_jit():
        _, want_aux = jlm.forward(params, jb)
    _, aux = model(tokens, fe, with_aux=True)
    assert len(jroutes) == len(troutes) == model.cfg.num_layers
    for j, t in zip(jroutes, troutes):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6,
                               atol=1e-7)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_lm_loss_gradients_match_jax_grad(arch):
    """Every parameter's gradient, carried to the reference's tree with
    lm_params_to_reference, against jax.grad(lm.loss): relative L2 per leaf
    at most 1e-4 (the worst leaf over these configs read 2.6e-6, in
    gemma3-4b)."""
    jlm, params, model = _pair(arch, seed=1)
    jb, (tokens, labels, fe) = _batch(model, seed=1)
    want = jax.jit(jax.grad(jlm.loss))(params, jb)
    model.requires_grad_(True)
    model.loss(tokens, labels, fe).backward()
    named = dict(model.named_parameters())
    # a mamba layer's norm_z is read nowhere, in the reference too: no
    # gradient here (the trainer gives it zeros), zeros from jax.grad
    unreached = [k for k, p in named.items() if p.grad is None]
    assert all(k.endswith(".mamba.norm_z") for k in unreached), unreached
    got = lm_params_to_reference(
        {k: p.grad if p.grad is not None else torch.zeros_like(p)
         for k, p in named.items()}, model.cfg)
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(_np, got))[0])
    assert len(got_leaves) == len(want_leaves)
    worst = 0.0
    for path, w in want_leaves:
        g = got_leaves[path]
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        worst = max(worst, rel)
        assert rel <= 1e-4, (jax.tree_util.keystr(path), rel)
    print(f"worst leaf relative L2 {worst:.3g}")
    assert worst <= 1e-4


def test_lm_params_to_reference_inverts_from_reference():
    jlm, params, model = _pair("gemma3-4b")       # scan and rest
    tree = lm_params_to_reference(model.state_dict(), model.cfg)
    flat_w = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(_np, tree))[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        np.testing.assert_array_equal(flat_g[path], np.asarray(w))


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": rng.standard_normal((300,)).astype(np.float32),
            "c": rng.standard_normal((3, 4, 2)).astype(np.float32) * 10}


def _torch(tree, dtype=torch.float32):
    """Copies: AdamW.apply_ updates in place, and jnp.asarray may share
    the numpy arrays' memory."""
    return {k: torch.tensor(v, dtype=dtype) for k, v in tree.items()}


@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    g = _tree(0)
    want = jclip(jax.tree.map(jnp.asarray, g), max_norm)
    got = tclip(_torch(g), max_norm)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheduled", [False, True])
def test_adamw_matches_the_reference(dtype, scheduled):
    """Three steps from random gradients: the port's in-place ``apply_``
    against the reference's ``update`` then ``apply_updates`` -- the
    moments (fp32) and the parameters in their dtype."""
    td, jd = getattr(torch, dtype), jnp.dtype(dtype)
    lr_t = tschedule.cosine_schedule(1e-2, 1, 5) if scheduled else 1e-2
    lr_j = jschedule.cosine_schedule(1e-2, 1, 5) if scheduled else 1e-2
    topt, jopt = TAdamW(lr=lr_t), JAdamW(lr=lr_j)
    p0 = _tree(1)
    tp = _torch(p0, td)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jd), p0)
    ts, js = topt.init(tp), jopt.init(jp)
    for i in range(3):
        g = _tree(10 + i)
        ts = topt.apply_(tp, _torch(g, td), ts)
        ju, js = jopt.update(jax.tree.map(lambda x: jnp.asarray(x, jd), g),
                             js, jp)
        jp = japply_updates(jp, ju)
    tol = F32 if dtype == "float32" else BF16
    assert int(ts.step) == int(js.step) == 3
    for k in p0:
        assert tp[k].dtype == td and ts.mu[k].dtype == torch.float32
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k], np.float32),
                                   **tol)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]),
                                   **F32)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]),
                                   **F32)


def test_cosine_schedule_matches_the_reference():
    t, j = tschedule.cosine_schedule(3e-4, 4, 20), \
        jschedule.cosine_schedule(3e-4, 4, 20)
    got = [float(t(s)) for s in range(25)]
    want = [float(j(s)) for s in range(25)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_compress_gradients_matches_the_reference():
    """int8 codes equal (round half to even, blocks of 256, a ragged last
    block), and the dequantized gradients and residuals over two steps of
    error feedback."""
    g = _tree(3)
    g["tie"] = (np.arange(512, dtype=np.float32) - 256) / 2   # .5 ties
    for k in g:
        q_t, s_t, pad_t = tcompress.quantize(torch.from_numpy(g[k]))
        q_j, s_j, pad_j = jcompress._quantize(jnp.asarray(g[k]))
        assert pad_t == pad_j
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-7)
    t_ef = tcompress.error_feedback_init(_torch(g))
    j_ef = jcompress.error_feedback_init(jax.tree.map(jnp.asarray, g))
    for step in range(2):
        gs = _tree(20 + step)
        gs["tie"] = g["tie"]
        t_out, t_ef = tcompress.compress_gradients(_torch(gs), t_ef)
        j_out, j_ef = jcompress.compress_gradients(
            jax.tree.map(jnp.asarray, gs), j_ef)
        for k in gs:
            np.testing.assert_allclose(t_out[k].numpy(),
                                       np.asarray(j_out[k]), **F32)
            np.testing.assert_allclose(t_ef[k].numpy(), np.asarray(j_ef[k]),
                                       **F32)


# ---------------------------------------------------------------------------
# Data and the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("modality", ["text", "vision-stub"])
def test_synthetic_tokens_equal_the_reference(modality):
    kw = dict(vocab_size=300, seq_len=20, global_batch=4, modality=modality,
              d_model=8)
    t = tpipe.SyntheticTokens(tpipe.DataConfig(**kw), host_index=1,
                              host_count=2)
    j = jpipe.SyntheticTokens(jpipe.DataConfig(**kw), host_index=1,
                              host_count=2)
    for step in (0, 5):
        got, want = t.batch_at(step), j.batch_at(step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["stablelm-3b", "zamba2-7b", "xlstm-1.3b"])
def test_trainer_first_losses_match_the_reference(tmp_path, arch):
    """The reduced stablelm, zamba2 and xlstm trainers (seq 16, batch 8, as
    the reference's system tests) from the reference's initial weights: the
    first five losses at 1e-4 relative (zamba2: the shared set updated once
    a step from the gradient summed over its occurrences; xlstm: its fp32
    gate leaves updated beside the model's)."""
    from repro.runtime.trainer import Trainer as JTrainer, \
        TrainerConfig as JTrainerConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = jget_reduced(arch)
    jdata = jpipe.SyntheticTokens(jpipe.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=8))
    want = JTrainer(JLM(cfg), jdata, JTrainerConfig(
        total_steps=5, ckpt_every=100, ckpt_dir=str(tmp_path / "j"))).run(
        jax.random.PRNGKey(0))["losses"]
    params = JLM(cfg).init(jax.random.PRNGKey(0))
    model = LM(get_reduced(arch), device="cpu")
    model.load_state_dict(lm_params_from_reference(
        jax.tree.map(np.asarray, params), cfg, "cpu"))
    tdata = tpipe.SyntheticTokens(tpipe.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=8))
    got = Trainer(model, tdata, TrainerConfig(
        total_steps=5, ckpt_every=100, ckpt_dir=str(tmp_path / "t"))).run()[
        "losses"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert dataclasses.asdict(get_reduced(arch)) == dataclasses.asdict(cfg)
