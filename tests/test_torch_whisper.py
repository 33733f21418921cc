"""whisper-large-v3 in the port against the JAX package on the CPU: the
``enc_dense`` encoder and the ``xdec`` decoder (causal self-attention,
cross-attention over the encoder's output, MLP), on the reduced config
(f32, 2 decoder + 2 encoder layers, d_model 64, 4 heads), from the
reference's own weights carried across with ``repro_torch.convert``, with
numpy inputs from a seed: the forward, the loss and its gradients, decode
with the encoder context (``batch_ctx``), ragged waves and every cache
leaf, the parameter, cache and train-state trees both ways, the refusals,
the launcher; also the deterministic gradient of the token embedding
(``embedding_engine.Take``) and the server's refusal of an
encoder-decoder model.

Tolerances, stated per test: 1e-4 where a whole model's output is compared
(fp32 through two encoder and two decoder layers whose sums run in another
order, as tests/test_torch_lm.py holds the reduced chatglm3), F32 = 2e-5
for a decode step's logits and cache leaves (as the MoE decode tests),
1e-4 relative L2 per leaf for the gradients (tests/test_torch_train.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, \
    get_reduced as jget_reduced
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import (caches_from_reference, caches_to_reference,
                                 lm_params_from_reference,
                                 lm_params_to_reference,
                                 train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.core import embedding_engine as ee
from repro_torch.models.lm import LM

ARCH = "whisper-large-v3"
F32 = dict(rtol=2e-5, atol=2e-5)
MODEL = dict(rtol=1e-4, atol=1e-4)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _pair(seed: int = 0):
    jcfg = jget_reduced(ARCH)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(seed))
    model = LM(get_reduced(ARCH), device="cpu")
    state = lm_params_from_reference(jax.tree.map(np.asarray, params), jcfg,
                                     "cpu")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return jlm, params, model


def _inputs(model, seed: int, b: int = 2, s: int = 12):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, model.cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, model.cfg.vocab_size, (b, s)).astype(np.int32)
    enc = rng.standard_normal((b, s, model.cfg.d_model)).astype(np.float32)
    return tokens, labels, enc


def _leaves_close(got_tree, want_tree, tol) -> int:
    """Every leaf of the port's reference-shaped tree against the
    reference's (integer leaves exactly); returns the leaf count."""
    want = jax.tree.leaves(want_tree)
    got = jax.tree.leaves(got_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **tol)
    return len(want)


# ---------------------------------------------------------------------------
# forward, prefill, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_reduced_whisper_forward_matches_the_reference(seed):
    """LM.forward with enc_embeds (the encoder over 12 frames, the decoder
    over 12 tokens) and the prefill's last position, at 1e-4 (a whole
    model); the encoder's output alone (``_encode``) at 1e-4 too."""
    jlm, params, model = _pair(seed)
    tokens, _, enc = _inputs(model, seed)
    batch = {"tokens": jnp.asarray(tokens), "enc_embeds": jnp.asarray(enc)}
    want, _ = jlm.forward(params, batch)
    got = model(_t(tokens).long(), enc_embeds=_t(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
    last = model.prefill(_t(tokens).long(), None, _t(enc))
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1:],
                               **MODEL)
    pos = jnp.broadcast_to(jnp.arange(12, dtype=jnp.float32)[None], (2, 12))
    want_enc = jlm._encode(params, jnp.asarray(enc), jlm._ctx(params, pos, 2))
    np.testing.assert_allclose(model._encode(_t(enc)).numpy(),
                               np.asarray(want_enc), **MODEL)
    # the encoder's output reaches the decoder
    other = model(_t(tokens).long(), enc_embeds=_t(enc[::-1].copy()))
    assert not torch.allclose(other, got, **MODEL)


def test_reduced_whisper_loss_and_gradients_match_jax_grad():
    """The loss at 2e-5 and every parameter's gradient (the encoder's
    included, carried to the reference's tree with
    lm_params_to_reference) against jax.grad(lm.loss): relative L2 per
    leaf at most 1e-4."""
    jlm, params, model = _pair(2)
    tokens, labels, enc = _inputs(model, 2)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
          "enc_embeds": jnp.asarray(enc)}
    want_loss = float(jax.jit(jlm.loss)(params, jb))
    want = jax.jit(jax.grad(jlm.loss))(params, jb)
    model.requires_grad_(True)
    loss = model.loss(_t(tokens).long(), _t(labels).long(), None, _t(enc))
    np.testing.assert_allclose(loss.item(), want_loss, **F32)
    loss.backward()
    named = dict(model.named_parameters())
    assert all(p.grad is not None for p in named.values())
    got = lm_params_to_reference({k: p.grad for k, p in named.items()},
                                 model.cfg)
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(_np, got))[0])
    assert len(got_leaves) == len(want_leaves)
    paths = {jax.tree_util.keystr(p) for p, _ in want_leaves}
    assert any("enc_scan" in p for p in paths) and \
        any("xattn" in p for p in paths)
    for path, w in want_leaves:
        g = got_leaves[path]
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-4, (jax.tree_util.keystr(path), rel)


def test_whisper_refuses_what_the_reference_cannot_run():
    """The encoder's rotary runs at the decoder's positions, so the frame
    count must equal the token count (the reference fails inside its
    rotary; the port names the rule); enc_embeds must be in the model's
    dtype (jnp would promote, torch refuses mixed products) and are
    required; a decode needs its ``batch_ctx``."""
    model = LM(get_reduced(ARCH), device="cpu", seed=0)
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="frame count must equal"):
        model(tokens, enc_embeds=torch.zeros((2, 9, 64)))
    with pytest.raises(ValueError, match="model's dtype"):
        model(tokens, enc_embeds=torch.zeros((2, 8, 64),
                                             dtype=torch.float64))
    with pytest.raises(ValueError, match="needs enc_embeds"):
        model(tokens)
    with pytest.raises(ValueError, match="needs enc_embeds"):
        model.loss(tokens, tokens)
    caches = model.init_caches(2, 8)
    with pytest.raises(ValueError, match="batch_ctx"):
        model.decode_step(tokens[:, :1], caches)
    with pytest.raises(ValueError, match="batch_ctx"):
        model.decode_step(tokens[:, :1], caches,
                          batch_ctx={"enc_out": torch.zeros((3, 5, 64))})
    # a text model ignores enc_embeds, as the reference does
    text = LM(get_reduced("chatglm3-6b"), device="cpu", seed=0)
    assert torch.equal(text(tokens, enc_embeds=torch.ones((2, 3, 64))),
                       text(tokens))


def test_full_whisper_builds_on_meta_with_the_reference_count():
    """whisper-large-v3 at its published widths: 1.96 B parameters, the
    reference's count -- 32 xdec layers (1,048.8 M), 32 enc_dense layers
    (838.9 M), the embedding (51,968 x 1280) and frontend_proj -- built
    without memory."""
    shapes = jax.eval_shape(JLM(jget_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    model = LM(get_config(ARCH), device="meta")
    assert sum(p.numel() for p in model.parameters()) == want
    assert 1.95e9 < want < 1.97e9
    cfg = model.cfg
    assert len(model.blocks) == 32 and len(model.enc_blocks) == 32
    assert {type(b).__name__ for b in model.blocks} == {"XdecBlock"}
    assert {type(b).__name__ for b in model.enc_blocks} == {"EncBlock"}
    assert cfg.hd == 64 and cfg.padded_vocab == 51968
    assert model.embed.shape == (51968, 1280)
    dec = sum(p.numel() for p in model.blocks.parameters())
    enc = sum(p.numel() for p in model.enc_blocks.parameters())
    assert (dec, enc) == (1_048_698_880, 838_942_720)
    assert model.blocks[0].xattn["wk"].shape == (1280, 1280)


# ---------------------------------------------------------------------------
# serving: decode with the encoder context, waves, caches
# ---------------------------------------------------------------------------

def _enc_out(model, seed: int, b: int, frames: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, frames, model.cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_decode_step_with_the_encoder_context_matches_the_reference(masked):
    """Five decode micro-steps of 3 slots over an enc_out of 10 frames
    (batch_ctx), with and without the ``active`` mask: logits and every
    cache leaf (through caches_to_reference) at F32, ``len`` exactly."""
    jlm, params, model = _pair(3)
    b = 3
    enc = _enc_out(model, 3, b, 10)
    jctx, tctx = {"enc_out": jnp.asarray(enc)}, {"enc_out": _t(enc)}
    jc, tc = jlm.init_caches(b, 12), model.init_caches(b, 12)
    step = jax.jit(jlm.decode_step)
    rng = np.random.default_rng(3)
    for t in range(5):
        toks = rng.integers(0, model.cfg.vocab_size, (b, 1)).astype(np.int32)
        active = np.array([True, t % 2 == 0, t < 3]) if masked else None
        wl, jc = step(params, jnp.asarray(toks), jc, jctx,
                      None if active is None else jnp.asarray(active))
        gl, tc = model.decode_step(
            _t(toks).long(), tc,
            active=None if active is None else torch.from_numpy(active),
            batch_ctx=tctx)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **F32)
        # k, v and len, each stacked over the layers
        assert _leaves_close(caches_to_reference(tc, model.cfg), jc,
                             F32) == 3
    if masked:
        assert tc[0]["len"].tolist() == [5, 3, 3]


def test_ragged_wave_step_with_the_encoder_context_matches_the_reference():
    """Ragged prefill and decode waves through wave_step(batch_ctx=), each
    followed by a slot reset: logits and every cache leaf at F32."""
    jlm, params, model = _pair(4)
    b = 4
    enc = _enc_out(model, 4, b, 7)
    jctx, tctx = {"enc_out": jnp.asarray(enc)}, {"enc_out": _t(enc)}
    jc, tc = jlm.init_caches(b, 16), model.init_caches(b, 16)
    wave, reset = jax.jit(jlm.wave_step), jax.jit(jlm.reset_slots)
    rng = np.random.default_rng(4)
    for lens, keep in (([5, 2, 0, 3], [True, True, True, False]),
                       ([1, 1, 1, 1], [False, True, True, True]),
                       ([3, 0, 1, 2], [True, True, True, True])):
        lens = np.array(lens, np.int32)
        toks = rng.integers(0, model.cfg.vocab_size,
                            (b, lens.max())).astype(np.int32)
        wl, jc = wave(params, jnp.asarray(toks), jnp.asarray(lens), jc, jctx)
        gl, tc = model.wave_step(toks, lens, tc, batch_ctx=tctx)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **F32)
        jc = reset(jc, jnp.asarray(keep))
        tc = model.reset_slots(tc, np.array(keep))
        _leaves_close(caches_to_reference(tc, model.cfg), jc, F32)


def test_chunked_waves_equal_the_whole_prompt_bit_for_bit():
    """Port against port: prompts fed in waves of 1, 2 or 3 tokens give
    the whole-prompt wave's logits and cache leaves, bit for bit, then the
    same greedy decode."""
    model = LM(get_reduced(ARCH), device="cpu", seed=5)
    b, n = 3, 7
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, model.cfg.vocab_size, (b, n)).astype(np.int32)
    lens = np.array([7, 4, 6], np.int32)
    ctx = {"enc_out": _t(_enc_out(model, 5, b, 9))}

    def drive(chunk):
        caches = model.init_caches(b, 16)
        fed = np.zeros(b, np.int32)
        last = torch.zeros((b, 1, model.cfg.vocab_size))
        while (fed < lens).any():
            take = np.minimum(chunk, lens - fed)
            toks = np.zeros((b, int(take.max())), np.int32)
            for i in range(b):
                toks[i, :take[i]] = prompts[i, fed[i]:fed[i] + take[i]]
            logits, caches = model.wave_step(toks, take, caches,
                                             batch_ctx=ctx)
            last = torch.where(_t(take > 0)[:, None, None], logits, last)
            fed += take
        out = []
        for _ in range(3):
            nxt = last.argmax(-1).numpy().astype(np.int32)
            out.append(nxt[:, 0])
            last, caches = model.wave_step(nxt, np.ones(b, np.int32), caches,
                                           batch_ctx=ctx)
        return last, caches, np.stack(out, 1)

    whole = drive(n)
    for chunk in (1, 2, 3):
        got = drive(chunk)
        assert torch.equal(got[0], whole[0])
        np.testing.assert_array_equal(got[2], whole[2])
        for cg, cw in zip(got[1], whole[1]):
            assert cg.keys() == cw.keys()
            assert all(torch.equal(cg[k], cw[k]) for k in cg)


# ---------------------------------------------------------------------------
# the trees both ways
# ---------------------------------------------------------------------------

def test_params_caches_and_train_state_round_trip_through_convert():
    """The reference's whisper tree (``enc_scan`` stacked, ``enc_norm``,
    ``frontend_proj``, the xdec leaves ``norm_x`` / ``xattn``) to the port
    and back, leaf for leaf; the reference's xdec cache ``{"self": {k, v,
    len}, "enc_out": None}`` both ways; the trainer's state both ways."""
    jlm, params, model = _pair(6)
    tree = lm_params_to_reference(model.state_dict(), model.cfg)
    flat_w = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(_np, tree))[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        np.testing.assert_array_equal(flat_g[path], np.asarray(w))
    # caches: a reference cache after two decode steps, through the port
    b = 2
    enc = _enc_out(model, 6, b, 5)
    jc = jlm.init_caches(b, 8)
    for t in range(2):
        _, jc = jlm.decode_step(params, jnp.full((b, 1), t + 1, jnp.int32),
                                jc, {"enc_out": jnp.asarray(enc)})
    assert jc["scan"][0]["enc_out"] is None
    tc = caches_from_reference(jax.tree.map(np.asarray, jc), model.cfg,
                               "cpu")
    assert len(tc) == model.cfg.num_layers and \
        set(tc[0]) == {"k", "v", "len"}
    assert tc[0]["k"].shape == (b, 4, 8, 16)
    back = caches_to_reference(tc, model.cfg)
    assert back["scan"][0]["enc_out"] is None
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jc))
    _leaves_close(back, jc, dict(rtol=0, atol=0))
    # the trainer's state: parameters and AdamW's moments both ways
    from repro_torch.optim import adamw
    state = {"params": dict(model.named_parameters()),
             "opt": adamw().init(dict(model.named_parameters())), "ef": None}
    ref_tree = train_state_to_reference(state, model.cfg)
    assert set(ref_tree["params"]) >= {"enc_scan", "enc_norm",
                                       "frontend_proj"}
    assert set(ref_tree["opt"].mu["enc_scan"]) == \
        set(params["enc_scan"])
    again = train_state_from_reference(ref_tree, model.cfg, "cpu")
    for k, t in state["params"].items():
        assert torch.equal(again["params"][k], t)
        assert torch.equal(again["opt"].mu[k], state["opt"].mu[k])


def test_train_launcher_trains_the_reduced_whisper_on_the_cpu(tmp_path):
    """``launch.train --arch whisper-large-v3 --reduced --device cpu``:
    the synthetic stream's audio-stub frames (as many as tokens) reach the
    loss through the trainer; four steps, finite losses, a checkpoint."""
    from repro_torch.launch import train
    out = train.main(["--arch", ARCH, "--reduced", "--steps", "4", "--seq",
                      "12", "--global-batch", "2", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 3 and np.isfinite(out["losses"]).all()
    assert any(p.name.startswith("step_") for p in tmp_path.iterdir())


def test_trainer_first_loss_matches_the_reference_on_whisper(tmp_path):
    """The trainer's first loss on the reduced whisper equals the
    reference's loss on the same batch (the data stream's enc_embeds
    included) from the same weights, at F32."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    jlm, params, model = _pair(7)
    data = SyntheticTokens(DataConfig(
        vocab_size=model.cfg.vocab_size, seq_len=12, global_batch=2,
        modality=model.cfg.modality, d_model=model.cfg.d_model,
        enc_seq=12))
    jb = {k: jnp.asarray(v) for k, v in data.batch_at(0).items()}
    want = float(jax.jit(jlm.loss)(params, jb))
    out = Trainer(model, data, TrainerConfig(
        total_steps=1, ckpt_every=10, ckpt_dir=str(tmp_path))).run()
    np.testing.assert_allclose(out["losses"][0], want, **F32)


# ---------------------------------------------------------------------------
# the token embedding's deterministic gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_take_gradient_through_the_block_gather_equals_index_select(dtype):
    """``lookup(strategy="take")`` on a table that needs a gradient goes
    through ``Take``: its forward is index_select's bits, its gradient the
    block gather's (fp32 sums over the transposed lookups, rounded once).
    On repeated ids it equals index_select's stock backward (f32: at 2e-5,
    the same sums in another order; bf16: within one bf16 step, the stock
    one sums in bf16), and two calls give the same bits."""
    rng = np.random.default_rng(8)
    table = _t(rng.standard_normal((50, 24)).astype(np.float32)).to(dtype)
    ids = _t(rng.integers(0, 10, (3, 40)))          # many repeats
    dout = _t(rng.standard_normal((3, 40, 24)).astype(np.float32)).to(dtype)

    def grad(through_take):
        t = table.clone().requires_grad_(True)
        if through_take:
            out = ee.lookup(t, ids, strategy="take")
        else:
            out = t.index_select(0, ids.reshape(-1)).reshape(3, 40, 24)
        out.backward(dout)
        return out.detach(), t.grad

    out, got = grad(True)
    want_out, want = grad(False)
    assert torch.equal(out, want_out)
    assert got.dtype == dtype and got.shape == table.shape
    exact = torch.zeros((50, 24), dtype=torch.float64).index_add_(
        0, ids.reshape(-1), dout.reshape(-1, 24).double())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **F32)
        torch.testing.assert_close(got.double(), exact, **F32)
    else:          # rounded once from fp32, within a bf16 step of exact
        torch.testing.assert_close(got.double(), exact,
                                   rtol=2 ** -8, atol=1e-6)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=5e-2, atol=5e-2)
    assert not bool(got[10:].any())
    assert torch.equal(grad(True)[1], got)


def test_lookup_without_a_gradient_stays_index_select():
    """Serving and frozen tables never build the Function: no grad_fn."""
    table = torch.randn((20, 8))
    ids = torch.tensor([[1, 1, 3]])
    out = ee.lookup(table, ids, strategy="take")
    assert out.grad_fn is None
    t = table.clone().requires_grad_(True)
    with torch.no_grad():
        assert ee.lookup(t, ids, strategy="take").grad_fn is None
    out = ee.lookup(t, ids, strategy="take")        # a view of Take's rows
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "TakeBackward"


# ---------------------------------------------------------------------------
# the server refuses an encoder-decoder model
# ---------------------------------------------------------------------------

def test_server_and_serve_launcher_refuse_an_encoder_decoder_model():
    """A request needs an encoder context (``batch_ctx``) that the
    server's waves do not carry -- the reference's DecodeServer passes none
    either, and its decode_step fails on ``batch_ctx["enc_out"]`` -- so
    the server and the launcher refuse whisper with that reason; whisper
    serves through ``LM.wave_step(batch_ctx=)``."""
    from repro_torch.launch import serve
    from repro_torch.runtime.server import DecodeServer
    model = LM(get_reduced(ARCH), device="cpu", seed=0)
    with pytest.raises(NotImplementedError, match="encoder context"):
        DecodeServer(model, batch_slots=2, max_len=16)
    with pytest.raises(NotImplementedError, match="encoder context"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    # the models the server takes are unchanged
    DecodeServer(LM(get_reduced("chatglm3-6b"), device="cpu", seed=0),
                 batch_slots=2, max_len=16)
