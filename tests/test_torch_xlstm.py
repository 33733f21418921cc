"""xlstm-1.3b in the port against the JAX package on the CPU: the mLSTM and
sLSTM blocks (``models/xlstm.py``) and the ``mlstm`` and ``slstm`` block
kinds of the reduced config (f32, 4 layers: one super-block of mlstm,
mlstm, mlstm, slstm; d_model 64, 4 heads of 16, chunk 8), from the
reference's own weights carried across with ``repro_torch.convert``, inputs
from numpy seeds: each block's forward and decode with every cache leaf,
the model's forward, the loss and its gradients (the fp32 leaves ``w_if``,
``b_i``, ``b_f`` and ``b`` included), decode with and without the
``active`` mask, forward == decode, ragged waves, chunked == whole bit for
bit, the served tokens, the full config's parameter count, the trees both
ways, the launchers.

Tolerances, stated per test: F32 = 2e-5 and BF16 = 5e-2 for a block alone
(the reference's kernel tolerances); 1e-4 where a whole model's output or
its caches are compared (fp32 through four layers whose sums run in another
order); 1e-4 relative L2 per gradient leaf (tests/test_torch_train.py);
2e-3 for forward == decode (the reference's own
``test_recurrent_forward_matches_decode``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, \
    get_reduced as jget_reduced
from repro.models import xlstm as jxlstm
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import (caches_from_reference, caches_to_reference,
                                 lm_params_from_reference,
                                 lm_params_to_reference,
                                 train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.core import embedding_engine as ee
from repro_torch.models import xlstm
from repro_torch.models.lm import LM
from repro_torch.runtime.server import DecodeServer, Request

ARCH = "xlstm-1.3b"
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
MODEL = dict(rtol=1e-4, atol=1e-4)
#: each block kind's init, forward, decode and cache in both packages
KINDS = {
    "mlstm": ((jxlstm.init_mlstm, jxlstm.mlstm_forward, jxlstm.mlstm_decode,
               jxlstm.init_mlstm_cache),
              (xlstm.mlstm_forward, xlstm.mlstm_decode,
               xlstm.init_mlstm_cache), ("w_if", "b_i", "b_f")),
    "slstm": ((jxlstm.init_slstm, jxlstm.slstm_forward, jxlstm.slstm_decode,
               jxlstm.init_slstm_cache),
              (xlstm.slstm_forward, xlstm.slstm_decode,
               xlstm.init_slstm_cache), ("b",)),
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _pair(seed: int = 0, **over):
    jcfg = dataclasses.replace(jget_reduced(ARCH), **over)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(seed))
    model = LM(dataclasses.replace(get_reduced(ARCH), **over), device="cpu")
    state = lm_params_from_reference(jax.tree.map(np.asarray, params), jcfg,
                                     "cpu")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return jlm, params, model


def _leaves_close(got_tree, want_tree, tol) -> int:
    """Every leaf of the port's reference-shaped tree against the
    reference's; returns the leaf count."""
    want = jax.tree.leaves(want_tree)
    got = jax.tree.leaves(got_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w, np.float32), **tol)
    return len(want)


def _tokens(seed: int, b: int = 2, s: int = 16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, s)).astype(np.int32),
            rng.integers(0, 256, (b, s)).astype(np.int32))


# ---------------------------------------------------------------------------
# the blocks alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_block_forward_and_decode_match_the_reference(kind, dtype):
    """One block from the reference's own init, converted: the forward over
    24 positions (mLSTM: three chunks of 8) and six decode steps into a
    cache, the outputs and every cache leaf: F32 in fp32, BF16 in bf16.
    The gate weights and biases stay fp32 in both dtypes, and so do the
    sLSTM cache's ``c``, ``n`` and ``m``."""
    (jinit, jfwd, jdec, jcache), (fwd, dec, cache), fp32 = KINDS[kind]
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=dtype)
    jcfg = dataclasses.replace(jget_reduced(ARCH), dtype=dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jp = jinit(jax.random.PRNGKey(3), jcfg, jdt)
    p = {k: (_t(np.asarray(v, np.float32)).to(tdt)
             if v.dtype == jnp.bfloat16 else _t(np.asarray(v)))
         for k, v in jp.items()}
    assert all(p[k].dtype == torch.float32 for k in fp32)
    tol = F32 if dtype == "float32" else BF16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    want = jfwd(jp, jnp.asarray(x, jdt), jcfg)
    got = fwd(p, _t(x).to(tdt), cfg)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)
    jc, tc = jcache(jcfg, 2, jdt), cache(cfg, 2, tdt)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tc.items()} == \
        {k: (v.shape, getattr(torch, str(v.dtype))) for k, v in jc.items()}
    for t in range(6):
        xt = x[:, t:t + 1]
        wy, jc = jdec(jp, jnp.asarray(xt, jdt), jcfg, jc)
        gy = dec(p, _t(xt).to(tdt), cfg, tc)
        np.testing.assert_allclose(_np(gy), np.asarray(wy, np.float32), **tol)
        for k in tc:
            np.testing.assert_allclose(_np(tc[k]),
                                       np.asarray(jc[k], np.float32), **tol)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_masked_decode_keeps_the_inactive_slots_bits(kind):
    """Under ``active`` the inactive slot's every cache leaf is the same
    bits as before the step, the active ones' those of the unmasked
    step."""
    _, (_, dec, cache), _ = KINDS[kind]
    cfg = get_reduced(ARCH)
    model = LM(cfg, device="cpu", seed=4)
    p = model.blocks[0 if kind == "mlstm" else 3].mixer
    tc = cache(cfg, 3, torch.float32)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32))
    dec(p, x, cfg, tc)
    before = {k: v.clone() for k, v in tc.items()}
    free = {k: v.clone() for k, v in tc.items()}
    dec(p, x * 2, cfg, free)
    active = torch.tensor([True, False, True])
    dec(p, x * 2, cfg, tc, active=active)
    for k in tc:
        assert torch.equal(tc[k][1], before[k][1])
        assert torch.equal(tc[k][active], free[k][active])
        assert not torch.equal(tc[k][0], before[k][0])


def test_slstm_recurrent_term_is_added_head_major():
    """The reference's gate layout, copied as it is: the per-head recurrent
    product (b, h, 4·hd) is reshaped to (b, 4d) head-major, so with 4 heads
    of d/4 head 0's outputs are all of ``z``'s pre-activations.  A carry
    nonzero only in head 0 moves ``z`` (and so ``c``) and leaves the gates
    i, f, o: the stabiliser ``m`` (i and f only) is the zero carry's."""
    cfg = get_reduced(ARCH)
    p = LM(cfg, device="cpu", seed=6).blocks[3].mixer
    d = cfg.d_model
    wx = torch.zeros((1, 4 * d))
    zero = torch.zeros((1, d))
    h = zero.clone()
    h[0, :d // 4] = 1.0
    base = xlstm._slstm_cell(p, cfg, (zero, zero, zero, zero), wx)
    got = xlstm._slstm_cell(p, cfg, (h, zero, zero, zero), wx)
    assert torch.equal(got[3], base[3])
    assert not torch.equal(got[1], base[1])


# ---------------------------------------------------------------------------
# the model: forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_reduced_xlstm_forward_matches_the_reference(seed):
    """LM.forward over 2 x 16 tokens and the prefill's last position, at
    1e-4 (a whole model, as test_reduced_chatglm3_matches_the_reference)."""
    jlm, params, model = _pair(seed)
    tokens, _ = _tokens(seed)
    want, _ = jlm.forward(params, {"tokens": jnp.asarray(tokens)})
    got = model(_t(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
    np.testing.assert_allclose(model.prefill(_t(tokens).long()).numpy(),
                               np.asarray(want)[:, -1:], **MODEL)
    assert [type(b).__name__ for b in model.blocks] == \
        ["MlstmBlock"] * 3 + ["SlstmBlock"]


def test_reduced_xlstm_loss_and_gradients_match_jax_grad():
    """The loss at F32 and every gradient leaf against jax.grad(lm.loss),
    relative L2 per leaf at most 1e-4, over 2 x 24 tokens (the mLSTM's
    three chunks, the sLSTM's 24 steps): every parameter is reached, the
    fp32 gate leaves and the sLSTM's bias among them."""
    jlm, params, model = _pair(2)
    tokens, labels = _tokens(2, s=24)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    want_loss = float(jax.jit(jlm.loss)(params, jb))
    want = jax.jit(jax.grad(jlm.loss))(params, jb)
    model.requires_grad_(True)
    loss = model.loss(_t(tokens).long(), _t(labels).long())
    np.testing.assert_allclose(loss.item(), want_loss, **F32)
    loss.backward()
    named = dict(model.named_parameters())
    assert all(p.grad is not None for p in named.values())
    got = lm_params_to_reference({k: p.grad for k, p in named.items()},
                                 model.cfg)
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(_np, got))[0])
    # embed, final_norm, 3 x (norm1 + 8 mlstm leaves), norm1 + 4 slstm
    assert len(got_leaves) == len(want_leaves) == 34
    for path, w in want_leaves:
        key = jax.tree_util.keystr(path)
        g = got_leaves[path]
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, key
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-4, (key, rel)
    for k in ("w_if", "b_i", "b_f"):
        assert named[f"blocks.0.mlstm.{k}"].grad.dtype == torch.float32
    assert named["blocks.3.slstm.b"].grad.dtype == torch.float32


def test_full_xlstm_builds_on_meta_with_the_reference_count():
    """xlstm-1.3b at its published widths: the reference's ``eval_shape``
    count, 1,161,038,112 -- 36 mlstm layers (five 2048 x 2048 matrices,
    ``w_if`` (2048, 8), ``b_i``, ``b_f``), 12 slstm layers (``w_in`` (2048,
    8192), ``r`` (4, 512, 2048), ``wo``, ``b``), the embedding (50,432 x
    2048) -- built without memory."""
    shapes = jax.eval_shape(JLM(jget_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    model = LM(get_config(ARCH), device="meta")
    assert sum(p.numel() for p in model.parameters()) == want == \
        1_161_038_112
    kinds = [type(b).__name__ for b in model.blocks]
    assert kinds.count("MlstmBlock") == 36 and \
        kinds.count("SlstmBlock") == 12
    assert model.blocks[0].mlstm["w_if"].shape == (2048, 8)
    assert model.blocks[0].mlstm["w_if"].dtype == torch.float32
    assert model.blocks[3].slstm["r"].shape == (4, 512, 2048)
    assert model.blocks[3].slstm["b"].dtype == torch.float32


# ---------------------------------------------------------------------------
# serving: decode, waves, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_decode_step_matches_the_reference(masked):
    """Six decode micro-steps of 3 slots, with and without the ``active``
    mask: the logits and every cache leaf (the mlstm layers' ``C`` and
    ``n``, the slstm layer's ``h``, ``c``, ``n`` and ``m``; through
    caches_to_reference) at 1e-4."""
    jlm, params, model = _pair(3)
    b = 3
    jc, tc = jlm.init_caches(b, 12), model.init_caches(b, 12)
    assert set(tc[0]) == {"C", "n"} and set(tc[3]) == {"h", "c", "n", "m"}
    step = jax.jit(jlm.decode_step)
    rng = np.random.default_rng(3)
    for t in range(6):
        toks = rng.integers(0, 256, (b, 1)).astype(np.int32)
        active = np.array([True, t % 2 == 0, t < 3]) if masked else None
        wl, jc = step(params, jnp.asarray(toks), jc, None,
                      None if active is None else jnp.asarray(active))
        gl, tc = model.decode_step(
            _t(toks).long(), tc,
            active=None if active is None else torch.from_numpy(active))
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **MODEL)
        assert _leaves_close(caches_to_reference(tc, model.cfg), jc,
                             MODEL) == 3 * 2 + 4


def test_forward_matches_decode(monkeypatch):
    """The reference's own invariant (``test_recurrent_forward_matches_
    decode``): the chunk-parallel forward's logits equal the sequential
    decode's at every position, at 2e-3, over 2 x 12 tokens (chunks of 4:
    ``pick_chunk(12, 8)``) and 2 x 16 (two chunks of 8); and so do the
    recurrent states: each mlstm layer's two scans' final states are its
    decode cache's ``C`` and ``n``, the slstm loop's final carry its ``h``,
    ``c``, ``n`` and ``m``."""
    model = LM(get_reduced(ARCH), device="cpu", seed=5)
    finals = []
    scan, loop = xlstm.gated_linear_scan, xlstm._slstm_scan

    def keep(fn, pick):
        def call(*args, **kw):
            out = fn(*args, **kw)
            finals.extend(pick(out))
            return out
        return call
    monkeypatch.setattr(xlstm, "gated_linear_scan",
                        keep(scan, lambda out: [out[1]]))
    monkeypatch.setattr(xlstm, "_slstm_scan", keep(loop, lambda out: out[1]))
    for s in (12, 16):
        tokens, _ = _tokens(5, 2, s)
        finals.clear()
        hs = model(_t(tokens).long())
        fwd = ee.logits(hs, model.embed)[..., :model.cfg.vocab_size]
        caches = model.init_caches(2, s + 4)
        outs = []
        for t in range(s):
            lg, caches = model.decode_step(_t(tokens[:, t:t + 1]).long(),
                                           caches)
            outs.append(lg)
        np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                                   fwd.detach().numpy(), rtol=2e-3,
                                   atol=2e-3)
        leaves = [leaf for c in caches for leaf in c.values()]
        assert len(finals) == len(leaves) == 3 * 2 + 4
        for got, want in zip(leaves, finals):
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_allclose(_np(got), _np(want), rtol=2e-3,
                                       atol=2e-3)


def test_ragged_waves_and_resets_match_the_reference():
    """Ragged prefill and decode waves through wave_step, each followed by
    a slot reset (every recurrent leaf of a retired slot zeroed): logits
    and every cache leaf at 1e-4."""
    jlm, params, model = _pair(4)
    b = 4
    jc, tc = jlm.init_caches(b, 16), model.init_caches(b, 16)
    wave, reset = jax.jit(jlm.wave_step), jax.jit(jlm.reset_slots)
    rng = np.random.default_rng(4)
    for lens, keep in (([5, 2, 0, 3], [True, True, True, False]),
                       ([1, 1, 1, 1], [False, True, True, True]),
                       ([3, 0, 1, 2], [True, True, True, True])):
        lens = np.array(lens, np.int32)
        toks = rng.integers(0, 256, (b, lens.max())).astype(np.int32)
        wl, jc = wave(params, jnp.asarray(toks), jnp.asarray(lens), jc)
        gl, tc = model.wave_step(toks, lens, tc)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **MODEL)
        jc = reset(jc, jnp.asarray(keep))
        tc = model.reset_slots(tc, np.array(keep))
        _leaves_close(caches_to_reference(tc, model.cfg), jc, MODEL)
        for i in np.flatnonzero(~np.array(keep)):
            assert not any(leaf[i].any() for c in tc for leaf in c.values())


def test_chunked_waves_equal_the_whole_prompt_bit_for_bit():
    """Port against port: prompts fed in waves of 1, 2 or 3 tokens give
    the whole-prompt wave's logits and every cache leaf, bit for bit, then
    the same greedy decode."""
    model = LM(get_reduced(ARCH), device="cpu", seed=5)
    b, n = 3, 7
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, 256, (b, n)).astype(np.int32)
    lens = np.array([7, 4, 6], np.int32)

    def drive(chunk):
        caches = model.init_caches(b, 16)
        fed = np.zeros(b, np.int32)
        last = torch.zeros((b, 1, model.cfg.vocab_size))
        while (fed < lens).any():
            take = np.minimum(chunk, lens - fed)
            toks = np.zeros((b, int(take.max())), np.int32)
            for i in range(b):
                toks[i, :take[i]] = prompts[i, fed[i]:fed[i] + take[i]]
            logits, caches = model.wave_step(toks, take, caches)
            last = torch.where(_t(take > 0)[:, None, None], logits, last)
            fed += take
        out = []
        for _ in range(3):
            nxt = last.argmax(-1).numpy().astype(np.int32)
            out.append(nxt[:, 0])
            last, caches = model.wave_step(nxt, np.ones(b, np.int32), caches)
        return last, caches, np.stack(out, 1)

    whole = drive(n)
    for chunk in (1, 2, 3):
        got = drive(chunk)
        assert torch.equal(got[0], whole[0])
        np.testing.assert_array_equal(got[2], whole[2])
        for cg, cw in zip(got[1], whole[1]):
            assert cg.keys() == cw.keys()
            assert all(torch.equal(cg[k], cw[k]) for k in cg)


@pytest.mark.parametrize("chunk", [4, 1])
def test_server_tokens_and_caches_equal_the_references(chunk):
    """The reduced xlstm served by the port's DecodeServer (pipeline on)
    and the JAX package's at the same chunking, stepped in turn: 5 requests
    of 3-14 prompt tokens and 6 new tokens recycled through 2 slots (no
    layer holds positions: max_len bounds only the server's own).  After
    every serving iteration every cache leaf agrees at 1e-4; the emitted
    tokens are the same."""
    from repro.runtime.server import DecodeServer as JDecodeServer, \
        Request as JRequest
    jlm, params, lm = _pair(6)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, int(n)).astype(np.int32)
               for n in (11, 3, 14, 9, 5)]
    kw = dict(batch_slots=2, max_len=32, prefill_chunk=chunk)
    jsrv = JDecodeServer(jlm, params, **kw)
    srv = DecodeServer(lm, pipeline=True, **kw)
    jreqs = [JRequest(prompt=p.copy(), max_new_tokens=6) for p in prompts]
    reqs = [Request(prompt=p.copy(), max_new_tokens=6) for p in prompts]
    for s_, rs in ((jsrv, jreqs), (srv, reqs)):
        for r in rs:
            s_.submit(r)
    steps = 0
    while srv.queue or any(r is not None for r in srv.active):
        srv.step()
        jsrv.step()
        steps += 1
        _leaves_close(caches_to_reference(srv.caches, lm.cfg), jsrv.caches,
                      MODEL)
    assert not jsrv.queue and all(r is None for r in jsrv.active)
    assert all(r.status == "ok" and len(r.out) == 6 for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert srv.serve_stats["waves"] == jsrv.serve_stats["waves"] == steps


# ---------------------------------------------------------------------------
# the trees both ways, the launchers
# ---------------------------------------------------------------------------

def test_params_caches_and_train_state_round_trip_through_convert():
    """The reference's xlstm tree (``scan`` stacked over one super-block,
    an empty ``rest``; fp32 ``w_if``, ``b_i``, ``b_f``, ``b`` beside the
    model's dtype) to the port and back, leaf for leaf and dtype for dtype,
    in f32 and bf16; a reference cache after two decode steps both ways
    (the sLSTM's ``c`` and ``n`` and the mLSTM's ``n`` are not sequence
    leaves); the trainer's state both ways."""
    for dtype in ("float32", "bfloat16"):
        jlm, params, model = _pair(7, dtype=dtype)
        tree = lm_params_to_reference(model.state_dict(), model.cfg)
        assert set(tree) == set(params) == {"embed", "final_norm", "scan",
                                            "rest"}
        flat_w = jax.tree_util.tree_flatten_with_path(params)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        assert len(flat_w) == len(flat_g)
        for path, w in flat_w:
            g = flat_g[path]
            assert str(g.dtype).split(".")[-1] == str(w.dtype), path
            np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32))
        b = 2
        jc = jlm.init_caches(b, 8)
        for t in range(2):
            _, jc = jlm.decode_step(params,
                                    jnp.full((b, 1), t + 1, jnp.int32), jc)
        tc = caches_from_reference(jax.tree.map(np.asarray, jc), model.cfg,
                                   "cpu")
        assert len(tc) == model.cfg.num_layers
        assert tc[0]["C"].shape == (b, 4, 16, 16) and \
            tc[0]["n"].shape == (b, 4, 1, 16)
        assert {k: v.shape for k, v in tc[3].items()} == \
            dict.fromkeys("hcnm", (b, 64))
        assert tc[3]["c"].dtype == torch.float32
        back = caches_to_reference(tc, model.cfg)
        assert jax.tree.structure(back) == jax.tree.structure(
            jax.tree.map(np.asarray, jc))
        _leaves_close(back, jc, dict(rtol=0, atol=0))
    from repro_torch.optim import adamw
    jlm, params, model = _pair(7)
    state = {"params": dict(model.named_parameters()),
             "opt": adamw().init(dict(model.named_parameters())), "ef": None}
    ref_tree = train_state_to_reference(state, model.cfg)
    assert set(ref_tree["opt"].mu["scan"][3]["slstm"]) == \
        {"w_in", "r", "b", "wo"}
    again = train_state_from_reference(ref_tree, model.cfg, "cpu")
    for k, t in state["params"].items():
        assert torch.equal(again["params"][k], t)
        assert torch.equal(again["opt"].mu[k], state["opt"].mu[k])


def test_serve_launcher_serves_the_reduced_xlstm_on_the_cpu(capsys):
    """``launch.serve --arch xlstm-1.3b --reduced --device cpu --pipeline``:
    every request ends ok."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--pipeline", "--requests", "3", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "'ok': 3" in out


def test_train_launcher_trains_the_reduced_xlstm_on_the_cpu(tmp_path):
    """``launch.train --arch xlstm-1.3b --reduced --device cpu``: four
    steps, finite losses, a checkpoint whose paths hold the sLSTM's
    recurrent matrix."""
    from repro_torch.launch import train
    out = train.main(["--arch", ARCH, "--reduced", "--steps", "4", "--seq",
                      "16", "--global-batch", "2", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 3 and np.isfinite(out["losses"]).all()
    steps = sorted(p for p in tmp_path.iterdir()
                   if p.name.startswith("step_") and p.is_dir())
    assert steps
    manifest = (steps[-1] / "manifest.json").read_text()
    assert "['slstm']['r']" in manifest
