"""zamba2-7b in the port against the JAX package on the CPU: the shared
gated-linear scan (``models/linear_scan.py``), the Mamba2 SSD block
(``models/ssm.py``), and the ``mamba`` and ``shared_attn`` block kinds of
the reduced config (f32, 8 layers: two super-blocks of mamba, mamba,
shared_attn and two mamba remainder layers; d_model 64, 4 heads of 16,
ssm_state 8, chunk 8), from the reference's own weights carried across with
``repro_torch.convert``, inputs from numpy seeds: the forward, the loss and
its gradients (the shared set one leaf, ``norm_z`` a zero gradient), decode
with and without the ``active`` mask and every cache leaf, forward ==
decode, ragged waves, chunked == whole bit for bit, the served tokens, the
full config's parameter count, the trees both ways, the launchers.

Tolerances, stated per test: F32 = 2e-5 and BF16 = 5e-2 for the scan and
the SSD block alone (the reference's kernel tolerances); 1e-4 where a whole
model's output or its caches are compared (fp32 through eight layers whose
sums run in another order); 1e-4 relative L2 per gradient leaf
(tests/test_torch_train.py); 2e-3 for forward == decode (the reference's
own ``test_recurrent_forward_matches_decode``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, \
    get_reduced as jget_reduced
from repro.models import linear_scan as jscan
from repro.models import ssm as jssm
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import (caches_from_reference, caches_to_reference,
                                 lm_params_from_reference,
                                 lm_params_to_reference,
                                 train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.core import embedding_engine as ee
from repro_torch.kernels.flash_attention import backward_variant
from repro_torch.kernels import ops as kops
from repro_torch.models import linear_scan, ssm
from repro_torch.models.lm import LM
from repro_torch.runtime.server import DecodeServer, Request

ARCH = "zamba2-7b"
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
MODEL = dict(rtol=1e-4, atol=1e-4)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _jnp(a: np.ndarray, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else
                       jnp.float32)


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
    reference's (integer leaves exactly); returns the leaf count."""
    want = jax.tree.leaves(want_tree)
    got = jax.tree.leaves(got_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32 if np.asarray(w).dtype.kind == "V"
                       else None)
        assert g.shape == w.shape
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, np.asarray(w, np.float32), **tol)
    return len(want)


# ---------------------------------------------------------------------------
# the shared scan and the SSD block alone
# ---------------------------------------------------------------------------

def _scan_inputs(seed: int, b=2, s=24, h=3, p=5, n=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = -rng.uniform(0.05, 0.6, (b, s, h)).astype(np.float32)
    scale = rng.uniform(0.1, 1.0, (b, s, h)).astype(np.float32)
    B = rng.standard_normal((b, s, h, n)).astype(np.float32)
    C = rng.standard_normal((b, s, h, n)).astype(np.float32)
    S0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, a, scale, B, C, S0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state0", [False, True])
def test_gated_linear_scan_matches_the_reference(dtype, with_state0):
    """``gated_linear_scan`` over 3 chunks of 8 (x and the carry in
    ``dtype``; a, scale, B, C in fp32, as the SSD block passes them) from
    zeros or a given state: y and the final state at F32 in fp32, BF16 in
    bf16 (where the port rounds at the reference's points)."""
    x, a, scale, B, C, S0 = _scan_inputs(1)
    tdt = getattr(torch, dtype)
    jy, jS = jscan.gated_linear_scan(
        _jnp(x, dtype), jnp.asarray(a), jnp.asarray(scale), jnp.asarray(B),
        jnp.asarray(C), 8, state0=_jnp(S0, dtype) if with_state0 else None)
    y, S = linear_scan.gated_linear_scan(
        _t(x).to(tdt), _t(a), _t(scale), _t(B), _t(C), 8,
        state0=_t(S0).to(tdt) if with_state0 else None)
    assert y.dtype == S.dtype == tdt
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(y), np.asarray(jy, np.float32), **tol)
    np.testing.assert_allclose(_np(S), np.asarray(jS, np.float32), **tol)
    # one chunk of 24 computes the same recurrence
    y1, _ = linear_scan.gated_linear_scan(
        _t(x).to(tdt), _t(a), _t(scale), _t(B), _t(C), 24,
        state0=_t(S0).to(tdt) if with_state0 else None)
    if dtype == "float32":
        np.testing.assert_allclose(_np(y1), _np(y), **F32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        linear_scan.gated_linear_scan(_t(x), _t(a), _t(scale), _t(B), _t(C),
                                      5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_linear_step_matches_the_reference(dtype):
    """Six single-token steps of ``gated_linear_step`` from a given state:
    y and the state at F32 / BF16; the steps replay the chunked scan (its
    final state at F32 in fp32)."""
    x, a, scale, B, C, S0 = _scan_inputs(2, s=6)
    tdt = getattr(torch, dtype)
    jS, S = _jnp(S0, dtype), _t(S0).to(tdt)
    tol = F32 if dtype == "float32" else BF16
    ys = []
    for t in range(6):
        jy, jS = jscan.gated_linear_step(
            jS, _jnp(x[:, t], dtype), jnp.asarray(a[:, t]),
            jnp.asarray(scale[:, t]), _jnp(B[:, t], dtype),
            _jnp(C[:, t], dtype))
        y, S = linear_scan.gated_linear_step(
            S, _t(x[:, t]).to(tdt), _t(a[:, t]), _t(scale[:, t]),
            _t(B[:, t]).to(tdt), _t(C[:, t]).to(tdt))
        np.testing.assert_allclose(_np(y), np.asarray(jy, np.float32), **tol)
        np.testing.assert_allclose(_np(S), np.asarray(jS, np.float32), **tol)
        ys.append(y)
    if dtype == "float32":
        yc, Sc = linear_scan.gated_linear_scan(
            _t(x), _t(a), _t(scale), _t(B), _t(C), 6, state0=_t(S0))
        np.testing.assert_allclose(_np(Sc), _np(S), **F32)
        np.testing.assert_allclose(_np(yc), _np(torch.stack(ys, 1)), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_forward_and_decode_match_the_reference(dtype):
    """The SSD block alone, from the reference's ``init_mamba`` weights
    converted: ``mamba_forward`` over 16 positions (chunks of 8) and five
    ``mamba_decode`` steps into a cache, the outputs and the cache's
    ``state`` and ``conv``: F32 in fp32, BF16 in bf16.  ``A_log``, ``D`` and
    ``dt_bias`` stay fp32 in both dtypes."""
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=dtype)
    jcfg = dataclasses.replace(jget_reduced(ARCH), dtype=dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jp = jssm.init_mamba(jax.random.PRNGKey(3), jcfg, jdt)
    p = {k: (_t(np.asarray(v, np.float32)).to(tdt)
             if v.dtype == jnp.bfloat16 else _t(np.asarray(v)))
         for k, v in jp.items()}
    for k in ("A_log", "D", "dt_bias"):
        assert p[k].dtype == torch.float32
    tol = F32 if dtype == "float32" else BF16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    want = jssm.mamba_forward(jp, jnp.asarray(x, jdt), jcfg)
    got = ssm.mamba_forward(p, _t(x).to(tdt), cfg)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)
    jc = jssm.init_mamba_cache(jcfg, 2, jdt)
    tc = ssm.init_mamba_cache(cfg, 2, tdt)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    for t in range(5):
        xt = x[:, t:t + 1]
        wy, jc = jssm.mamba_decode(jp, jnp.asarray(xt, jdt), jcfg, jc)
        gy = ssm.mamba_decode(p, _t(xt).to(tdt), cfg, tc)
        np.testing.assert_allclose(_np(gy), np.asarray(wy, np.float32), **tol)
        for k in ("state", "conv"):
            assert tc[k].dtype == tdt
            np.testing.assert_allclose(_np(tc[k]),
                                       np.asarray(jc[k], np.float32), **tol)


def test_masked_mamba_decode_keeps_the_inactive_slots_bits():
    """Under ``active`` the inactive slots' state and conv window are the
    same bits as before the step, the active ones' those of the unmasked
    step."""
    cfg = get_reduced(ARCH)
    model = LM(cfg, device="cpu", seed=4)
    p = model.blocks[0].mamba
    tc = ssm.init_mamba_cache(cfg, 3, torch.float32)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32))
    ssm.mamba_decode(p, x, cfg, tc)
    before = {k: v.clone() for k, v in tc.items()}
    free = {k: v.clone() for k, v in tc.items()}
    ssm.mamba_decode(p, x * 2, cfg, free)
    active = torch.tensor([True, False, True])
    ssm.mamba_decode(p, x * 2, cfg, tc, active=active)
    for k in tc:
        assert torch.equal(tc[k][1], before[k][1])
        assert torch.equal(tc[k][active], free[k][active])
        assert not torch.equal(tc[k][0], before[k][0])


# ---------------------------------------------------------------------------
# the model: forward, loss, gradients
# ---------------------------------------------------------------------------

def _tokens(seed: int, b: int = 2, s: int = 16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, s)).astype(np.int32),
            rng.integers(0, 256, (b, s)).astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_reduced_zamba2_forward_matches_the_reference(seed):
    """LM.forward over 2 x 16 tokens and the prefill's last position, at
    1e-4 (a whole model, as test_reduced_chatglm3_matches_the_reference);
    the shared set reaches the output (scaling its wo moves it)."""
    jlm, params, model = _pair(seed)
    tokens, _ = _tokens(seed)
    want, _ = jlm.forward(params, {"tokens": jnp.asarray(tokens)})
    got = model(_t(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL)
    np.testing.assert_allclose(model.prefill(_t(tokens).long()).numpy(),
                               np.asarray(want)[:, -1:], **MODEL)
    with torch.no_grad():
        model.shared["attn"]["wo"].mul_(2)
    assert not torch.allclose(model(_t(tokens).long()), got, **MODEL)


def test_the_shared_set_is_one_parameter_set():
    """One ``shared.{attn,mlp}.*`` set, registered once: 7 tensors in
    ``parameters()`` and ``state_dict()``, none of them under a layer; a
    shared_attn layer owns its two norms; the count equals the
    reference's tree's."""
    jlm, params, model = _pair(0)
    names = [n for n, _ in model.named_parameters()]
    shared = [n for n in names if n.startswith("shared.")]
    assert sorted(shared) == sorted(
        f"shared.{k}" for k in ("attn.wq", "attn.wk", "attn.wv", "attn.wo",
                                "mlp.wi_gate", "mlp.wi_up", "mlp.wo"))
    assert len(names) == len(set(names)) == len(model.state_dict())
    assert sorted(n for n in names if n.startswith("blocks.2.")) == \
        ["blocks.2.norm1", "blocks.2.norm2"]
    assert sum(p.numel() for p in model.parameters()) == \
        sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))


def test_reduced_zamba2_loss_and_gradients_match_jax_grad():
    """The loss at F32 and every gradient leaf against jax.grad(lm.loss)
    (relative L2 per leaf at most 1e-4): the shared set's leaves are one
    each, summing the four occurrences; ``norm_z`` is read nowhere, so its
    gradient is zero (None here, zeros there), as the trainer gives every
    parameter the loss does not reach."""
    jlm, params, model = _pair(2)
    tokens, labels = _tokens(2)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    want_loss = float(jax.jit(jlm.loss)(params, jb))
    want = jax.jit(jax.grad(jlm.loss))(params, jb)
    model.requires_grad_(True)
    loss = model.loss(_t(tokens).long(), _t(labels).long())
    np.testing.assert_allclose(loss.item(), want_loss, **F32)
    loss.backward()
    named = dict(model.named_parameters())
    unreached = sorted(k for k, p in named.items() if p.grad is None)
    assert unreached == sorted(f"blocks.{i}.mamba.norm_z"
                               for i in (0, 1, 3, 4, 6, 7))
    got = lm_params_to_reference(
        {k: p.grad if p.grad is not None else torch.zeros_like(p)
         for k, p in named.items()}, model.cfg)
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(_np, got))[0])
    assert len(got_leaves) == len(want_leaves)
    for path, w in want_leaves:
        key = jax.tree_util.keystr(path)
        g = got_leaves[path]
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, key
        if "norm_z" in key:
            assert not w.any() and not g.any(), key
            continue
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-4, (key, rel)
    assert got["shared"]["attn"]["wq"].shape == (64, 64)


def test_full_zamba2_builds_on_meta_with_the_reference_count():
    """zamba2-7b at its published widths: the reference's ``eval_shape``
    count, about 5.60 B -- 68 mamba layers of 77.68 M (``w_in`` 3584 x
    14496, ``w_out`` 7168 x 3584), one shared set of 205.5 M (13
    occurrences, each owning two norms), the embedding (32,000 x 3584) --
    built without memory; head dim 112."""
    shapes = jax.eval_shape(JLM(jget_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    model = LM(get_config(ARCH), device="meta")
    assert sum(p.numel() for p in model.parameters()) == want
    assert 5.59e9 < want < 5.61e9
    kinds = [type(b).__name__ for b in model.blocks]
    assert kinds.count("MambaBlock") == 68 and \
        kinds.count("SharedAttnBlock") == 13
    assert model.cfg.hd == 112
    assert model.blocks[0].mamba["w_in"].shape == (3584, 14496)
    assert model.blocks[0].mamba["A_log"].dtype == torch.float32
    assert sum(p.numel() for p in model.shared.parameters()) == 205_520_896
    assert sum(p.numel() for p in model.blocks[0].parameters()) == \
        77_683_296


def test_training_at_head_dim_112_refuses_before_the_forward():
    """The flash backward at (112, 112) is not written (ROADMAP.md, K1):
    ``backward_variant`` refuses it on the CPU as on the card, and a
    differentiable attention at that width raises before it runs."""
    with pytest.raises(NotImplementedError, match="K1"):
        backward_variant(torch.bfloat16, 112, 112)
    with pytest.raises(NotImplementedError, match="K1"):
        backward_variant(torch.float32, 112, 112)
    assert backward_variant(torch.bfloat16, 128, 128) == "wgmma"
    q = torch.zeros((1, 4, 2, 112), requires_grad=True)
    with pytest.raises(NotImplementedError, match="K1"):
        kops.attention(q, q.detach(), q.detach())
    with torch.no_grad():              # serving at 112 runs
        assert kops.attention(q, q, q).shape == (1, 4, 2, 112)


# ---------------------------------------------------------------------------
# serving: decode, waves, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_decode_step_matches_the_reference(masked):
    """Six decode micro-steps of 3 slots, with and without the ``active``
    mask: the logits and every cache leaf (the mamba layers' ``state`` and
    ``conv``, the shared_attn layers' ``k``, ``v`` and ``len``; through
    caches_to_reference) at 1e-4, ``len`` exactly."""
    jlm, params, model = _pair(3)
    b = 3
    jc, tc = jlm.init_caches(b, 12), model.init_caches(b, 12)
    assert set(tc[0]) == {"state", "conv"} and \
        set(tc[2]) == {"k", "v", "len"}
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
        # rest: 2 mamba layers; scan: per slot of the pattern
        assert _leaves_close(caches_to_reference(tc, model.cfg), jc,
                             MODEL) == 2 * 2 + 2 * 2 + 3
    if masked:
        assert tc[2]["len"].tolist() == [6, 3, 3]


def test_forward_matches_decode():
    """The reference's own invariant (``test_recurrent_forward_matches_
    decode``): the chunk-parallel forward's logits equal the sequential
    decode's at every position, at 2e-3, over 2 x 12 tokens (chunks of 4:
    ``pick_chunk(12, 8)``) and 2 x 16 (two chunks of 8)."""
    model = LM(get_reduced(ARCH), device="cpu", seed=5)
    for s in (12, 16):
        tokens, _ = _tokens(5, 2, s)
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


def test_ragged_waves_and_resets_match_the_reference():
    """Ragged prefill and decode waves through wave_step, each followed by
    a slot reset (the mamba state and window zeroed with the KV rows):
    logits and every cache leaf at 1e-4."""
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
    the whole-prompt wave's logits and every cache leaf (the mamba state
    and conv window included), bit for bit, then the same greedy decode."""
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
    """The reduced zamba2 served by the port's DecodeServer (pipeline on)
    and the JAX package's at the same chunking, stepped in turn: 5 requests
    of 3-14 prompt tokens and 6 new tokens recycled through 2 slots.  After
    every serving iteration every cache leaf agrees at 1e-4 (the positions
    exactly); the emitted tokens are the same."""
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
    srv.run_until_drained()               # refreshes compile_stats
    assert srv.compile_stats["pipeline_group"]["waves"] == steps


# ---------------------------------------------------------------------------
# the trees both ways, the launchers
# ---------------------------------------------------------------------------

def test_params_caches_and_train_state_round_trip_through_convert():
    """The reference's zamba2 tree (``scan`` stacked over 2 super-blocks,
    ``rest``, the ``shared`` subtree, the mamba leaves with fp32
    ``A_log`` / ``D`` / ``dt_bias``) to the port and back, leaf for leaf and
    dtype for dtype; a reference cache after two decode steps both ways;
    the trainer's state both ways."""
    jlm, params, model = _pair(7)
    tree = lm_params_to_reference(model.state_dict(), model.cfg)
    assert set(tree) == set(params) == {"embed", "final_norm", "scan",
                                        "rest", "shared"}
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
        _, jc = jlm.decode_step(params, jnp.full((b, 1), t + 1, jnp.int32),
                                jc)
    tc = caches_from_reference(jax.tree.map(np.asarray, jc), model.cfg,
                               "cpu")
    assert len(tc) == model.cfg.num_layers
    assert tc[0]["state"].shape == (b, 4, 32, 8) and \
        tc[0]["conv"].shape == (b, 3, 128)
    assert tc[2]["k"].shape == (b, 4, 8, 16)
    back = caches_to_reference(tc, model.cfg)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jc))
    _leaves_close(back, jc, dict(rtol=0, atol=0))
    from repro_torch.optim import adamw
    state = {"params": dict(model.named_parameters()),
             "opt": adamw().init(dict(model.named_parameters())), "ef": None}
    ref_tree = train_state_to_reference(state, model.cfg)
    assert set(ref_tree["params"]["shared"]) == {"attn", "mlp"}
    assert set(ref_tree["opt"].mu["shared"]["mlp"]) == \
        {"wi_gate", "wi_up", "wo"}
    again = train_state_from_reference(ref_tree, model.cfg, "cpu")
    for k, t in state["params"].items():
        assert torch.equal(again["params"][k], t)
        assert torch.equal(again["opt"].mu[k], state["opt"].mu[k])


def test_serve_launcher_serves_the_reduced_zamba2_on_the_cpu(capsys):
    """``launch.serve --arch zamba2-7b --reduced --device cpu --pipeline``:
    every request ends ok."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--pipeline", "--requests", "3", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "'ok': 3" in out


def test_train_launcher_trains_the_reduced_zamba2_on_the_cpu(tmp_path):
    """``launch.train --arch zamba2-7b --reduced --device cpu``: four
    steps, finite losses, a checkpoint whose paths hold the shared set."""
    from repro_torch.launch import train
    out = train.main(["--arch", ARCH, "--reduced", "--steps", "4", "--seq",
                      "16", "--global-batch", "2", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 3 and np.isfinite(out["losses"]).all()
    steps = sorted(p for p in tmp_path.iterdir()
                   if p.name.startswith("step_") and p.is_dir())
    assert steps
    manifest = (steps[-1] / "manifest.json").read_text()
    assert "['shared']['attn']['wq']" in manifest
