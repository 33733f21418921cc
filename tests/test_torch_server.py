"""The port's serving path on the CPU, against the JAX package: decode
attention and the KV caches (the int8 cache included), the LM's
``decode_step`` / ``wave_step`` / ``reset_slots`` from the reference's own
weights (``convert.lm_params_from_reference``) with every cache leaf held
after ``convert.caches_to_reference``, the in-place masked cache write
against the reference's where-form, the ``DecodeServer`` lifecycle and
fault tests of ``tests/test_server.py`` / ``tests/test_faults.py`` with a
torch ``EchoLM``, and the reference's bit-identity claims (chunked prefill
== whole prompt, staggered admission == solo decode, invariance to
``prefill_chunk``) re-proved port against port.

Tolerance 1e-4 for decode and waves: fp32 through two layers of matmuls,
norms and attention whose sums run in another order (observed ~1e-6)."""
import dataclasses
import inspect
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import attention as jattn
from repro.models.lm import LM as JLM
from repro_torch.configs import get_reduced
from repro_torch.convert import (caches_from_reference, caches_to_reference,
                                 lm_params_from_reference)
from repro_torch.models import attention as tattn
from repro_torch.models.lm import LM, StaticWave
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime.faults import FaultInjector, FaultSpec
from repro_torch.runtime.server import DecodeServer, Request

TOL = dict(rtol=1e-4, atol=1e-4)
REPO = Path(__file__).resolve().parent.parent


class EchoLM:
    """argmax(logits) == last fed token + 1 (mod vocab); the cache is the
    per-slot position counter (the reference test's stub, in torch)."""
    vocab = 64

    def init_caches(self, batch, max_len):
        return [{"len": torch.zeros(batch, dtype=torch.int32)}]

    def wave_step(self, tokens, lens, caches):
        tokens, lens = torch.as_tensor(tokens), torch.as_tensor(lens)
        c = tokens.shape[1]
        idx = (lens.long() - 1).clamp(0, c - 1)
        last = tokens.long().gather(1, idx[:, None])[:, 0]
        logits = torch.nn.functional.one_hot((last + 1) % self.vocab,
                                             self.vocab).float()[:, None]
        caches[0]["len"] += lens.to(torch.int32)
        return logits, caches

    def reset_slots(self, caches, keep):
        caches[0]["len"][~torch.as_tensor(keep)] = 0
        return caches


def _req(prompt, **kw):
    return Request(prompt=np.asarray(prompt, np.int32), **kw)


# ---------------------------------------------------------------------------
# The models against the reference
# ---------------------------------------------------------------------------

def _pair(arch, seed=0, **over):
    """The reference LM and its params, and the port's LM loaded with the
    same weights (fp32 reduced config, ``over`` applied to both)."""
    jcfg = dataclasses.replace(jget_reduced(arch), **over)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(seed))
    lm = LM(dataclasses.replace(get_reduced(arch), **over), device="cpu")
    lm.load_state_dict(lm_params_from_reference(
        jax.tree.map(np.asarray, params), jcfg, "cpu"))
    return jlm, params, lm


def _assert_caches(got: list, want, cfg, exact=False):
    ref = caches_to_reference(got, cfg)
    wl, gl = jax.tree.leaves(want), jax.tree.leaves(ref)
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        w = np.asarray(w)
        assert w.shape == g.shape
        if exact or w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **TOL)


def _head_major(a):
    return torch.from_numpy(np.array(a)).transpose(1, 2).contiguous()


@pytest.mark.parametrize("h,hkv,window", [(8, 2, None), (4, 4, 3),
                                          (16, 1, None), (8, 2, 1),
                                          (8, 2, 8), (4, 2, 100)])
def test_decode_attention_matches_the_reference(h, hkv, window):
    rng = np.random.default_rng(h + hkv)
    b, smax, d = 3, 12, 16
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, smax, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, smax, hkv, d)).astype(np.float32)
    cl = np.array([5, 12, 1], np.int32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(cl),
                                  window=window)
    got = tattn.decode_attention(torch.from_numpy(q), _head_major(k),
                                 _head_major(v), torch.from_numpy(cl),
                                 window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_attn_decode_matches_the_reference(kv_dtype):
    """One layer's decode step on a half-filled cache: the output and every
    cache leaf, the int8 cache's values and scales included."""
    jcfg = dataclasses.replace(jget_reduced("chatglm3-6b"),
                               kv_cache_dtype=kv_dtype)
    cfg = dataclasses.replace(get_reduced("chatglm3-6b"),
                              kv_cache_dtype=kv_dtype)
    p = jattn.init_attn(jax.random.PRNGKey(1), jcfg, jnp.float32)
    rng = np.random.default_rng(2)
    b, smax = 3, 10
    cache = jattn.init_kv_cache(jcfg, b, smax, jnp.float32)
    for t in range(4):     # fill through the reference's own decode
        x = jnp.asarray(rng.standard_normal((b, 1, jcfg.d_model)),
                        jnp.float32)
        _, cache = jattn.attn_decode(p, x, jcfg, cache)
    cache = {**cache, "len": jnp.asarray([4, 2, 9], jnp.int32)}
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    want, wcache = jattn.attn_decode(p, jnp.asarray(x), jcfg, cache)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    one = dataclasses.replace(cfg, num_layers=1)   # a one-layer cache tree

    def tree(c):
        return {"scan": (jax.tree.map(lambda a: a[None], c),), "rest": ()}
    tcache = caches_from_reference(tree(cache), one, "cpu")
    got = tattn.attn_decode(tp, torch.from_numpy(x), cfg, tcache[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_caches(tcache, tree(wcache), one)


def test_slot_update_matches_the_reference():
    """Rows land at each slot's own position; a position past the end
    writes the last row (the reference's clamped dynamic_update_slice)."""
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((3, 6, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    pos = np.array([0, 5, 9], np.int32)
    want = jattn.slot_update(jnp.asarray(cache), jnp.asarray(new),
                             jnp.asarray(pos))
    got = tattn.slot_update(_head_major(cache),
                            torch.from_numpy(new[:, 0]), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.transpose(1, 2).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_in_place_masked_write_equals_the_where_form(kv_dtype):
    """attn_decode with an ``active`` mask writes one row per active slot
    in place; the reference's form writes every slot and keeps
    ``where(active, new, old)`` over the whole cache.  Leaf by leaf equal,
    and every slot's output equal to the unmasked step's."""
    cfg = dataclasses.replace(get_reduced("chatglm3-6b"),
                              kv_cache_dtype=kv_dtype)
    lm = LM(cfg, device="cpu", seed=4)
    blk = lm.blocks[0]
    g = torch.Generator().manual_seed(5)
    base = lm.init_caches(4, 8)[0]
    with torch.inference_mode():
        for _ in range(3):
            tattn.attn_decode(blk.attn, torch.randn(4, 1, cfg.d_model,
                                                    generator=g), cfg, base)
        base["len"].copy_(torch.tensor([3, 0, 7, 8], dtype=torch.int32))
        x = torch.randn(4, 1, cfg.d_model, generator=g)
        active = torch.tensor([True, False, True, False])
        full = {k: t.clone() for k, t in base.items()}
        masked = {k: t.clone() for k, t in base.items()}
        out_full = tattn.attn_decode(blk.attn, x, cfg, full)
        out_masked = tattn.attn_decode(blk.attn, x, cfg, masked,
                                       active=active)
    assert torch.equal(out_full, out_masked)
    for k in base:
        keep = active.view((4,) + (1,) * (base[k].dim() - 1))
        assert torch.equal(masked[k], torch.where(keep, full[k], base[k])), k


@pytest.mark.parametrize("arch", ["chatglm3-6b", "stablelm-3b"])
def test_decode_step_with_active_mask_matches_the_reference(arch):
    jlm, params, lm = _pair(arch)
    rng = np.random.default_rng(1)
    b = 3
    jc = jlm.init_caches(b, 12)
    tc = lm.init_caches(b, 12)
    step = jax.jit(jlm.decode_step)
    for t in range(4):
        toks = rng.integers(0, lm.cfg.vocab_size, (b, 1)).astype(np.int32)
        active = np.array([True, t % 2 == 0, t < 3])
        wl, jc = step(params, jnp.asarray(toks), jc, None,
                      jnp.asarray(active))
        gl, tc = lm.decode_step(torch.from_numpy(toks).long(), tc,
                                active=torch.from_numpy(active))
        assert gl.shape == (b, 1, lm.cfg.vocab_size)
        assert gl.dtype == torch.float32
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
        _assert_caches(tc, jc, lm.cfg)


@pytest.mark.parametrize("arch,kv_dtype", [("chatglm3-6b", "model"),
                                           ("chatglm3-6b", "int8"),
                                           ("stablelm-3b", "model")])
def test_wave_step_and_reset_slots_match_the_reference(arch, kv_dtype):
    """Ragged waves (a slot idle, slots of different lengths), then a reset
    of one slot and another wave: logits and every cache leaf."""
    jlm, params, lm = _pair(arch, kv_cache_dtype=kv_dtype)
    rng = np.random.default_rng(3)
    b, c = 4, 5
    jc = jlm.init_caches(b, 16)
    tc = lm.init_caches(b, 16)
    wave = jax.jit(jlm.wave_step)
    reset = jax.jit(jlm.reset_slots)
    for lens in ([5, 2, 0, 3], [1, 5, 4, 0]):
        toks = rng.integers(0, lm.cfg.vocab_size, (b, c)).astype(np.int32)
        lens = np.array(lens, np.int32)
        wl, jc = wave(params, jnp.asarray(toks), jnp.asarray(lens), jc)
        gl, tc = lm.wave_step(toks, lens, tc)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
        _assert_caches(tc, jc, lm.cfg)
        keep = np.array([True, False, True, True])
        jc = reset(jc, jnp.asarray(keep))
        tc = lm.reset_slots(tc, keep)
        _assert_caches(tc, jc, lm.cfg)


@pytest.mark.parametrize("arch,kv_dtype", [
    ("chatglm3-6b", "model"), ("chatglm3-6b", "int8"),
    ("stablelm-3b", "model"), ("stablelm-3b", "int8"),
    ("deepseek-v2-lite-16b", "model"), ("qwen3-moe-235b-a22b", "model")])
def test_static_wave_matches_the_reference(arch, kv_dtype):
    """The body the server captures in CUDA graphs (``StaticWave``: the
    micro-step over static token / mask / logits buffers, and the slot
    reset over a static keep mask), run eagerly on the CPU over a prefill
    wave (ragged, one slot idle) and a decode wave, with a slot reset after
    each: logits and every cache leaf against the reference's wave_step and
    reset_slots."""
    jlm, params, lm = _pair(arch, kv_cache_dtype=kv_dtype)
    rng = np.random.default_rng(4)
    b = 4
    jc = jlm.init_caches(b, 16)
    tc = lm.init_caches(b, 16)
    wave = jax.jit(jlm.wave_step)
    reset = jax.jit(jlm.reset_slots)
    static = StaticWave(lm, tc)
    for lens, keep in (([5, 2, 0, 3], [True, True, True, False]),
                       ([1, 1, 1, 1], [False, True, True, True])):
        lens = np.array(lens, np.int32)
        toks = rng.integers(0, lm.cfg.vocab_size,
                            (b, lens.max())).astype(np.int32)
        wl, jc = wave(params, jnp.asarray(toks), jnp.asarray(lens), jc)
        gl, tc = static(toks, lens, tc)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
        _assert_caches(tc, jc, lm.cfg)
        jc = reset(jc, jnp.asarray(keep))
        tc = static.reset_slots(tc, np.array(keep))
        _assert_caches(tc, jc, lm.cfg)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "stablelm-3b",
                                  "deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b", "gemma3-4b",
                                  "h2o-danube-1.8b"])
def test_static_wave_equals_the_eager_wave_bit_for_bit(arch):
    """Port against port: one StaticWave whose buffers live across waves
    (as the server's graphs do) against ``LM.wave_step``, which builds
    fresh ones each wave: logits (a fresh tensor each wave) and every cache
    leaf are the same bits, waves and resets interleaved -- no wave leaks
    state into the next through the buffers."""
    lm = LM(get_reduced(arch), device="cpu", seed=0)
    rng = np.random.default_rng(5)
    eager = lm.init_caches(3, 12)
    static = StaticWave(lm, lm.init_caches(3, 12))
    kept = []
    for lens in ([4, 0, 2], [1, 1, 1], [0, 1, 1], [3, 3, 1]):
        lens = np.array(lens, np.int32)
        toks = rng.integers(0, lm.cfg.vocab_size, (3, 4)).astype(np.int32)
        want, eager = lm.wave_step(toks, lens, eager)
        got, _ = static(toks, lens, static.caches)
        assert torch.equal(got, want)
        kept.append(got)
        keep = rng.random(3) < 0.7
        lm.reset_slots(eager, keep)
        static.reset_slots(static.caches, keep)
        for ce, cs in zip(eager, static.caches):
            for k in ce:
                assert torch.equal(ce[k], cs[k]), k
    assert all(a.data_ptr() != static.logits_last.data_ptr() for a in kept)


def test_graph_warm_up_leaves_the_caches_as_they_were():
    """What the capture's warm-up relies on: the masked micro-step under an
    all-False mask and the reset with every slot kept change no cache leaf,
    and a reset with no slot kept zeroes every leaf."""
    lm = LM(get_reduced("chatglm3-6b"), device="cpu", seed=0)
    static = StaticWave(lm, lm.init_caches(2, 8))
    static(np.array([[3, 4, 5], [6, 7, 0]]), np.array([3, 2]),
           static.caches)
    before = [{k: t.clone() for k, t in c.items()} for c in static.caches]
    with torch.inference_mode():         # as the capture runs them
        static.active.fill_(False)
        static.masked_micro_step()
        static.zero_slots()              # keep is all True
    for cb, c in zip(before, static.caches):
        for k in c:
            assert torch.equal(cb[k], c[k]), k
    with torch.inference_mode():
        static.keep.fill_(False)
        static.zero_slots()
    assert all(int(t.count_nonzero()) == 0 for c in static.caches
               for t in c.values())


def test_static_wave_runs_on_the_caches_it_was_built_on():
    lm = LM(get_reduced("chatglm3-6b"), device="cpu", seed=0)
    static = StaticWave(lm, lm.init_caches(2, 8))
    other = lm.init_caches(2, 8)
    with pytest.raises(ValueError, match="caches it was built on"):
        static(np.array([[1], [2]]), np.array([1, 1]), other)
    with pytest.raises(ValueError, match="caches it was built on"):
        static.reset_slots(other, np.array([True, False]))


def test_server_off_the_card_runs_the_lm_wave_eagerly():
    """Only a model on a CUDA device gets the captured wave: a CPU model,
    and a stub without decode_step, run their own wave_step and
    reset_slots."""
    lm = LM(get_reduced("stablelm-3b"), device="cpu", seed=0)
    srv = DecodeServer(lm, batch_slots=2, max_len=16)
    assert srv._wave == lm.wave_step and srv._reset == lm.reset_slots
    echo = EchoLM()
    srv = DecodeServer(echo, batch_slots=2)
    assert srv._wave == echo.wave_step and srv._reset == echo.reset_slots


@pytest.mark.parametrize("arch", ["chatglm3-6b", "deepseek-v2-lite-16b",
                                  "gemma3-4b"])
def test_caches_round_trip_through_the_reference_layout(arch):
    jlm, params, lm = _pair(arch)
    tc = lm.init_caches(2, 6)
    lm.wave_step(np.array([[5, 6, 7], [8, 9, 0]]), np.array([3, 2]), tc)
    tree = caches_to_reference(tc, lm.cfg)
    assert jax.tree.structure(tree) == jax.tree.structure(
        jlm.init_caches(2, 6))
    back = caches_from_reference(tree, lm.cfg, "cpu")
    for a, b in zip(tc, back):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("arch", ["gemma3-4b", "h2o-danube-1.8b"])
def test_windowed_waves_match_the_reference_across_the_window(arch):
    """dense_local layers (window 8) through ragged waves that take slots
    past the window -- a 7-token prefill wave, then 6-token waves -- and
    decode waves, with a slot reset between: logits and every cache leaf
    against the reference's wave_step and reset_slots, through StaticWave
    (the captured body) and LM.wave_step alike."""
    jlm, params, lm = _pair(arch, seed=2)
    rng = np.random.default_rng(6)
    b = 4
    jc = jlm.init_caches(b, 32)
    tc = lm.init_caches(b, 32)
    ec = lm.init_caches(b, 32)
    static = StaticWave(lm, tc)
    wave = jax.jit(jlm.wave_step)
    reset = jax.jit(jlm.reset_slots)
    for lens, keep in (([7, 5, 0, 3], [True] * 4),
                       ([6, 6, 6, 6], [True] * 4),
                       ([1, 1, 1, 1], [True, False, True, True]),
                       ([6, 2, 1, 1], [True] * 4),
                       ([1, 1, 1, 1], [True] * 4)):
        lens = np.array(lens, np.int32)
        toks = rng.integers(0, lm.cfg.vocab_size,
                            (b, lens.max())).astype(np.int32)
        wl, jc = wave(params, jnp.asarray(toks), jnp.asarray(lens), jc)
        gl, tc = static(toks, lens, tc)
        el, ec = lm.wave_step(toks, lens, ec)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
        assert torch.equal(gl, el)
        _assert_caches(tc, jc, lm.cfg)
        jc = reset(jc, jnp.asarray(keep))
        tc = static.reset_slots(tc, np.array(keep))
        ec = lm.reset_slots(ec, np.array(keep))
        _assert_caches(tc, jc, lm.cfg)
    assert int(tc[0]["len"].max()) > lm.cfg.sliding_window


@pytest.mark.parametrize("arch", ["gemma3-4b", "h2o-danube-1.8b",
                                  "llava-next-34b"])
@pytest.mark.parametrize("chunk", [4, 1])
def test_server_tokens_and_caches_equal_the_references_across_the_window(
        arch, chunk):
    """The reduced gemma3 (window 8), danube (window 8) and llava (text
    only, as the reference's server serves it) on the CPU: 5 requests of
    3-14 prompt tokens and 6 new tokens recycled through 2 slots, served by
    the port's DecodeServer and the JAX package's at the same chunking,
    stepped in turn.  After every serving iteration every cache leaf agrees
    (through caches_to_reference) at 1e-4, the positions exactly; the
    emitted tokens are the same."""
    from repro.runtime.server import DecodeServer as JDecodeServer, \
        Request as JRequest
    jlm, params, lm = _pair(arch, seed=3)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, lm.cfg.vocab_size, int(n)).astype(np.int32)
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
        _assert_caches(srv.caches, jsrv.caches, lm.cfg)
    assert not jsrv.queue and all(r is None for r in jsrv.active)
    assert all(r.status == "ok" and len(r.out) == 6 for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert srv.serve_stats["waves"] == jsrv.serve_stats["waves"] == steps


# ---------------------------------------------------------------------------
# Bit-identity claims, port against port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-3b", "chatglm3-6b",
                                  "deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b", "gemma3-4b",
                                  "h2o-danube-1.8b"])
def test_chunked_prefill_bit_identical(arch):
    """Splitting a ragged prompt batch into waves of any chunk size replays
    the same masked micro-step sequence: logits at each slot's last prompt
    token and every cache leaf equal the whole-prompt wave's bit for bit.
    Every slot shares one chunk grid, as in the reference's own test, so
    the MoE archs' capacity contention (inactive slots' token-0 rows take
    capacity) is the same in every split."""
    lm = LM(get_reduced(arch), device="cpu", seed=0)
    b, length = 2, 9
    toks = np.random.default_rng(1).integers(
        0, lm.cfg.vocab_size, (b, length)).astype(np.int32)
    lens = np.array([9, 6], np.int32)
    lg_whole, cache_whole = lm.wave_step(toks, lens, lm.init_caches(b, 16))
    for chunk in (1, 4):
        caches = lm.init_caches(b, 16)
        lg_by_slot = [None] * b
        off = 0
        while off < length:
            n = min(chunk, length - off)
            cl = np.clip(lens - off, 0, n)
            part = np.pad(toks[:, off:off + n], ((0, 0), (0, chunk - n)))
            lg, caches = lm.wave_step(part, cl, caches)
            for i in range(b):
                if cl[i] > 0 and off + cl[i] == lens[i]:
                    lg_by_slot[i] = lg[i]
            off += chunk
        for i in range(b):
            assert torch.equal(lg_by_slot[i], lg_whole[i]), (chunk, i)
        for cw, cc in zip(cache_whole, caches):
            for k in cw:
                assert torch.equal(cw[k], cc[k]), (chunk, k)


def test_wave_step_matches_decode_step_replay():
    lm = LM(get_reduced("stablelm-3b"), device="cpu", seed=0)
    b, length = 2, 6
    toks = np.random.default_rng(2).integers(
        0, lm.cfg.vocab_size, (b, length)).astype(np.int32)
    lens = np.array([6, 4], np.int32)
    lg_wave, cache_wave = lm.wave_step(toks, lens, lm.init_caches(b, 16))
    caches = lm.init_caches(b, 16)
    lg_by_slot = [None] * b
    for t in range(length):
        lg, caches = lm.decode_step(
            torch.from_numpy(toks[:, t:t + 1]).long(), caches,
            active=torch.from_numpy(t < lens))
        for i in range(b):
            if t == lens[i] - 1:
                lg_by_slot[i] = lg[i]
    for i in range(b):
        assert torch.equal(lg_by_slot[i], lg_wave[i])
    for cw, cc in zip(cache_wave, caches):
        for k in cw:
            assert torch.equal(cw[k], cc[k]), k


def test_staggered_admission_matches_solo_decode():
    """Requests recycled through a shared 2-slot server (admitted at
    different waves, into used slots) produce exactly the continuation they
    get when served alone: slot recycling leaks no stale cache state."""
    lm = LM(get_reduced("chatglm3-6b"), device="cpu", seed=0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, lm.cfg.vocab_size, int(n)).astype(np.int32)
               for n in (5, 3, 7, 2, 4)]
    shared = [Request(prompt=p.copy(), max_new_tokens=4) for p in prompts]
    srv = DecodeServer(lm, batch_slots=2, max_len=32, prefill_chunk=3)
    for r in shared:
        srv.submit(r)
    srv.run_until_drained()
    assert all(r.done and r.status == "ok" for r in shared)
    assert len({r.admitted_wave for r in shared}) > 1
    for p, r in zip(prompts, shared):
        solo_req = Request(prompt=p.copy(), max_new_tokens=4)
        solo = DecodeServer(lm, batch_slots=1, max_len=32, prefill_chunk=8)
        solo.submit(solo_req)
        solo.run_until_drained()
        assert solo_req.out == r.out, (p, solo_req.out, r.out)


def test_server_output_invariant_to_prefill_chunk():
    lm = LM(get_reduced("stablelm-3b"), device="cpu", seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, lm.cfg.vocab_size, int(n)).astype(np.int32)
               for n in (4, 6, 2)]
    outs = []
    for chunk in (1, 4):
        reqs = [Request(prompt=p.copy(), max_new_tokens=3) for p in prompts]
        srv = DecodeServer(lm, batch_slots=2, max_len=32,
                           prefill_chunk=chunk, pipeline=True)
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ["chatglm3-6b", "stablelm-3b"])
def test_served_tokens_replay_through_the_reference(arch):
    """A free-running drive of the port's server, replayed teacher-forced
    through the reference's wave_step on the same weights: every emitted
    token is the reference's argmax, or within 1e-4 of its largest
    logit."""
    jlm, params, lm = _pair(arch, seed=1)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, lm.cfg.vocab_size, int(n)).astype(np.int32)
               for n in (7, 3, 5)]
    reqs = [Request(prompt=p.copy(), max_new_tokens=6) for p in prompts]
    srv = DecodeServer(lm, batch_slots=2, max_len=32, prefill_chunk=4,
                       pipeline=True)
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    assert all(r.status == "ok" and len(r.out) == 6 for r in reqs)
    b, lmax = len(reqs), max(len(p) for p in prompts)
    wave = jax.jit(jlm.wave_step)
    toks = np.zeros((b, lmax), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    logits, caches = wave(params, jnp.asarray(toks), jnp.asarray(lens),
                          jlm.init_caches(b, 32))
    for j in range(6):
        lg = np.asarray(logits)[:, 0]
        for i, r in enumerate(reqs):
            top = lg[i].max()
            assert lg[i, r.out[j]] >= top - 1e-4, (i, j, r.out[j],
                                                    int(lg[i].argmax()))
        fed = np.array([[r.out[j]] for r in reqs], np.int32)
        logits, caches = wave(params, jnp.asarray(fed),
                              jnp.ones(b, jnp.int32), caches)


# ---------------------------------------------------------------------------
# Slot lifecycle (EchoLM)
# ---------------------------------------------------------------------------

def test_eos_frees_slot_and_admits_same_iteration():
    srv = DecodeServer(EchoLM(), batch_slots=1, max_len=32, eos_id=5,
                       prefill_chunk=4)
    r1 = _req([4], max_new_tokens=10)     # first generated token is 5 = EOS
    r2 = _req([10], max_new_tokens=3)
    srv.submit(r1)
    srv.submit(r2)
    srv.run_until_drained()
    assert r1.done and r1.out == [5]
    assert r2.done and r2.out == [11, 12, 13]
    assert r2.admitted_wave == r1.finished_wave
    assert srv.serve_stats["slot_resets"] == 2
    assert srv.serve_stats["admitted"] == 2


def test_priority_queue_ordering():
    srv = DecodeServer(EchoLM(), batch_slots=1, max_len=32, prefill_chunk=2)
    reqs = [_req([i + 1], max_new_tokens=2, priority=p)
            for i, p in enumerate([2, 0, 1, 0])]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    order = sorted(range(4), key=lambda i: reqs[i].admitted_wave)
    assert order == [1, 3, 2, 0]
    assert all(r.done for r in reqs)


def test_zero_active_slot_wave_is_a_noop():
    srv = DecodeServer(EchoLM(), batch_slots=2, max_len=16)
    assert srv.step() == 0
    assert srv.run_until_drained() == 0
    assert srv.serve_stats["waves"] == 0


def test_slot_recycling_under_full_queue():
    srv = DecodeServer(EchoLM(), batch_slots=2, max_len=32, prefill_chunk=4)
    rng = np.random.default_rng(0)
    reqs = [_req([int(rng.integers(0, 40))],
                 max_new_tokens=int(rng.integers(1, 6))) for _ in range(9)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    for r in reqs:
        assert r.done
        start = int(r.prompt[0])
        assert r.out == [(start + 1 + j) % EchoLM.vocab
                         for j in range(r.max_new_tokens)]
    assert srv.serve_stats["admitted"] == 9
    assert srv.serve_stats["slot_resets"] == 9
    assert sorted(r.admitted_wave for r in reqs)[2] > 0


def test_max_len_slot_retires_and_recycles():
    srv = DecodeServer(EchoLM(), batch_slots=1, max_len=8, prefill_chunk=4)
    r1 = _req([3, 4, 5, 6], max_new_tokens=50)
    r2 = _req([20], max_new_tokens=2)
    srv.submit(r1)
    srv.submit(r2)
    srv.run_until_drained(max_steps=200)
    assert r1.done and len(r1.out) == 8 - 4 + 1
    assert r2.done and r2.out == [21, 22]


def test_request_service_metrics_are_stamped():
    srv = DecodeServer(EchoLM(), batch_slots=2, max_len=16)
    r = _req([7, 8], max_new_tokens=3)
    srv.submit(r)
    srv.run_until_drained()
    assert r.t_submit is not None and r.t_admit >= r.t_submit
    assert r.t_first >= r.t_admit and r.t_done >= r.t_first
    assert len(r.token_times) == 3
    assert r.finished_wave >= r.admitted_wave


def test_zero_admissible_requests_with_nonempty_queue():
    srv = DecodeServer(EchoLM(), batch_slots=2, max_len=16)
    reqs = [_req([3], max_new_tokens=2, deadline_s=0.0) for _ in range(3)]
    for r in reqs:
        srv.submit(r)
    assert srv.step() == 0
    assert srv.serve_stats["waves"] == 0
    assert srv.serve_stats["expired"] == 3
    assert not srv.queue
    for r in reqs:
        assert r.done and r.status == "expired"
        assert "lapsed in queue" in r.error


def test_all_slots_expire_in_one_wave_then_server_recovers():
    srv = DecodeServer(
        EchoLM(), batch_slots=2, max_len=16,
        faults=FaultInjector([FaultSpec("wave", at=(1,), delay_s=0.4,
                                        delay_only=True)]))
    reqs = [_req([3], max_new_tokens=2, deadline_s=0.1),
            _req([7], max_new_tokens=2, deadline_s=0.1)]
    for r in reqs:
        srv.submit(r)
    srv.step()
    for r in reqs:
        assert r.done and r.status == "expired"
        assert "lapsed in service" in r.error
        assert r.t_first is None and not r.out
    late = _req([10], max_new_tokens=2)
    srv.submit(late)
    srv.run_until_drained()
    assert late.status == "ok" and late.out == [11, 12]


def test_deadline_past_at_admission_pops_next_request():
    srv = DecodeServer(EchoLM(), batch_slots=1, max_len=16)
    dead = _req([3], max_new_tokens=2, deadline_s=0.01)
    live = _req([7], max_new_tokens=2)
    srv.submit(dead)
    srv.submit(live)
    time.sleep(0.02)
    srv.run_until_drained()
    assert dead.status == "expired" and not dead.out
    assert live.status == "ok" and live.out == [8, 9]
    assert srv.serve_stats["admitted"] == 1
    assert dead.admitted_wave is None


def test_per_request_deadline_overrides_server_slo():
    srv = DecodeServer(EchoLM(), batch_slots=1, max_len=16, ttft_slo_s=0.01)
    r = _req([3], max_new_tokens=2, deadline_s=30.0)
    srv.submit(r)
    time.sleep(0.02)
    srv.run_until_drained()
    assert r.status == "ok" and r.out == [4, 5]


def test_auto_capacity_arms_after_warmup():
    srv = DecodeServer(EchoLM(), batch_slots=2, max_len=32,
                       capacity_rps="auto", capacity_warmup_waves=2)
    for k in range(4):
        srv.submit(_req([k], max_new_tokens=3))
    srv.run_until_drained()
    assert srv.capacity_rps is not None and srv.capacity_rps > 0
    assert srv.serve_stats["capacity_rps_live"] is not None


# ---------------------------------------------------------------------------
# Faults through the server (tests/test_faults.py)
# ---------------------------------------------------------------------------

def _echo_run(**kw):
    srv = DecodeServer(EchoLM(), batch_slots=2, max_len=32, prefill_chunk=4,
                       **kw)
    reqs = [_req([10], max_new_tokens=3), _req([20], max_new_tokens=3),
            _req([30], max_new_tokens=2)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained(max_steps=100)
    return srv, reqs


def test_wave_fault_retries_once_and_matches_fault_free():
    _, clean = _echo_run()
    srv, reqs = _echo_run(
        faults=FaultInjector([FaultSpec("wave", at=(2,), times=1)]),
        wave_retries=1)
    assert srv.serve_stats["wave_faults"] == 1
    assert srv.serve_stats["wave_retries"] == 1
    assert srv.serve_stats["failed"] == 0
    for r, c in zip(reqs, clean):
        assert r.done and r.status == "ok" and r.out == c.out


def test_wave_fault_beyond_retries_fails_only_implicated():
    _, clean = _echo_run()
    srv, reqs = _echo_run(
        faults=FaultInjector([FaultSpec("wave", at=(2, 3), times=2)]),
        wave_retries=1)
    assert srv.serve_stats["wave_faults"] == 2
    failed = [r for r in reqs if r.status == "failed"]
    assert failed and len(failed) < len(reqs)
    for r in failed:
        assert r.done and "InjectedFailure" in r.error
    for r, c in zip(reqs, clean):
        if r.status == "ok":
            assert r.out == c.out
    assert srv.serve_stats["failed"] == len(failed)


def test_hung_wave_watchdog_times_out_and_recovers():
    _, clean = _echo_run()
    srv, reqs = _echo_run(
        faults=FaultInjector([FaultSpec("wave", at=(2,), delay_s=1.0,
                                        delay_only=True)]),
        wave_deadline_s=0.25, wave_retries=2)
    assert srv.serve_stats["watchdog_timeouts"] >= 1
    assert srv.serve_stats["wave_retries"] >= 1
    for r, c in zip(reqs, clean):
        assert r.done and r.status == "ok" and r.out == c.out


def test_hung_wave_without_retries_fails_typed():
    srv, reqs = _echo_run(
        faults=FaultInjector([FaultSpec("wave", at=(1,), delay_s=0.2,
                                        delay_only=True)]),
        wave_deadline_s=0.05, wave_retries=0)
    failed = [r for r in reqs if r.status == "failed"]
    assert failed and all("WaveTimeout" in r.error for r in failed)


def test_prompt_hardening_strict_fails_typed():
    srv = DecodeServer(EchoLM(), batch_slots=1, max_len=16)
    bad = _req([70, 3], max_new_tokens=2)      # vocab is 64
    srv.submit(bad)
    assert bad.done and bad.status == "failed"
    assert "MalformedAccessError" in bad.error
    assert not srv.queue
    ok = _req([3], max_new_tokens=2)
    srv.submit(ok)
    srv.run_until_drained()
    assert ok.status == "ok" and ok.out == [4, 5]


@pytest.mark.parametrize("policy", ["clamp", "drop"])
def test_prompt_hardening_degrades_and_counts(policy):
    srv = DecodeServer(EchoLM(), batch_slots=1, max_len=16,
                       index_policy=policy)
    r = _req([70, 3], max_new_tokens=2)
    srv.submit(r)
    srv.run_until_drained()
    assert r.status == "ok" and r.out == [4, 5]
    assert srv.serve_stats["oob_prompt_tokens"] == 1


def test_prompt_drop_to_empty_fails():
    srv = DecodeServer(EchoLM(), batch_slots=1, max_len=16,
                       index_policy="drop")
    r = _req([70, 99], max_new_tokens=2)
    srv.submit(r)
    assert r.done and r.status == "failed" and "empty" in r.error


def test_submit_shed_on_predicted_queue_wait():
    srv = DecodeServer(EchoLM(), batch_slots=1, max_len=16,
                       capacity_rps=1.0, ttft_slo_s=0.5)
    r1, r2 = _req([3], max_new_tokens=2), _req([4], max_new_tokens=2)
    srv.submit(r1)
    srv.submit(r2)
    assert r2.done and r2.status == "shed"
    assert "predicted queue wait" in r2.error
    assert srv.serve_stats["shed"] == 1
    srv.run_until_drained()
    assert r1.status == "ok" and r1.out == [4, 5]


def test_every_request_reaches_exactly_one_terminal_status():
    srv, reqs = _echo_run(
        faults=FaultInjector([FaultSpec("wave", at=(1, 2), times=2)]),
        wave_retries=0)
    for r in reqs:
        assert r.done and r.status in ("ok", "shed", "expired", "failed")
        assert r.t_done is not None


@pytest.mark.parametrize("site,kw", [
    ("transfer", {}),
    ("dispatch", {}),
    # "result" only fires when the watchdog consumes the wave handles
    ("result", {"wave_deadline_s": 30.0}),
])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_pipeline_site_fault_recovers_bit_identical(site, kw, backend):
    """A fault at a pipeline-group site through the real server: the wave
    retries after a group reset and every request's tokens equal a clean
    run's."""
    lm = LM(get_reduced("chatglm3-6b"), device="cpu", seed=0)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, lm.cfg.vocab_size, 4).astype(np.int32)
               for _ in range(3)]

    def run(faults=None):
        srv = DecodeServer(lm, batch_slots=2, max_len=32, prefill_chunk=4,
                           pipeline=True, faults=faults, wave_retries=1,
                           **kw)
        if backend == "torch":   # the stock-op group, one copy a wave
            srv.pipeline_group = lm.embedding_pipeline(2, 1,
                                                       backend="torch")
            srv.pipeline_group.faults = faults
        reqs = [Request(prompt=p.copy(), max_new_tokens=3) for p in prompts]
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained(max_steps=100)
        return srv, reqs

    _, clean = run()
    srv, reqs = run(FaultInjector([FaultSpec(site, at=(2,), times=1)]))
    assert srv.serve_stats["wave_faults"] == 1
    assert srv.serve_stats["wave_retries"] == 1
    assert srv.pipeline_group.stats["resets"] >= 1
    for r, c in zip(reqs, clean):
        assert r.done and r.status == "ok" and r.out == c.out


# ---------------------------------------------------------------------------
# The server's knobs, the pipeline it feeds, the launcher
# ---------------------------------------------------------------------------

def test_server_feeds_the_decode_embed_pipeline():
    """pipeline=True mirrors every wave's tokens into the decode-embed
    group (backend "cuda": the block gather's plain version here); its
    outputs are the embed rows of the wave's tokens, and the stock-op group
    gives the same bits."""
    lm = LM(get_reduced("chatglm3-6b"), device="cpu", seed=2)
    srv = DecodeServer(lm, batch_slots=2, max_len=32, prefill_chunk=4,
                       pipeline=True)
    grp = srv.pipeline_group
    assert grp.names == ["chatglm3-reduced-decode-embed"]
    assert grp.executors[0].backend == "cuda"
    seen = []
    submit_wave = grp.submit_wave

    def spy(wave):
        hs = submit_wave(wave)
        seen.append((wave, hs))
        return hs
    grp.submit_wave = spy
    for n in (3, 5):
        srv.submit(_req(np.arange(n) + 7, max_new_tokens=2))
    srv.run_until_drained()
    assert len(seen) == srv.serve_stats["waves"]
    cs = srv.compile_stats
    assert {"executor", "executor_cache", "pipeline_group"} <= set(cs)
    assert cs["pipeline_group"]["waves"] == len(seen)
    stock = lm.embedding_pipeline(2, 1, backend="torch")
    for wave, hs in seen:
        ins = wave[grp.names[0]]
        got = hs[grp.names[0]].result()
        want = lm.embed[torch.from_numpy(ins["tok_embed"]["idxs"]).long()]
        assert torch.equal(got["tok_embed"][:, 0], want)
        assert torch.equal(got["label_gather"][:, 0], want)
        other = stock.submit_wave(wave)[grp.names[0]].result()
        for n in got:
            assert torch.equal(got[n], other[n])


class _FakePool:
    pool_id = -1


@pytest.mark.parametrize("kw,error", [
    ({"service": "remote"}, "service 'remote' not in"),
    ({"service": "disagg"}, "requires a service_pool"),
    ({"service": "disagg", "service_pool": _FakePool(),
      "degrade_policy": "drop"}, "degrade_policy 'drop' not in"),
    ({"service_pool": _FakePool(), "degrade_policy": "stale"}, None)])
def test_service_knobs_are_validated_as_the_references(kw, error):
    """The disaggregated tier's knobs, checked as the reference asserts
    them (``runtime/server.py``, ``core/executor.py``): an unknown service,
    ``"disagg"`` without a pool, an unknown degrade policy; an in-process
    server ignores a pool and a policy (no member routes to them)."""
    lm = LM(get_reduced("chatglm3-6b"), device="cpu", seed=0)
    if error is None:
        srv = DecodeServer(lm, batch_slots=1, pipeline=True, **kw)
        ex = srv.pipeline_group.executors[0]
        assert srv._svc_kw == {} and ex.service == "inproc"
        assert ex.service_pool is None and ex.degrade_policy == "fail"
        return
    with pytest.raises(ValueError, match=error):
        DecodeServer(lm, batch_slots=1, pipeline=True, **kw)


def test_embedding_executor_is_single_device_only():
    """An LM without a mesh gets the single-device executor, whatever
    ``mesh`` it names (a sharded LM's: tests/test_torch_tensor_parallel.py;
    a mesh is no longer a server argument: it comes from the model)."""
    lm = LM(get_reduced("chatglm3-6b"), device="cpu")
    ex = lm.embedding_executor(4, 1)
    assert ex.device == torch.device("cpu") and ex.backend == "cuda"
    assert ex.shards == 1 and lm.embedding_executor(4, 1, mesh=None) is ex
    assert lm.compile_embeddings(4, 1).program.signature() == \
        lm.embedding_program(4, 1).signature()
    assert set(lm.embedding_table_inputs()) == {"tok_embed", "label_gather"}
    with pytest.raises(TypeError, match="mesh"):
        DecodeServer(lm, batch_slots=1, mesh=object())


def test_faults_module_is_the_references_copy():
    """Same source text apart from the imports."""
    def body(path):
        return [ln for ln in Path(path).read_text().splitlines()
                if not ln.startswith(("from ", "import "))]
    assert body(REPO / "src/repro_torch/runtime/faults.py") == \
        body(REPO / "src/repro/runtime/faults.py")
    assert tfaults.SITES == ("marshal", "transfer", "dispatch", "result",
                             "wave", "step", "rpc_send", "rpc_recv",
                             "heartbeat", "service_crash")
    assert issubclass(tfaults.WaveTimeout, tfaults.EmberFault)


MOE_ARCHS = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("chunk", [4, 1])
def test_moe_server_tokens_equal_the_references(arch, chunk):
    """A reduced MoE model served on the CPU (4 slots, 6 requests recycled
    through them, the same prefill chunk) emits exactly the JAX package's
    DecodeServer tokens for the same requests and weights.  The comparison
    is at equal chunking: in an MoE model the tokens depend on it, in the
    reference too (ROADMAP.md, reference caveat (c))."""
    from repro.runtime.server import DecodeServer as JDecodeServer, \
        Request as JRequest
    jlm, params, lm = _pair(arch, seed=4)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, lm.cfg.vocab_size, int(n)).astype(np.int32)
               for n in (7, 3, 5, 9, 2, 6)]
    kw = dict(batch_slots=4, max_len=32, prefill_chunk=chunk)
    jsrv = JDecodeServer(jlm, params, **kw)
    jreqs = [JRequest(prompt=p.copy(), max_new_tokens=5) for p in prompts]
    srv = DecodeServer(lm, pipeline=True, **kw)
    reqs = [Request(prompt=p.copy(), max_new_tokens=5) for p in prompts]
    for s_, rs in ((jsrv, jreqs), (srv, reqs)):
        for r in rs:
            s_.submit(r)
        s_.run_until_drained()
    assert all(r.status == "ok" and len(r.out) == 5 for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert srv.serve_stats["waves"] == jsrv.serve_stats["waves"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_server_tokens_depend_on_the_chunking_as_the_references(arch):
    """Reference caveat (c): in an MoE model the inactive slots' token-0
    rows take expert capacity, so the served tokens depend on the prefill
    chunk -- in the JAX package's server too.  At chunk 1 and at chunk 8
    (4 slots, 6 requests of 4-19 tokens, 8 new tokens) the port emits the
    reference's tokens, and the requests whose tokens agree across the two
    chunkings are the same ones (2 of 6 with these seeds)."""
    from repro.runtime.server import DecodeServer as JDecodeServer, \
        Request as JRequest
    jlm, params, lm = _pair(arch, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, lm.cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(4, 20, 6)]
    outs = {}
    for chunk in (1, 8):
        kw = dict(batch_slots=4, max_len=64, prefill_chunk=chunk)
        jsrv, srv = JDecodeServer(jlm, params, **kw), DecodeServer(lm, **kw)
        for name, s_, make in (("ref", jsrv, JRequest), ("port", srv,
                                                         Request)):
            reqs = [make(prompt=p.copy(), max_new_tokens=8)
                    for p in prompts]
            for r in reqs:
                s_.submit(r)
            s_.run_until_drained()
            outs[name, chunk] = [r.out for r in reqs]
        assert outs["port", chunk] == outs["ref", chunk], chunk
    agree = [a == b for a, b in zip(outs["ref", 1], outs["ref", 8])]
    assert agree == [a == b for a, b in zip(outs["port", 1],
                                            outs["port", 8])]
    assert sum(agree) == 2


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_server_feeds_both_pipeline_members(arch):
    """An MoE model's pipeline group has two members, the decode-embed and
    the MoE un-dispatch program, and every wave feeds both in one
    ``submit_wave``: the un-dispatch member gathers the zero capacity
    buffer at the reference's stream ``arange(segments) · (tok[0] + 1) mod
    rows``."""
    from repro_torch.models import moe as tmoe
    lm = LM(get_reduced(arch), device="cpu", seed=2)
    srv = DecodeServer(lm, batch_slots=2, max_len=32, prefill_chunk=4,
                       pipeline=True)
    grp = srv.pipeline_group
    cfg = lm.cfg
    assert grp.names == [f"{cfg.name}-decode-embed",
                         f"{cfg.name}-moe-undispatch"]
    assert all(ex.backend == "cuda" for ex in grp.executors)
    op = grp.executor(grp.names[1]).compiled.program.op("moe_undispatch")
    assert op.num_segments == 2 * cfg.experts_per_tok
    assert op.num_embeddings == cfg.num_experts * tmoe.capacity_of(cfg, 2)
    seen = []
    submit_wave = grp.submit_wave

    def spy(wave):
        hs = submit_wave(wave)
        seen.append((wave, hs))
        return hs
    grp.submit_wave = spy
    for n in (3, 5):
        srv.submit(_req(np.arange(n) + 7, max_new_tokens=2))
    srv.run_until_drained()
    waves = srv.serve_stats["waves"]
    assert len(seen) == waves
    stats = srv.compile_stats["pipeline_group"]
    assert stats["submitted"] == {n: waves for n in grp.names}
    for wave, hs in seen:
        assert set(wave) == set(grp.names)
        ins = wave[grp.names[1]]["moe_undispatch"]
        tok0 = int(wave[grp.names[0]]["tok_embed"]["idxs"][0])
        want = (np.arange(op.num_segments) * (tok0 + 1)) % op.num_embeddings
        np.testing.assert_array_equal(ins["idxs"], want)
        assert ins["table"] is srv._cap_buf
        got = hs[grp.names[1]].result()["moe_undispatch"]
        assert got.shape == (op.num_segments, 1, cfg.d_model)
        assert not bool(got.any())


def test_launcher_serves_on_the_cpu(capsys):
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", "stablelm-3b", "--reduced", "--device",
                       "cpu", "--requests", "3", "--max-len", "32",
                       "--pipeline"])
    assert all(r.status == "ok" and len(r.out) == 16 for r in reqs)
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "pipeline_group:" in out
    assert "service_pool:" not in out and "artifact:" not in out
    assert "argv" in inspect.signature(serve.main).parameters


def test_launcher_boots_from_an_artifact_dir_on_the_cpu(capsys, tmp_path):
    """``--artifact-dir``: the first launch compiles and saves, the second
    boots from the artifact and serves the same tokens."""
    from repro_torch.core.executor import clear_executor_cache
    from repro_torch.core.pipeline import clear_compile_cache
    from repro_torch.launch import serve
    argv = ["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
            "--requests", "2", "--max-len", "32",
            "--artifact-dir", str(tmp_path / "artifact")]
    sources, outs = [], []
    for _ in range(2):
        clear_executor_cache()
        clear_compile_cache()
        reqs = serve.main(argv)
        assert all(r.status == "ok" and len(r.out) == 16 for r in reqs)
        out = capsys.readouterr().out
        line = next(ln for ln in out.splitlines()
                    if ln.startswith("artifact:"))
        sources.append(line.split("'compile_source': ")[1].split(",")[0])
        outs.append([r.out for r in reqs])
    assert sources == ["'fresh'", "'artifact'"] and outs[0] == outs[1]


def test_launcher_serves_disagg_over_two_replicas_on_the_cpu(capsys):
    """``--disagg --replicas 2``: the decode-embed pipeline over two replica
    processes on the CPU; every request ok, the in-process tokens, both
    replicas live, the pool's steps those of the waves."""
    from repro_torch.launch import serve
    argv = ["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
            "--requests", "3", "--max-len", "32", "--pipeline"]
    want = [r.out for r in serve.main(argv)]
    capsys.readouterr()
    reqs = serve.main(argv + ["--disagg", "--replicas", "2",
                              "--degrade-policy", "stale"])
    assert [r.out for r in reqs] == want
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("service_pool:"))
    assert "'states': ['live', 'live']" in line
    assert "'failovers': 0" in line and "'rpc_steps': 0" not in line


def test_launcher_serves_a_moe_model_on_the_cpu(capsys):
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", "deepseek-v2-lite-16b", "--reduced",
                       "--device", "cpu", "--requests", "3", "--max-len",
                       "32", "--pipeline"])
    assert all(r.status == "ok" and len(r.out) == 16 for r in reqs)
    out = capsys.readouterr().out
    assert "served 3 requests" in out
    assert "deepseek-reduced-moe-undispatch" in out
