"""Attention and the dense LM in the port against the JAX package on the
CPU.  The same numpy inputs go through both: the port's plain attention
(what the flash kernel's wrapper runs for CPU tensors) against the
reference's ``blockwise_attention``, its Pallas flash kernel in interpret
mode and its O(S^2) oracle; the model primitives; and the reduced
chatglm3 config from the reference's own weights, carried across with
``repro_torch.convert.lm_params_from_reference``.

Tolerances: f32 2e-5 and bf16 5e-2, the reference's own for flash attention
(tests/test_kernels.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import chatglm3_6b as jcfgs
from repro.kernels import ops as jkops, ref as jref
from repro.models import attention as jattn, common as jcommon
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.convert import lm_params_from_reference
from repro_torch.core.embedding_engine import lookup
from repro_torch.kernels import ops as kops, ref as tref
from repro_torch.kernels.agreement import (BF16_MAX_SHARE_DIFFERING,
                                         bf16_agreement, check_bf16)
from repro_torch.kernels.flash_attention import kv_tile
from repro_torch.models import attention as tattn, common as tcommon
from repro_torch.models.lm import LM

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _qkv(seed, b, s, h, hkv, d, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2), (16, 1)])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_plain_attention_matches_blockwise_attention(causal, h, hkv, chunk):
    q, k, v = _qkv(h * chunk, 2, 32, h, hkv, 16)
    got = kops.attention(_t(q), _t(k), _t(v), causal=causal, chunk=chunk)
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    oracle = jref.attention_reference(jnp.asarray(q),
                                      jnp.asarray(np.repeat(k, h // hkv, 2)),
                                      jnp.asarray(np.repeat(v, h // hkv, 2)),
                                      causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32)


def test_plain_attention_bf16_matches_blockwise_attention():
    q, k, v = _qkv(7, 2, 64, 8, 2, 32)
    bf = [_t(a).bfloat16() for a in (q, k, v)]
    got = kops.attention(*bf, causal=True, chunk=16)
    assert got.dtype == torch.bfloat16
    want = jattn.blockwise_attention(
        *[jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in bf],
        causal=True, chunk=16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("bh,s,d,causal", [(2, 256, 64, True),
                                           (3, 128, 128, False)])
def test_plain_attention_matches_the_pallas_flash_kernel(bh, s, d, causal):
    """The reference kernel's (BH, S, D) layout is one head per batch row:
    (BH, S, 1, D) in the port's layout."""
    rng = np.random.default_rng(bh * s)
    q, k, v = [rng.standard_normal((bh, s, d)).astype(np.float32)
               for _ in range(3)]
    got = kops.attention(*[_t(a)[:, :, None, :] for a in (q, k, v)],
                         causal=causal, chunk=64)[:, :, 0, :]
    want = jkops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, block_q=64, block_k=64,
                           interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("s,chunk", [(37, 16), (50, 64), (1, 8)])
def test_plain_attention_masks_a_ragged_last_chunk(s, chunk):
    q, k, v = _qkv(s, 1, s, 4, 2, 16)
    got = kops.attention(_t(q), _t(k), _t(v), causal=True, chunk=chunk)
    want = jref.attention_reference(jnp.asarray(q),
                                    jnp.asarray(np.repeat(k, 2, 2)),
                                    jnp.asarray(np.repeat(v, 2, 2)),
                                    causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_plain_attention_window_and_cross_lengths():
    q, k, v = _qkv(11, 2, 32, 4, 2, 16)
    got = kops.attention(_t(q), _t(k), _t(v), causal=True, window=8,
                         chunk=8)
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True, window=8,
                                     chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    q, k, v = _qkv(12, 2, 16, 4, 2, 16, sk=48)
    got = kops.attention(_t(q), _t(k), _t(v), causal=False, chunk=16)
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=False, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_attention_wrapper_checks_its_arguments():
    q, k, v = (_t(a) for a in _qkv(1, 1, 8, 6, 4, 16))
    with pytest.raises(ValueError, match="GQA"):
        kops.attention(q, k, v)
    q, k, v = (_t(a) for a in _qkv(1, 1, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="contiguous"):
        kops.attention(q.transpose(1, 2), k, v)
    kops.reset_launch_counts()
    kops.attention(q, k, v)
    assert kops.launch_counts()["flash_attention"] == 0   # CPU: plain


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_primitives_match_the_reference(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    gamma = rng.standard_normal(16).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(
        tcommon.rms_norm(tx, _t(gamma).to(tx.dtype)).float().numpy(),
        np.asarray(jcommon.rms_norm(jx, jnp.asarray(gamma).astype(dtype)),
                   np.float32), **tol)
    pos = np.broadcast_to(np.arange(6, dtype=np.float32), (2, 6))
    for pct in (1.0, 0.5):
        tc, ts = tcommon.rope_freqs(_t(pos), 16, 10000.0, pct)
        jc, js = jcommon.rope_freqs(jnp.asarray(pos), 16, 10000.0, pct)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **F32)
        got = tcommon.apply_rope(tx, tc, ts, pct)
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(
            got.float().numpy(),
            np.asarray(jcommon.apply_rope(jx, jc, js, pct), np.float32),
            **tol)
    assert tcommon.pick_chunk(96, 64) == jcommon.pick_chunk(96, 64) == 32
    ids = rng.integers(0, 10, (3, 5))
    table = rng.standard_normal((10, 4)).astype(np.float32)
    assert torch.equal(lookup(_t(table), _t(ids)), _t(table[ids]))


def test_gated_mlp_and_attn_forward_match_the_reference():
    cfg = jcfgs.reduced()
    tcfg = get_reduced("chatglm3-6b")
    key = jax.random.PRNGKey(3)
    p_attn = jattn.init_attn(key, cfg, jnp.float32)
    p_mlp = jcommon.init_mlp(key, cfg.d_model, cfg.d_ff, jnp.float32)
    x = np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(16, dtype=jnp.float32)[None], (2, 16))
    want = jattn.attn_forward(p_attn, jnp.asarray(x), cfg, positions=pos)
    got = tattn.attn_forward({k: _t(np.asarray(v)) for k, v in p_attn.items()},
                             _t(x), tcfg, positions=_t(np.asarray(pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    want = jcommon.gated_mlp(jnp.asarray(x), p_mlp)
    got = tcommon.gated_mlp(_t(x), {k: _t(np.asarray(v))
                                    for k, v in p_mlp.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_cross_attention_on_the_cpu_matches_the_reference():
    """attn_forward(kv=...) runs the plain version on CPU tensors (the
    kernel on the card: tests/test_torch_cuda.py)."""
    cfg = jcfgs.reduced()
    p_attn = jattn.init_attn(jax.random.PRNGKey(5), cfg, jnp.float32)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(16, dtype=jnp.float32)[None], (2, 16))
    want = jattn.attn_forward(p_attn, jnp.asarray(x), cfg, positions=pos,
                              kv=jnp.asarray(kv))
    got = tattn.attn_forward({k: _t(np.asarray(v)) for k, v in p_attn.items()},
                             _t(x), get_reduced("chatglm3-6b"),
                             positions=_t(np.asarray(pos)), kv=_t(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_configs_equal_the_reference():
    assert set(list_archs()) >= {"chatglm3-6b", "deepseek-v2-lite-16b"}
    for name in list_archs():
        from repro.configs import get_config as jget, get_reduced as jred
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jget(name))
        assert dataclasses.asdict(get_reduced(name)) == \
            dataclasses.asdict(jred(name))
    with pytest.raises(KeyError, match="not ported"):
        get_config("xlstm-1.3b")


@pytest.mark.parametrize("seed", [0, 1])
def test_reduced_chatglm3_matches_the_reference(seed):
    """Two layers, d 64, 8 heads over 2 KV heads, fp32, from the reference's
    own weights.  Tolerance 1e-4: fp32 through two layers of matmuls, norms
    and attention whose sums run in another order (observed ~1e-6)."""
    cfg = jcfgs.reduced()
    jlm = JLM(cfg)
    params = jlm.init(jax.random.PRNGKey(seed))
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jlm.forward(params, {"tokens": jnp.asarray(tokens)})
    want_last = jlm.prefill(params, {"tokens": jnp.asarray(tokens)}, None)

    model = LM(get_reduced("chatglm3-6b"), device="cpu")
    state = lm_params_from_reference(
        jax.tree.map(np.asarray, params), cfg, "cpu")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    got = model(_t(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    last = model.prefill(_t(tokens).long())
    assert last.shape == (2, 1, cfg.d_model)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,heads,kv_heads", [("stablelm-3b", 2, 2),
                                                 ("chatglm3-6b", 4, 2)])
def test_head_dim_80_lm_matches_the_reference(arch, heads, kv_heads):
    """stablelm-3b's head dim (80) on a reduced config: d_model 80 x heads,
    partial rotary (stablelm) or GQA (chatglm3), fp32, from the reference's
    own weights; LM.forward runs the flash wrapper's plain version.
    Tolerance 1e-4 as for the reduced chatglm3."""
    from repro.configs import get_reduced as jget_reduced
    over = dict(d_model=80 * heads, num_heads=heads, num_kv_heads=kv_heads,
                d_ff=192)
    cfg = dataclasses.replace(jget_reduced(arch), **over)
    jlm = JLM(cfg)
    params = jlm.init(jax.random.PRNGKey(3))
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want, _ = jlm.forward(params, {"tokens": jnp.asarray(tokens)})
    model = LM(dataclasses.replace(get_reduced(arch), **over), device="cpu")
    assert model.cfg.hd == 80
    model.load_state_dict(lm_params_from_reference(
        jax.tree.map(np.asarray, params), cfg, "cpu"))
    got = model(_t(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strategy", ["take", "one_hot", "pallas"])
def test_lookup_strategies_match_jnp_take(strategy, dtype):
    """Every single-device strategy is the reference's jnp.take (a one-hot
    product has one nonzero term per output, so it is exact too); the
    reference's own strategy agrees as well."""
    from repro.core import embedding_engine as jee
    rng = np.random.default_rng(9)
    table = rng.standard_normal((300, 96)).astype(np.float32)
    ids = rng.integers(0, 300, (3, 7)).astype(np.int32)
    tt = _t(table).to(dtype)
    jt = jnp.asarray(tt.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    got = lookup(tt, _t(ids).long(), strategy=strategy)
    assert got.shape == (3, 7, 96) and got.dtype == dtype
    want = np.asarray(jnp.take(jt, jnp.asarray(ids), axis=0), np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    ref_own = np.asarray(jee.lookup(jt, jnp.asarray(ids), strategy=strategy),
                         np.float32)
    np.testing.assert_array_equal(got.float().numpy(), ref_own)


def test_lookup_refuses_the_sharded_strategies():
    table, ids = torch.zeros((8, 4)), torch.zeros((2,), dtype=torch.int64)
    for strategy in ("masked_psum", "masked_psum_scatter"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            lookup(table, ids, strategy=strategy)
    with pytest.raises(ValueError, match="nope"):
        lookup(table, ids, strategy="nope")


def test_convert_keeps_the_reference_dtype():
    cfg = dataclasses.replace(jcfgs.reduced(), dtype="bfloat16",
                              num_layers=3)
    params = jax.tree.map(np.asarray, JLM(cfg).init(jax.random.PRNGKey(0)))
    state = lm_params_from_reference(params, cfg, "cpu")
    assert all(t.dtype == torch.bfloat16 for t in state.values())
    assert len({k.split(".")[1] for k in state if k.startswith("blocks")}) \
        == 3
    np.testing.assert_array_equal(
        state["blocks.2.attn.wq"].float().numpy(),
        np.asarray(params["scan"][0]["attn"]["wq"][2], np.float32))


def test_full_chatglm3_builds_on_meta_with_the_reference_count():
    cfg = jcfgs.config()
    shapes = jax.eval_shape(JLM(cfg).init, jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    model = LM(get_config("chatglm3-6b"), device="meta")
    assert sum(p.numel() for p in model.parameters()) == want
    assert len(model.blocks) == 28
    assert model.blocks[0].attn["wk"].shape == (4096, 2 * 128)
    assert all(not p.requires_grad for p in model.parameters())


def test_lm_rejects_block_kinds_not_ported():
    cfg = dataclasses.replace(get_reduced("stablelm-3b"),
                              block_pattern=("dense_local", "mlstm"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 5c"):
        LM(cfg, device="meta")


def test_kv_tile_is_each_kernels_tile():
    """bf16 runs the wgmma kernel (kBK = 128 keys, 64 at q/k width 256),
    f32 the scalar kernel (kF32BK = 64); no other dtype or width has a
    flash kernel (112 runs the padded 128 kernel: its tile)."""
    for d in (64, 80, 112, 128, 192):
        assert kv_tile(torch.bfloat16, d) == 128
        assert kv_tile(torch.float32, d) == 64
    assert kv_tile(torch.bfloat16, 256) == kv_tile(torch.float32, 256) == 64
    with pytest.raises(ValueError, match="no flash kernel"):
        kv_tile(torch.float16, 128)
    with pytest.raises(ValueError, match="no flash kernel at q/k width"):
        kv_tile(torch.bfloat16, 96)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(256, 256), (128, 384)])
def test_plain_attention_at_the_kernel_tile_matches_blockwise_attention(
        dtype, causal, sq, sk):
    """The plain version at the chunk the card's checks give it (the
    kernel's own KV tile) is the reference's blockwise_attention at that
    chunk (which takes whole chunks only): f32, 2e-5."""
    tile = kv_tile(dtype, 64)
    q, k, v = _qkv(tile + sq, 2, sq, 8, 2, 64, sk=sk)
    got = kops.attention(_t(q), _t(k), _t(v), causal=causal, chunk=tile)
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     chunk=tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_bf16_agreement_holds_for_the_pallas_flash_kernel():
    """The check a bf16 kernel is held to on the card
    (``kernels.agreement.check_bf16``) passes the reference's own Pallas
    kernel (interpret mode, KV blocks of the bf16 kernel's tile) against the
    plain version over chunks of that tile: the same recurrence, another
    order of fp32 sums."""
    rng = np.random.default_rng(5)
    tile = kv_tile(torch.bfloat16, 64)
    q, k, v = [jnp.asarray(rng.standard_normal((4, 256, 64)),
                           jnp.bfloat16) for _ in range(3)]
    want = jkops.attention(q, k, v, causal=True, block_q=64, block_k=tile,
                           interpret=True)
    got = kops.attention(*[_t(a.astype(jnp.float32)).bfloat16()[:, :, None]
                           for a in (q, k, v)], causal=True,
                         chunk=tile)[:, :, 0]
    a = check_bf16(got, _t(want.astype(jnp.float32)).bfloat16(), "pallas")
    assert a["share_differing"] < BF16_MAX_SHARE_DIFFERING


def _long_bf16_qkv():
    """One causal head group at chatglm3's prefill length, in bf16."""
    return [_t(a).bfloat16() for a in _qkv(9, 1, 4096, 2, 1, 64)]


def test_bf16_agreement_rejects_p_left_unrounded():
    """A kernel that skips rounding p to bf16 before PV (made here with v
    kept in fp32) moves every element by less than one bf16 step, so an
    elementwise tolerance passes it; it changes a large share of them, and
    check_bf16 rejects it."""
    q, k, v = _long_bf16_qkv()
    tile = kv_tile(torch.bfloat16, 64)
    want = tref.attention(q, k, v, causal=True, chunk=tile)
    bad = tref.attention(q, k, v.float(), causal=True, chunk=tile)
    assert bad.dtype == torch.bfloat16
    a = bf16_agreement(bad, want)
    assert a["worst"] <= 1 and a["share_differing"] > 0.1
    with pytest.raises(AssertionError, match="differ"):
        check_bf16(bad, want, "p not rounded")


def test_bf16_agreement_rejects_a_dropped_key_tile():
    """A kernel that skips the first key tile (the bf16 kernel's 128 keys)
    for the rows past the middle of a 4096-token prefill fails
    check_bf16."""
    q, k, v = _long_bf16_qkv()
    t, cut = kv_tile(torch.bfloat16, 64), 2048
    want = tref.attention(q, k, v, causal=True, chunk=t)
    bad = want.clone()
    # rows i >= cut attend to keys t..i only
    bad[:, cut:] = tref.attention(q[:, t:], k[:, t:], v[:, t:], causal=True,
                                  chunk=t)[:, cut - t:]
    with pytest.raises(AssertionError, match="differ"):
        check_bf16(bad, want, "key tile dropped")


# ---------------------------------------------------------------------------
# The MoE kinds: deepseek-v2-lite-16b (mla) and qwen3-moe-235b-a22b (moe)
# ---------------------------------------------------------------------------

MOE_ARCHS = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]


def _moe_lm_pair(arch, seed):
    from repro.configs import get_reduced as jget_reduced
    jcfg = jget_reduced(arch)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(seed))
    model = LM(get_reduced(arch), device="cpu")
    state = lm_params_from_reference(jax.tree.map(np.asarray, params), jcfg,
                                     "cpu")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return jlm, params, model


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("seed", [0, 1])
def test_reduced_moe_lm_matches_the_reference(arch, seed):
    """Two MoE layers (MLA + shared experts, or GQA + routed experts), fp32,
    from the reference's own weights: hidden states, the last position
    (prefill) and the summed aux loss at 2e-5 (fp32 sums in another order;
    observed ~1e-5 on the hidden states)."""
    jlm, params, model = _moe_lm_pair(arch, seed)
    tokens = np.random.default_rng(seed).integers(
        0, model.cfg.vocab_size, (2, 24)).astype(np.int32)
    want, waux = jlm.forward(params, {"tokens": jnp.asarray(tokens)})
    got, aux = model(_t(tokens).long(), with_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(float(aux), float(waux), **F32)
    assert torch.equal(model(_t(tokens).long()), got)
    last = model.prefill(_t(tokens).long())
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1:], **F32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_step_with_active_mask_matches_the_reference(arch):
    """Masked decode micro-steps (inactive slots feed token 0, which still
    takes expert capacity): logits and every cache leaf (MLA's latent
    ``c`` / ``kr``, or GQA's K/V, through ``caches_to_reference``) at
    2e-5, ``len`` exactly."""
    from repro_torch.convert import caches_to_reference
    jlm, params, model = _moe_lm_pair(arch, 2)
    rng = np.random.default_rng(2)
    b = 3
    jc, tc = jlm.init_caches(b, 12), model.init_caches(b, 12)
    step = jax.jit(jlm.decode_step)
    for t in range(5):
        toks = rng.integers(0, model.cfg.vocab_size, (b, 1)).astype(np.int32)
        active = np.array([True, t % 2 == 0, t < 3])
        wl, jc = step(params, jnp.asarray(toks), jc, None,
                      jnp.asarray(active))
        gl, tc = model.decode_step(_t(toks).long(), tc,
                                   active=torch.from_numpy(active))
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **F32)
        ref = caches_to_reference(tc, model.cfg)
        for w, g in zip(jax.tree.leaves(jc), jax.tree.leaves(ref)):
            if np.asarray(w).dtype.kind in "iu":
                np.testing.assert_array_equal(g, np.asarray(w))
            else:
                np.testing.assert_allclose(g, np.asarray(w), **F32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_wave_step_of_a_ragged_batch_matches_the_reference(arch):
    """Ragged prefill and decode waves (a slot idle, slots of different
    lengths), each followed by a slot reset: logits and every cache leaf
    at 2e-5."""
    from repro_torch.convert import caches_to_reference
    jlm, params, model = _moe_lm_pair(arch, 3)
    rng = np.random.default_rng(3)
    b = 4
    jc, tc = jlm.init_caches(b, 16), model.init_caches(b, 16)
    wave, reset = jax.jit(jlm.wave_step), jax.jit(jlm.reset_slots)
    for lens, keep in (([5, 2, 0, 3], [True, True, True, False]),
                       ([1, 1, 1, 1], [False, True, True, True]),
                       ([3, 0, 1, 2], [True, True, True, True])):
        lens = np.array(lens, np.int32)
        toks = rng.integers(0, model.cfg.vocab_size,
                            (b, lens.max())).astype(np.int32)
        wl, jc = wave(params, jnp.asarray(toks), jnp.asarray(lens), jc)
        gl, tc = model.wave_step(toks, lens, tc)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **F32)
        jc = reset(jc, jnp.asarray(keep))
        tc = model.reset_slots(tc, np.array(keep))
        ref = caches_to_reference(tc, model.cfg)
        for w, g in zip(jax.tree.leaves(jc), jax.tree.leaves(ref)):
            np.testing.assert_allclose(g, np.asarray(w), **F32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_moe_model_builds_on_meta_with_the_reference_count(arch):
    """The full config's parameter count equals the reference's (16B for
    DeepSeek-V2-Lite, 235B for qwen3-moe), built without memory."""
    from repro.configs import get_config as jget_config
    shapes = jax.eval_shape(JLM(jget_config(arch)).init,
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    model = LM(get_config(arch), device="meta")
    assert sum(p.numel() for p in model.parameters()) == want
    cfg = model.cfg
    moe = model.blocks[0].moe
    assert moe["router"].dtype == torch.float32
    assert moe["wi_gate"].shape == (cfg.num_experts, cfg.d_model,
                                    cfg.moe_d_ff)
    assert ("shared" in moe) == bool(cfg.num_shared_experts)
    if arch == "deepseek-v2-lite-16b":
        assert 15.5e9 < want < 16.5e9
        assert model.blocks[0].attn["wq"].shape == (2048, 16 * 192)


# ---------------------------------------------------------------------------
# The sliding window (dense_local) and the vision-stub front end:
# gemma3-4b, h2o-danube-1.8b, llava-next-34b
# ---------------------------------------------------------------------------

WINDOW_ARCHS = ["gemma3-4b", "h2o-danube-1.8b", "llava-next-34b"]


@pytest.mark.parametrize("d", [16, 64, 256])
@pytest.mark.parametrize("window", [1, 3, 8, 40])
@pytest.mark.parametrize("chunk", [8, 16])
def test_plain_windowed_attention_matches_the_banded_reference(d, window,
                                                               chunk):
    """The plain version with a window (what the wrapper runs on the CPU)
    against the reference's banded blockwise_attention, which visits only
    the KV chunks of the band, and its O(S^2) dense_attention, causal, at
    head dims 16, 64 and 256 and windows of 1, 3, 8 and more than S:
    f32, 2e-5."""
    q, k, v = _qkv(d + window + chunk, 2, 32, 4, 2, d)
    got = kops.attention(_t(q), _t(k), _t(v), causal=True, window=window,
                         chunk=chunk)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    banded = jattn.blockwise_attention(jq, jk, jv, causal=True,
                                       window=window, chunk=chunk,
                                       banded=True)
    dense = jattn.dense_attention(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(banded), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), **F32)
    if window >= 32:
        np.testing.assert_array_equal(
            got.numpy(), kops.attention(_t(q), _t(k), _t(v), causal=True,
                                        chunk=chunk).numpy())


def _window_pair(arch, seed):
    from repro.configs import get_reduced as jget_reduced
    jcfg = jget_reduced(arch)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(seed))
    model = LM(get_reduced(arch), device="cpu")
    state = lm_params_from_reference(jax.tree.map(np.asarray, params), jcfg,
                                     "cpu")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return jlm, params, model


@pytest.mark.parametrize("arch", WINDOW_ARCHS)
@pytest.mark.parametrize("seed", [0, 1])
def test_reduced_window_and_vision_lms_match_the_reference(arch, seed):
    """The reduced gemma3 (super-blocks of five dense_local layers and a
    dense one, then two dense_local, window 8), danube (two dense_local)
    and llava (two dense layers, with 5 frontend_embeds rows spliced over
    the first positions) from the reference's own weights, over 24 tokens:
    hidden states and the prefill's last position at 1e-4, as the reduced
    chatglm3."""
    jlm, params, model = _window_pair(arch, seed)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, model.cfg.vocab_size, (2, 24)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    fe = None
    if model.cfg.modality == "vision-stub":
        fe = rng.standard_normal((2, 5, model.cfg.d_model)).astype(
            np.float32)
        batch["frontend_embeds"] = jnp.asarray(fe)
        fe = _t(fe)
        assert torch.equal(model.frontend_proj, torch.eye(model.cfg.d_model))
    want, _ = jlm.forward(params, batch)
    got = model(_t(tokens).long(), fe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    last = model.prefill(_t(tokens).long(), fe)
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1:],
                               rtol=1e-4, atol=1e-4)
    if fe is not None:       # the splice changed the output
        assert not np.allclose(model(_t(tokens).long()).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_frontend_embeds_splice_checks_its_input():
    model = LM(get_reduced("llava-next-34b"), device="cpu", seed=0)
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="do not splice"):
        model(tokens, torch.zeros((1, 5, model.cfg.d_model)))
    with pytest.raises(ValueError, match="do not splice"):
        model(tokens, torch.zeros((1, 2, model.cfg.d_model),
                                  dtype=torch.float64))
    text = LM(get_reduced("gemma3-4b"), device="cpu", seed=0)
    assert not hasattr(text, "frontend_proj")
    assert torch.equal(text(tokens, torch.ones((1, 2, text.cfg.d_model))),
                       text(tokens))


@pytest.mark.parametrize("arch", WINDOW_ARCHS)
def test_full_window_and_vision_models_build_on_meta_with_the_reference_count(
        arch):
    """gemma3-4b (3.88B: 29 dense_local and 5 dense layers of head dim
    256), h2o-danube-1.8b (1.75B) and llava-next-34b (33.98B, with its
    frontend_proj) hold the reference's parameter count, built without
    memory."""
    from repro.configs import get_config as jget_config
    shapes = jax.eval_shape(JLM(jget_config(arch)).init,
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    model = LM(get_config(arch), device="meta")
    assert sum(p.numel() for p in model.parameters()) == want
    kinds = [type(b).__name__ for b in model.blocks]
    if arch == "gemma3-4b":
        assert kinds.count("LocalBlock") == 29 and \
            kinds.count("DenseBlock") == 5
        assert model.blocks[0].attn["wq"].shape == (2560, 8 * 256)
    assert hasattr(model, "frontend_proj") == (arch == "llava-next-34b")
