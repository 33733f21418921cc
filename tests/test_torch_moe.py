"""The port's MoE layer and DeepSeek's multi-head latent attention against
the JAX package on the CPU.  The same numpy inputs and the reference's own
weights (``init_moe`` / ``init_mla`` from a fixed key, carried across as
numpy) go through both.

Tolerances, stated per check:
* routing decisions (top-k expert ids, capacity slots, keep) exactly
  equal: ids and slots are integers, and the fixed seeds here give no
  near-tie of router probabilities (a near-tie would show as a failure
  here, not be hidden);
* outputs and the aux loss 2e-5 (fp32 products and sums in another order;
  the reference's own fp32 tolerance for attention, tests/test_kernels.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import types

import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import attention as jattn, moe as jmoe
from repro_torch.configs import get_reduced
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as tattn, moe as tmoe

F32 = dict(rtol=2e-5, atol=2e-5)
ARCHS = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]


def _torch_tree(tree):
    """A reference parameter tree as the same tree of CPU tensors."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _moe_pair(arch, seed, **over):
    jcfg = dataclasses.replace(jget_reduced(arch), **over)
    tcfg = dataclasses.replace(get_reduced(arch), **over)
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, tcfg, p, _torch_tree(jax.tree.map(np.asarray, p))


# ---------------------------------------------------------------------------
# Capacity slotting
# ---------------------------------------------------------------------------

def _expert_ids(case, rng, n, e):
    if case == "uniform":
        return rng.integers(0, e, n)
    if case == "overflow":      # half the assignments to expert 3
        ids = rng.integers(0, e, n)
        ids[rng.permutation(n)[:n // 2]] = 3
        return ids
    if case == "all_equal":
        return np.full(n, e - 1)
    if case == "one_missing":   # expert 0 gets none
        return rng.integers(1, e, n)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["uniform", "overflow", "all_equal",
                                  "one_missing"])
@pytest.mark.parametrize("n,e,cap", [(48, 8, 7), (16, 4, 1), (200, 64, 4)])
def test_slot_assignments_equal_the_reference(case, n, e, cap):
    """Identical expert ids: slots and keep exactly equal, every kept slot
    distinct and inside its expert's range, and as many kept as fit."""
    ids = _expert_ids(case, np.random.default_rng(n + e + cap), n, e)
    ws, wk = jmoe._slot_assignments(jnp.asarray(ids, jnp.int32), e, cap)
    gs, gk = tmoe._slot_assignments(torch.from_numpy(ids), e, cap)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    kept = gs[gk].numpy()
    assert len(set(kept.tolist())) == len(kept)
    assert np.all(kept // cap == ids[gk.numpy()])
    assert int(gk.sum()) == sum(min(int((ids == x).sum()), cap)
                                for x in range(e))
    if case in ("overflow", "all_equal"):
        assert not bool(gk.all())


def test_capacity_is_the_references():
    for arch in ARCHS:
        cfg = get_reduced(arch)
        for t in (1, 8, 24, 16384):
            want = jmoe.dispatch_op(jget_reduced(arch), t).num_embeddings
            assert cfg.num_experts * tmoe.capacity_of(cfg, t) == want
    full = dataclasses.replace(get_reduced(ARCHS[0]), num_experts=64,
                               experts_per_tok=6)
    assert tmoe.capacity_of(full, 8) == 1          # a served wave
    assert tmoe.capacity_of(full, 4 * 4096) == 1921   # a 4 x 4096 prefill


# ---------------------------------------------------------------------------
# moe_ffn_local
# ---------------------------------------------------------------------------

def _x(seed, t, d):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(
        np.float32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routing_equals_the_reference(arch, seed):
    """The same router logits (x @ router from the same numpy arrays): the
    top-k expert ids, their weights (2e-5) and the capacity slots of both
    frameworks."""
    jcfg, cfg, jp, tp = _moe_pair(arch, seed)
    x = _x(seed, 24, cfg.d_model)
    logits = np.array(jnp.asarray(x) @ jp["router"])
    probs_j = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    probs_t = torch.softmax(torch.from_numpy(logits), dim=-1)
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), **F32)
    k = cfg.experts_per_tok
    wj, ej = jax.lax.top_k(probs_j, k)
    wt, et = torch.topk(probs_t, k, dim=-1)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **F32)
    cap = tmoe.capacity_of(cfg, 24)
    ws, wk = jmoe._slot_assignments(ej.reshape(-1), cfg.num_experts, cap)
    gs, gk = tmoe._slot_assignments(et.reshape(-1), cfg.num_experts, cap)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("t,capacity_factor", [(24, 1.25), (7, 1.25),
                                               (40, 0.5)])
def test_moe_ffn_local_matches_the_reference(arch, t, capacity_factor):
    """out and aux at 2e-5; at capacity_factor 0.5 assignments are dropped
    (the where(keep) path).  The un-dispatch runs through the block
    gather's plain version here (no kernel launch on CPU tensors)."""
    jcfg, cfg, jp, tp = _moe_pair(arch, t, capacity_factor=capacity_factor)
    x = _x(t + 1, t, cfg.d_model)
    want, waux = jmoe.moe_ffn_local(jp, jnp.asarray(x), jcfg)
    kops.reset_launch_counts()
    got, aux = tmoe.moe_ffn_local(tp, torch.from_numpy(x), cfg)
    assert kops.launch_counts()["block_gather"] == 0
    assert got.shape == (t, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(float(aux), float(waux), **F32)
    if capacity_factor < 1:
        probs = torch.softmax(torch.from_numpy(x) @ tp["router"], -1)
        _, tope = torch.topk(probs, cfg.experts_per_tok, dim=-1)
        _, keep = tmoe._slot_assignments(tope.reshape(-1), cfg.num_experts,
                                         tmoe.capacity_of(cfg, t))
        assert not bool(keep.all())


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_the_reference_and_refuses_a_mesh(arch):
    jcfg, cfg, jp, tp = _moe_pair(arch, 5)
    x = np.random.default_rng(5).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    want, waux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(float(aux), float(waux), **F32)
    # a mesh whose model axis the experts do not split over is refused
    # before any collective (expert parallelism itself:
    # tests/test_torch_tensor_parallel.py)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(1, 3))
    with pytest.raises(ValueError, match="do not split"):
        tmoe.moe_ffn(tp, torch.from_numpy(x), cfg, mesh=mesh)


def test_undispatch_program_is_the_references():
    for arch in ARCHS:
        for t in (8, 24):
            want = jmoe.undispatch_program(jget_reduced(arch), t)
            got = tmoe.undispatch_program(get_reduced(arch), t)
            assert got.name == want.name
            assert repr(got.signature()) == repr(want.signature())


def test_init_moe_has_the_references_tree():
    for arch in ARCHS:
        cfg = get_reduced(arch)
        want = jax.eval_shape(lambda k: jmoe.init_moe(
            k, jget_reduced(arch), jnp.float32), jax.random.PRNGKey(0))
        got = tmoe.init_moe(torch.Generator().manual_seed(0), cfg,
                            torch.float32)
        flat_w = {jax.tree_util.keystr(p): a.shape for p, a in
                  jax.tree_util.tree_flatten_with_path(want)[0]}
        flat_g = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
                  jax.tree_util.tree_flatten_with_path(got)[0]}
        assert flat_g == flat_w
        assert got["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_pair(seed, **over):
    arch = "deepseek-v2-lite-16b"
    jcfg = dataclasses.replace(jget_reduced(arch), **over)
    cfg = dataclasses.replace(get_reduced(arch), **over)
    p = jattn.init_mla(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, cfg, p, _torch_tree(jax.tree.map(np.asarray, p))


@pytest.mark.parametrize("s", [16, 12, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_mla_forward_matches_the_reference(s, seed):
    """q/k width hd + rd (16 + 8 here) over v width hd (16): the flash
    wrapper's plain version at (24, 16) against the reference's
    blockwise_attention inside mla_forward, 2e-5."""
    jcfg, cfg, jp, tp = _mla_pair(seed)
    x = np.random.default_rng(seed).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.float32)[None], (2, s))
    want = jattn.mla_forward(jp, jnp.asarray(x), jcfg,
                             positions=jnp.asarray(pos))
    got = tattn.mla_forward(tp, torch.from_numpy(x), cfg,
                            positions=torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_plain_attention_with_a_narrower_value_matches_the_reference():
    """The flash wrapper's plain version at q/k width 192 and v width 128
    (DeepSeek-V2-Lite's MLA prefill) against blockwise_attention, f32,
    2e-5."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 64, 4, 192)).astype(np.float32)
    k = rng.standard_normal((1, 64, 4, 192)).astype(np.float32)
    v = rng.standard_normal((1, 64, 4, 128)).astype(np.float32)
    got = kops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                         causal=True, chunk=16)
    want = jattn.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     causal=True, chunk=16)
    assert got.shape == (1, 64, 4, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _mla_cache_leaves(cache):
    return {k: (v.float().numpy() if v.is_floating_point() else v.numpy())
            for k, v in cache.items()}


@pytest.mark.parametrize("masked", [False, True])
def test_mla_decode_matches_the_reference(masked):
    """Five decode steps on 3 slots at staggered lengths: the output at
    2e-5 and every cache leaf (``c``, ``kr`` at 2e-5, ``len`` exactly);
    with a mask, inactive slots keep their rows and length, as the
    reference's where(active, new, old) over the cache."""
    jcfg, cfg, jp, tp = _mla_pair(3)
    b, smax = 3, 8
    jc = jattn.init_mla_cache(jcfg, b, smax, jnp.float32)
    jc["len"] = jnp.asarray([0, 2, 5], jnp.int32)
    tc = tattn.init_mla_cache(cfg, b, smax, torch.float32)
    tc["len"] = torch.tensor([0, 2, 5], dtype=torch.int32)
    rng = np.random.default_rng(3)
    for t in range(5):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        active = np.array([True, t % 2 == 0, t != 1])
        want, new = jattn.mla_decode(jp, jnp.asarray(x), jcfg, jc)
        if masked:
            keep = jnp.asarray(active)
            jc = jax.tree.map(lambda o, n: jnp.where(
                keep.reshape((b,) + (1,) * (n.ndim - 1)), n, o), jc, new)
        else:
            jc = new
        got = tattn.mla_decode(
            tp, torch.from_numpy(x), cfg, tc,
            active=torch.from_numpy(active) if masked else None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        leaves = _mla_cache_leaves(tc)
        np.testing.assert_array_equal(leaves["len"], np.asarray(jc["len"]))
        for key in ("c", "kr"):
            np.testing.assert_allclose(leaves[key], np.asarray(jc[key]),
                                       **F32)


def test_mla_decode_clamps_a_full_cache_row_as_the_reference():
    """A slot at the cache's end writes its last row (the reference's
    dynamic_update_slice clamps the start)."""
    jcfg, cfg, jp, tp = _mla_pair(4)
    b, smax = 2, 4
    jc = jattn.init_mla_cache(jcfg, b, smax, jnp.float32)
    jc["len"] = jnp.asarray([4, 1], jnp.int32)
    tc = tattn.init_mla_cache(cfg, b, smax, torch.float32)
    tc["len"] = torch.tensor([4, 1], dtype=torch.int32)
    x = np.random.default_rng(4).standard_normal(
        (b, 1, cfg.d_model)).astype(np.float32)
    want, jc = jattn.mla_decode(jp, jnp.asarray(x), jcfg, jc)
    got = tattn.mla_decode(tp, torch.from_numpy(x), cfg, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for key in ("c", "kr"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **F32)
