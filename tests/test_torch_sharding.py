"""The port's sharding rules (``repro_torch.launch.sharding``) against the
JAX package's (``repro.launch.sharding``).

The reference's specs come from ``jax.eval_shape`` of its LM (no mesh, no
devices); its stacked ``scan`` leaves lose their leading None, and its
(B, S, Hkv, hd) K/V cache specs are read in the port's head-major (B, Hkv,
S, hd) layout.  The spec contracts of ``tests/test_launch.py``
(``test_param_specs_structure``, ``test_sanitize_drops_nondivisible``) are
held on the port's names, and :func:`local_shard` /
:func:`concat_shards` on numbers."""
from __future__ import annotations

import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced, list_archs
from repro.launch import sharding as jshd
from repro.models import LM as JLM
from repro_torch.configs import get_reduced
from repro_torch.launch import sharding as shd
from repro_torch.models.lm import LM, layer_kinds

ARCHS = tuple(list_archs())


def _ref_layers(tree, cfg) -> list:
    """The reference's ``{"scan", "rest"}`` tree of specs (or shapes) as
    one entry per layer, the stacked leading dim dropped."""
    def drop(t):
        if isinstance(t, dict):
            return {k: drop(v) for k, v in t.items()}
        return None if t is None else tuple(t)[1:]

    pattern = tuple(cfg.block_pattern)
    layers = [drop(tree["scan"][i]) for _ in range(cfg.n_super)
              for i in range(len(pattern))]
    return layers + [
        {k: (tuple(v) if not isinstance(v, dict) else v)
         for k, v in r.items()} for r in tree.get("rest", ())]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        elif v is not None:
            yield f"{prefix}{k}", tuple(v)


def _ref_param_specs(arch) -> dict:
    """The reference's param specs under the port's ``state_dict`` names."""
    cfg = jget_reduced(arch)
    shapes = jax.eval_shape(JLM(cfg).init, jax.random.PRNGKey(0))
    specs = jshd.param_specs(shapes)
    out = {"embed": tuple(specs["embed"]),
           "final_norm": tuple(specs["final_norm"])}
    for key in ("frontend_proj", "enc_norm"):
        if key in specs:
            out[key] = tuple(specs[key])
    if "shared" in specs:
        out.update((f"shared.{k}", v) for k, v in _flat(specs["shared"]))
    for li, layer in enumerate(_ref_layers(specs, cfg)):
        out.update((f"blocks.{li}.{k}", v) for k, v in _flat(layer))
    if "enc_scan" in specs:
        enc = {k: v for k, v in _flat(specs["enc_scan"])}
        for li in range(cfg.enc_layers):
            out.update((f"enc_blocks.{li}.{k}", v[1:])
                       for k, v in enc.items())
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch):
    lm = LM(get_reduced(arch), device="meta")
    got = shd.param_specs(lm)
    want = _ref_param_specs(arch)
    assert set(got) == set(want)
    for name, spec in got.items():
        assert spec == want[name], name
        assert len(spec) == lm.state_dict()[name].dim()


def test_param_specs_structure():
    """``tests/test_launch.py::test_param_specs_structure`` on the port's
    (unstacked) names."""
    specs = shd.param_specs(LM(get_reduced("qwen3-moe-235b-a22b"),
                               device="meta"))
    assert specs["embed"] == ("model", None)
    assert specs["blocks.0.moe.wi_gate"] == ("model", None, None)
    assert all(s is None for s in specs["blocks.0.moe.router"])
    assert specs["blocks.0.attn.wq"][-1] == "model"
    assert specs["blocks.0.attn.wo"][0] == "model"


@pytest.mark.parametrize("size,kept", [(1, True), (2, True), (3, True),
                                       (4, False), (8, False)])
def test_sanitize_drops_nondivisible(size, kept):
    """``tests/test_launch.py::test_sanitize_drops_nondivisible``, and the
    axis sizes that do not divide 6 (or exceed it) dropped, as the
    reference drops them."""
    specs = {"a": ("model", None), "b": [{"c": (("data", "model"),)}]}
    tree = {"a": torch.empty((6, 4)), "b": [{"c": torch.empty(6)}]}
    mesh = {"data": 1, "model": size}
    out = shd.sanitize_specs(specs, tree, mesh)
    assert out["a"] == (("model" if kept else None), None)
    assert out["b"][0]["c"] == ((("data", "model") if kept else None),)
    want = jshd.sanitize_specs(
        {"a": jax.sharding.PartitionSpec("model", None)},
        {"a": jax.ShapeDtypeStruct((6, 4), np.float32)},
        types.SimpleNamespace(shape=mesh))
    assert tuple(want["a"]) == out["a"]


def _head_major(spec: tuple, name: str) -> tuple:
    return (spec[0], spec[2], spec[1], spec[3]) if name in ("k", "v") \
        else spec


def _canon(spec: tuple) -> tuple:
    """A spec with one-axis tuples written as the axis (``PartitionSpec``
    stores ``("data",)`` as ``"data"``)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


@pytest.mark.parametrize("model", [2, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_references(arch, model):
    """Every leaf of every layer's cache, the K/V specs in the port's
    head-major layout; a 3-wide model axis takes the head-dim split of a
    few-KV-head model, as the reference does."""
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    mesh = {"data": 1, "model": model}
    ref_caches = jax.eval_shape(lambda: JLM(jcfg).init_caches(4, 12))
    want = jshd.cache_specs(ref_caches, 4, types.SimpleNamespace(shape=mesh),
                            ("data",))
    caches = LM(cfg, device="cpu").init_caches(4, 12)
    got = shd.cache_specs(caches, 4, mesh, ("data",))
    layers = _ref_layers(want, jcfg)
    assert len(layers) == len(got) == len(layer_kinds(cfg))
    for li, (g, w) in enumerate(zip(got, layers)):
        w = w.get("self", w)
        assert set(g) == {k for k, v in w.items() if v is not None}, li
        for name, spec in g.items():
            assert _canon(spec) == _head_major(tuple(w[name]), name), \
                (li, name)


def test_batch_specs_split_the_batch_over_the_data_axes():
    struct = {"tokens": torch.empty((8, 16)), "emb": torch.empty((8, 4, 2))}
    mesh = {"data": 2, "model": 2}
    got = shd.batch_specs(struct, 8, mesh, ("data",))
    assert got == {"tokens": (("data",), None),
                   "emb": (("data",), None, None)}
    assert shd.batch_specs(struct, 1, mesh, ("data",))["tokens"] == \
        (None, None)


@pytest.mark.parametrize("spec", [("model", None), (None, "model"),
                                  (None, None), (("data", "model"), None)])
def test_local_shards_join_back(spec):
    mesh = {"data": 2, "model": 2}
    t = torch.arange(8 * 6).reshape(8, 6)
    shards = {(d, m): shd.local_shard(t, spec, mesh, {"data": d, "model": m})
              for d in range(2) for m in range(2)}
    if spec == (("data", "model"), None):
        # one dim split over both axes jointly, row-major
        assert torch.equal(torch.cat([shards[(0, 0)], shards[(0, 1)],
                                      shards[(1, 0)], shards[(1, 1)]]), t)
        return
    joined = shd.concat_shards([shards[(0, 0)], shards[(0, 1)]], spec)
    assert torch.equal(joined, t)


def test_local_shard_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="split evenly"):
        shd.local_shard(torch.zeros(6, 4), ("model", None), {"model": 4},
                        {"model": 0})


@pytest.mark.parametrize("strategy", ["masked_psum", "masked_psum_scatter"])
def test_lookup_on_a_one_wide_vocab_axis_is_take(strategy):
    """A 1-wide vocab axis holds every row on one shard: the sharded
    strategies are the single device's ``take`` (no collective)."""
    from repro_torch.core.embedding_engine import lookup
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 1))
    table = torch.arange(24.0).reshape(6, 4)
    ids = torch.tensor([[5, 0, 3]])
    got = lookup(table, ids, mesh=mesh, vocab_axis="model",
                 strategy=strategy)
    assert torch.equal(got, table[ids])


@pytest.mark.parametrize("vocab,sharded", [(512, False), (512, True),
                                           (1024, True), (65024, True)])
def test_choose_strategy_is_the_references(vocab, sharded):
    from repro.core import embedding_engine as jee
    from repro_torch.core.embedding_engine import choose_strategy
    assert choose_strategy(vocab, sharded) == \
        jee.choose_strategy(vocab, sharded)
