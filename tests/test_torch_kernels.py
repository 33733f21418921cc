"""The port's kernel entry points on CPU tensors (their plain PyTorch
versions) against the reference's Pallas kernels in interpret mode, over the
sweep of tests/test_kernels.py plus empty max/min segments, seg_base, E=5,
(x)=add weights, capacity-padded idxs and fused-gather roff.  The same numpy
inputs, made from a seed, go to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.sls import max_lookups_of
from repro_torch.kernels import ops as tops

RNG = np.random.default_rng(7)
TOL_F32 = dict(rtol=2e-5, atol=2e-5)
TOL_BF16 = dict(rtol=5e-2, atol=5e-2)


def _csr(b, n, avg, with_empty=True, pad=0):
    lens = RNG.poisson(avg, b)
    if with_empty and b > 1:
        lens[0] = 0
    ptrs = np.zeros(b + 1, np.int32)
    np.cumsum(lens, out=ptrs[1:])
    idxs = np.zeros(int(ptrs[-1]) + pad, np.int32)
    idxs[:int(ptrs[-1])] = RNG.integers(0, n, int(ptrs[-1]))
    return ptrs, idxs


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _both_sls(table, ptrs, idxs, w=None, seg_base=None, **kw):
    """(port on CPU tensors, reference in interpret mode) on one input."""
    b = len(ptrs) - 1
    got = tops.sls(_t(table), _t(ptrs), _t(idxs), _t(w), num_segments=b,
                   seg_base=_t(seg_base), **kw)
    want = jops.sls(jnp.asarray(table), jnp.asarray(ptrs), jnp.asarray(idxs),
                    None if w is None else jnp.asarray(w), num_segments=b,
                    max_lookups=max_lookups_of(ptrs), interpret=True,
                    seg_base=None if seg_base is None
                    else jnp.asarray(seg_base), **kw)
    return got, np.asarray(want)


@pytest.mark.parametrize("b,n,e", [(6, 13, 10), (4, 9, 200), (3, 40, 33),
                                   (8, 64, 128), (1, 5, 1)])
@pytest.mark.parametrize("weighted", [False, True])
def test_sls_shapes(b, n, e, weighted):
    ptrs, idxs = _csr(b, n, 4)
    table = RNG.standard_normal((n, e)).astype(np.float32)
    w = RNG.standard_normal(len(idxs)).astype(np.float32) if weighted \
        else None
    got, want = _both_sls(table, ptrs, idxs, w)
    assert got.dtype == torch.float32 and got.shape == (b, e)
    np.testing.assert_allclose(got.numpy(), want, **TOL_F32)


@pytest.mark.parametrize("add_op", ["add", "max", "min"])
@pytest.mark.parametrize("mul_op", ["mul", "add"])
def test_sls_semirings(add_op, mul_op):
    """Every (+)/(x) pair, weighted, with empty segments (-> 0, not +-inf)."""
    b, n, e = 5, 11, 36
    ptrs, idxs = _csr(b, n, 3)
    table = RNG.standard_normal((n, e)).astype(np.float32)
    w = RNG.standard_normal(len(idxs)).astype(np.float32)
    got, want = _both_sls(table, ptrs, idxs, w, add_op=add_op, mul_op=mul_op)
    np.testing.assert_allclose(got.numpy(), want, **TOL_F32)
    empty = np.diff(ptrs) == 0
    assert empty.sum() >= 1 and (got.numpy()[empty] == 0).all()


def test_sls_bf16():
    b, n, e = 4, 16, 130
    ptrs, idxs = _csr(b, n, 3)
    table = (RNG.standard_normal((n, e)) * 0.5).astype(np.float32)
    got = tops.sls(_t(table).to(torch.bfloat16), _t(ptrs), _t(idxs),
                   num_segments=b)
    want = jops.sls(jnp.asarray(table, jnp.bfloat16), jnp.asarray(ptrs),
                    jnp.asarray(idxs), None, num_segments=b,
                    max_lookups=max_lookups_of(ptrs), interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL_BF16)


@pytest.mark.parametrize("add_op", ["add", "max"])
def test_sls_seg_base_e5_padded(add_op):
    """The fused multi-table form: per-segment seg_base into a stacked
    table, E=5 (no 16-byte vectors), idxs padded past ptrs[-1]."""
    b, n, e = 7, 30, 5
    ptrs, idxs = _csr(b, n // 2, 3, pad=5)
    seg_base = RNG.integers(0, n // 2, b).astype(np.int32)
    table = RNG.standard_normal((n, e)).astype(np.float32)
    got, want = _both_sls(table, ptrs, idxs, seg_base=seg_base,
                          add_op=add_op)
    np.testing.assert_allclose(got.numpy(), want, **TOL_F32)


def test_sls_all_empty_batch():
    ptrs = np.zeros(4, np.int32)
    idxs = np.zeros(0, np.int32)
    table = RNG.standard_normal((3, 8)).astype(np.float32)
    for add_op in ("add", "max", "min"):
        got, want = _both_sls(table, ptrs, idxs, add_op=add_op)
        assert (got.numpy() == 0).all()
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("g,n,r,e", [(5, 9, 2, 10), (7, 4, 1, 130),
                                     (3, 6, 8, 64), (1, 2, 4, 256),
                                     (6, 5, 4, 5)])
def test_block_gather(g, n, r, e):
    table = RNG.standard_normal((n * r, e)).astype(np.float32)
    idxs = RNG.integers(0, n, g).astype(np.int32)
    got = tops.block_gather(_t(table), _t(idxs), block_rows=r)
    want = jops.block_gather(jnp.asarray(table), jnp.asarray(idxs),
                             block_rows=r, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _id_stream(kind, n, g):
    """Lookup ids of the shapes the bulk gather groups differently: one
    block for all, every block once, a Zipf head, three long chains."""
    if kind == "all_equal":
        return np.full(g, n // 2, np.int32)
    if kind == "all_distinct":
        return RNG.permutation(n)[:g].astype(np.int32)
    if kind == "zipf":
        return (np.minimum(RNG.zipf(1.05, g), n) - 1).astype(np.int32)
    return RNG.integers(0, 3, g).astype(np.int32)


@pytest.mark.parametrize("kind", ["all_equal", "all_distinct", "zipf",
                                  "three_chains"])
def test_block_gather_on_id_streams(kind):
    """The plain version against the reference on the id streams the card
    tests give the bulk variant (repeats are exact copies)."""
    n, r, e, g = 40, 2, 12, 37
    table = RNG.standard_normal((n * r, e)).astype(np.float32)
    idxs = _id_stream(kind, n, g)
    got = tops.block_gather(_t(table), _t(idxs), block_rows=r)
    want = jops.block_gather(jnp.asarray(table), jnp.asarray(idxs),
                             block_rows=r, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_block_gather_roff_is_rebased_idxs():
    """The fused gather passes roff to the kernel; the reference adds it to
    the indices first (backend_pallas)."""
    n, r, e, g = 12, 2, 16, 9
    table = RNG.standard_normal((n * r, e)).astype(np.float32)
    idxs = RNG.integers(0, n // 2, g).astype(np.int32)
    roff = RNG.integers(0, n // 2, g).astype(np.int32)
    got = tops.block_gather(_t(table), _t(idxs), block_rows=r, roff=_t(roff))
    want = jops.block_gather(jnp.asarray(table), jnp.asarray(idxs + roff),
                             block_rows=r, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_tensors_never_launch_kernels():
    tops.reset_launch_counts()
    ptrs, idxs = _csr(4, 10, 2)
    table = _t(RNG.standard_normal((10, 8)).astype(np.float32))
    tops.sls(table, _t(ptrs), _t(idxs), num_segments=4)
    tops.block_gather(table, _t(idxs))
    tops.fusedmm(table, _t(ptrs), _t(idxs), num_segments=4)
    q = table.reshape(1, 10, 2, 4)
    tops.attention(q, q, q)
    leaf = q.detach().bfloat16().requires_grad_()
    tops.attention(leaf, leaf, leaf).float().sum().backward()
    assert tops.launch_counts() == {"sls": 0, "block_gather": 0,
                                    "fusedmm": 0, "flash_attention": 0}
    assert tops.backward_launch_counts() == {"flash_attention_bwd": 0,
                                             "block_gather_bwd": 0,
                                             "gather_transpose": 0}
    assert tops.variant_launch_counts() == {
        "sls": {"rows": 0, "sparse": 0},
        "block_gather": {"bulk": 0, "group": 0, "rows": 0},
        "fusedmm": {"ring": 0, "rows": 0},
        "flash_attention_bwd": {"simt": 0, "wgmma": 0}}


@pytest.mark.parametrize("bad", ["int64_idxs", "f64_table", "short_ptrs",
                                 "weights_dtype", "semiring", "strided"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    ptrs, idxs = _csr(4, 10, 2)
    table = _t(RNG.standard_normal((10, 8)).astype(np.float32))
    args = dict(table=table, ptrs=_t(ptrs), idxs=_t(idxs), weights=None)
    kw = dict(num_segments=4)
    if bad == "int64_idxs":
        args["idxs"] = args["idxs"].long()
    elif bad == "f64_table":
        args["table"] = table.double()
    elif bad == "short_ptrs":
        args["ptrs"] = args["ptrs"][:-1]
    elif bad == "weights_dtype":
        args["weights"] = torch.ones(len(idxs), dtype=torch.float64)
    elif bad == "semiring":
        kw["add_op"] = "mul"
    else:
        args["table"] = torch.zeros(8, 10).t()
    with pytest.raises(ValueError):
        tops.sls(*args.values(), **kw)


@pytest.mark.parametrize("emb,dtype,aligned,want", [
    (128, "float32", True, (4, 32, 8)),
    (128, "float32", False, (1, 32, 8)),
    (8, "float32", True, (4, 2, 128)),
    (8, "float32", False, (1, 8, 32)),
    (64, "float32", False, (1, 32, 8)),
    (5, "float32", True, (1, 8, 32)),
    (96, "bfloat16", True, (8, 16, 16)),
    (2048, "float32", True, (4, 32, 8)),
])
def test_one_launch_shape_for_plan_and_wrappers(emb, dtype, aligned, want):
    """The row tile is decided in one place: the compiled KernelPlan holds
    the tile of an aligned launch, and the wrappers derive theirs from the
    tensors' alignment; either fits one block."""
    from repro_torch.core.backend_cuda import make_plan
    from repro_torch.core.ops import EmbeddingOp
    from repro_torch.core.pipeline import compile_op
    from repro_torch.kernels.sls import BLOCK_THREADS, row_tile
    tile = row_tile(emb, 2 if dtype == "bfloat16" else 4, aligned)
    assert tuple(tile) == want
    assert tile.threads_per_row * tile.rows_per_block <= BLOCK_THREADS
    op = EmbeddingOp("sls", 4, 10, emb, avg_lookups=2, dtype=dtype)
    plan = make_plan(compile_op(op, "O3"))
    assert plan.tile == row_tile(emb, 2 if dtype == "bfloat16" else 4)


@pytest.mark.parametrize("kind,emb,itemsize,aligned,want", [
    ("block_gather", 2048, 4, True, "bulk"),      # DeepSeek rows, 8 KiB
    ("block_gather", 96, 2, True, "bulk"),        # 192 B bf16
    ("block_gather", 4, 4, True, "bulk"),         # one 16-byte unit
    ("block_gather", 5, 4, True, "rows"),         # 20 B: not 16-byte units
    ("block_gather", 6, 2, True, "rows"),
    ("block_gather", 2048, 4, False, "rows"),     # unaligned table
    ("fusedmm", 100, 4, True, "rows"),            # ogbn-products, 400 B
    ("fusedmm", 128, 4, True, "rows"),            # 512 B: under the crossover
    ("fusedmm", 256, 4, True, "rows"),            # 1 KB
    ("fusedmm", 272, 4, True, "ring"),            # 1088 B
    ("fusedmm", 520, 4, True, "ring"),            # 2080 B
    ("fusedmm", 1024, 4, True, "ring"),           # 4 KB: the widest ring
    ("fusedmm", 2048, 2, True, "ring"),
    ("fusedmm", 2048, 4, True, "rows"),           # 8 KB: wider than the ring
    ("fusedmm", 100, 2, True, "rows"),            # 200 B
    ("fusedmm", 5, 4, True, "rows"),
    ("fusedmm", 64, 4, False, "rows"),
])
def test_kernel_variant_is_chosen_from_the_shapes(kind, emb, itemsize,
                                                  aligned, want):
    """The bulk-copy variants take rows of whole 16-byte units on 16-byte
    aligned operands (what cp.async.bulk needs), FusedMM's ring rows from
    its measured crossover up to 4 KB; everything else keeps the row
    kernels, whose tile row_tile decides."""
    from repro_torch.kernels.sls import kernel_variant
    assert kernel_variant(kind, emb, itemsize, aligned) == want


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("units_past", [-1, 0, 1])
def test_fusedmm_ring_starts_at_its_crossover(itemsize, units_past):
    """The ring takes aligned rows from FUSEDMM_RING_MIN_ROW_BYTES on, in
    either dtype; a row one 16-byte unit narrower keeps the rows variant."""
    from repro_torch.kernels.sls import (FUSEDMM_RING_MIN_ROW_BYTES,
                                         kernel_variant)
    row_bytes = FUSEDMM_RING_MIN_ROW_BYTES + 16 * units_past
    want = "ring" if units_past >= 0 else "rows"
    assert kernel_variant("fusedmm", row_bytes // itemsize, itemsize,
                          True) == want
    assert kernel_variant("fusedmm", row_bytes // itemsize, itemsize,
                          False) == "rows"


def test_kernel_variant_of_a_kernel_without_variants_raises():
    from repro_torch.kernels.sls import kernel_variant
    with pytest.raises(ValueError, match="variants"):
        kernel_variant("flash_attention", 128, 4, True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
def test_flash_wrapper_at_head_dim_80_matches_the_reference(causal, h, hkv):
    """stablelm-3b's head dim, which the card's kernel takes padded to 128
    (``HEAD_DIMS`` holds (80, 80)): on CPU tensors the wrapper's plain
    version against the reference's Pallas flash kernel in interpret mode
    (one head per batch row there, KV heads repeated), f32, 2e-5."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    assert HEAD_DIMS == ((64, 64), (80, 80), (128, 128), (192, 128),
                         (256, 256))
    rng = np.random.default_rng(h + causal)
    b, s, d = 2, 128, 80
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    tops.reset_launch_counts()
    got = tops.attention(_t(q), _t(k), _t(v), causal=causal, chunk=64)
    assert tops.launch_counts()["flash_attention"] == 0
    flat = [np.ascontiguousarray(np.repeat(a, h // a.shape[2], 2)
                                 .transpose(0, 2, 1, 3)).reshape(b * h, s, d)
            for a in (q, k, v)]
    want = jops.attention(*map(jnp.asarray, flat), causal=causal,
                          block_q=64, block_k=64, interpret=True)
    want = np.asarray(want).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL_F32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv", [(8, 4), (4, 1)])
def test_flash_wrapper_at_head_dim_256_matches_the_reference(causal, h,
                                                            hkv):
    """gemma3-4b's head dim, whose bf16 kernel streams 64-key tiles: on CPU
    tensors the wrapper's plain version at that tile against the
    reference's Pallas flash kernel in interpret mode at the same KV block,
    f32, 2e-5."""
    from repro_torch.kernels.flash_attention import kv_tile
    tile = kv_tile(torch.bfloat16, 256)
    assert tile == 64
    rng = np.random.default_rng(h + hkv + causal)
    b, s, d = 1, 128, 256
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    got = tops.attention(_t(q), _t(k), _t(v), causal=causal, chunk=tile)
    flat = [np.ascontiguousarray(np.repeat(a, h // a.shape[2], 2)
                                 .transpose(0, 2, 1, 3)).reshape(b * h, s, d)
            for a in (q, k, v)]
    want = jops.attention(*map(jnp.asarray, flat), causal=causal,
                          block_q=64, block_k=tile, interpret=True)
    want = np.asarray(want).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL_F32)


def test_flash_wrapper_window_checks_and_instance_keys():
    """A window must be positive (on the CPU too); the launch counts by
    instance name dtype, widths, causal and the window the kernel masks."""
    from repro_torch.kernels.flash_attention import instance
    q = _t(RNG.standard_normal((1, 8, 4, 64)).astype(np.float32))
    k = _t(RNG.standard_normal((1, 8, 2, 64)).astype(np.float32))
    for window in (0, -1):
        with pytest.raises(ValueError, match="window must be positive"):
            tops.attention(q, k, k, window=window)
    tops.reset_launch_counts()
    tops.attention(q, k, k, window=3)
    assert tops.launch_counts()["flash_attention"] == 0
    assert not tops.flash_attention_cuda.instances
    assert instance(q.bfloat16(), k, True, 1024) == \
        "bfloat16 64/64 causal window 1024"
    assert instance(q, k[..., :32], False, 0) == "float32 64/32"


_ISA_SCRIPT = """
import hashlib, sys
import numpy as np, torch
from repro_torch.kernels.ref import attention
rng = np.random.default_rng(0)
digest = hashlib.sha1()
for d, causal in ((64, True), (64, False), (128, False)):
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(getattr(torch, sys.argv[1]))
               for s in ((2, 200, 16, d), (2, 328, 1, d), (2, 328, 1, d)))
    o = attention(q, k, v, causal=causal, chunk=128)
    digest.update(o.float().numpy().tobytes())
print(digest.hexdigest())
"""


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_attention_on_the_cpu_does_not_depend_on_the_hosts_code_path(
        dtype):
    """The plain attention's bits on the CPU are the same whichever code
    path the host's BLAS and ATen take -- MKL's SSE4.2, AVX2 and AVX-512
    kernels, ATen's vectorized or scalar loops (forced here through
    MKL_ENABLE_INSTRUCTIONS and ATEN_CPU_CAPABILITY in fresh processes):
    its products, exponentials and row sums are taken in fp64 and rounded
    to fp32 once, so the card tests that hold the card's plain result to
    the CPU's read the same CPU bits on every machine.  (Summed in fp32,
    they changed with MKL's instruction set.)  Inputs from numpy: torch's
    CPU randn also changes with the code path."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parent.parent / "src")
    digests = set()
    for env in ({}, {"MKL_ENABLE_INSTRUCTIONS": "SSE4_2"},
                {"MKL_ENABLE_INSTRUCTIONS": "AVX2"},
                {"ATEN_CPU_CAPABILITY": "default"}):
        r = subprocess.run(
            [sys.executable, "-c", _ISA_SCRIPT, dtype], capture_output=True,
            text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": src, "OMP_NUM_THREADS": "2",
                 **env})
        assert r.returncode == 0, r.stderr[-2000:]
        digests.add(r.stdout.strip())
    assert len(digests) == 1, digests
