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
    assert tops.launch_counts() == {"sls": 0, "block_gather": 0}


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
