"""The block gather's backward: its lookups' transposition into CSR and the
SLS variant that sums it, on the CPU.

The transposition's plain version (``ref.transposed_lookups``) is held to
numpy's stable argsort and bincount on the streams a token stream
produces; the backward on CPU tensors to ``jax.grad`` of the JAX package's
gather function; the SLS variant choice to the shapes it must tell apart.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
marker ``cuda``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import gather as kgather, ops as kops, ref
from repro_torch.kernels.sls import kernel_variant

F32 = dict(rtol=2e-5, atol=2e-5)


def _stream(kind: str, n_tbl: int, g: int, rng) -> np.ndarray:
    """g block ids below n_tbl: one id repeated (padding or EOS), all
    distinct, the last id among uniform ones, a Zipf(1.1) head."""
    if kind == "hot":
        return np.full(g, 7 % n_tbl, np.int32)
    if kind == "distinct":
        return rng.permutation(n_tbl)[:g].astype(np.int32)
    if kind == "last":
        ids = rng.integers(0, n_tbl, g)
        ids[::3] = n_tbl - 1
        return ids.astype(np.int32)
    return (np.minimum(rng.zipf(1.1, g), n_tbl) - 1).astype(np.int32)


def _numpy_csr(blk: np.ndarray, n_tbl: int):
    order = np.argsort(blk, kind="stable").astype(np.int32)
    ptrs = np.zeros(n_tbl + 1, np.int32)
    np.cumsum(np.bincount(blk, minlength=n_tbl), out=ptrs[1:])
    return order, ptrs


@pytest.mark.parametrize("kind,n_tbl,g,with_roff", [
    ("hot", 50, 300, False),
    ("distinct", 5000, 5000, False),
    ("last", 1000, 777, False),
    ("zipf", 32000, 8192, False),
    ("zipf", 600, 400, True),          # a fused unit's rebased ids
    ("last", 9, 1, False),             # G = 1
    ("hot", 12, 0, False),             # G = 0
    ("zipf", 122944, 98304, False),    # G > 65,536: DeepSeek's un-dispatch
    ("distinct", 100000, 66000, True),
])
def test_plain_transposition_is_numpys_stable_sort(kind, n_tbl, g, with_roff):
    rng = np.random.default_rng(g + n_tbl)
    roff = None
    if with_roff:
        roff = rng.integers(0, n_tbl // 3, g).astype(np.int32)
        ids = _stream(kind, n_tbl - n_tbl // 3, g, rng)
        blk = ids + roff
    else:
        ids = blk = _stream(kind, n_tbl, g, rng)
    got_order, got_ptrs = ref.transposed_lookups(
        torch.from_numpy(ids), None if roff is None else
        torch.from_numpy(roff), n_tbl)
    order, ptrs = _numpy_csr(blk, n_tbl)
    assert got_order.dtype == got_ptrs.dtype == torch.int32
    np.testing.assert_array_equal(got_order.numpy(), order)
    np.testing.assert_array_equal(got_ptrs.numpy(), ptrs)


def test_transposition_wrapper_on_the_cpu_runs_the_plain_version():
    ids = torch.tensor([4, 1, 4, 0, 1, 4], dtype=torch.int32)
    kops.reset_launch_counts()
    order, ptrs = kgather.transposed_lookups(ids, None, 6)
    assert order.tolist() == [3, 1, 4, 0, 2, 5]
    assert ptrs.tolist() == [0, 1, 3, 3, 3, 6, 6]
    assert kops.backward_launch_counts()["gather_transpose"] == 0
    with pytest.raises(ValueError):
        kgather.transposed_lookups(ids.long(), None, 6)


@pytest.mark.parametrize("block_rows", [1, 4])
@pytest.mark.parametrize("with_roff", [False, True])
def test_cpu_backward_matches_jax_grad_of_the_gather(block_rows, with_roff):
    """A Zipf(1.1) stream with a hot id through block_gather_backward on
    CPU tensors, against jax.grad of the gather's function (jnp.take of
    the table's blocks; the JAX package's Pallas gather, interpret mode,
    computes that function and has no gradient rule), f32, 2e-5."""
    rng = np.random.default_rng(block_rows + 2 * with_roff)
    n_blocks, e, g = 40, 12, 300
    ids = _stream("zipf", n_blocks // 2, g, rng)
    ids[::5] = 3                                   # a hot id
    roff = rng.integers(0, n_blocks // 2, g).astype(np.int32) \
        if with_roff else np.zeros(g, np.int32)
    table = rng.standard_normal((n_blocks * block_rows, e)).astype(np.float32)
    dout = rng.standard_normal((g, block_rows, e)).astype(np.float32)
    blk = jnp.asarray(ids + roff)

    def gather(tbl):
        return jnp.take(tbl.reshape(n_blocks, block_rows * e), blk,
                        axis=0).reshape(g, block_rows, e)
    pallas = jops.block_gather(jnp.asarray(table), blk,
                               block_rows=block_rows, interpret=True)
    np.testing.assert_array_equal(np.asarray(pallas),
                                  np.asarray(gather(jnp.asarray(table))))
    want = jax.grad(lambda t: jnp.sum(gather(t) * dout))(jnp.asarray(table))
    got = kgather.block_gather_backward(
        torch.from_numpy(dout), torch.from_numpy(ids), n_blocks * block_rows,
        block_rows=block_rows,
        roff=torch.from_numpy(roff) if with_roff else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_cpu_backward_of_no_lookups_is_zero():
    got = kgather.block_gather_backward(
        torch.zeros((0, 2, 3)), torch.zeros(0, dtype=torch.int32), 8,
        block_rows=2)
    assert got.shape == (8, 3) and not bool(got.any())


#: (num_segments, lookups, emb_len, itemsize): the block gather's backward
#: at danube's and whisper's token embedding, the reduced MoE's un-dispatch
#: and DeepSeek-V2-Lite's un-dispatch prefill
BACKWARD_SHAPES = [(32000, 8192, 2560, 2), (51968, 1500, 1280, 2),
                   (2568, 2048, 256, 4), (122944, 98304, 2048, 2)]


@pytest.mark.parametrize("segs,lookups,emb,itemsize", BACKWARD_SHAPES)
def test_sls_variant_is_sparse_at_the_backward_shapes(segs, lookups, emb,
                                                      itemsize):
    assert kernel_variant("sls", emb, itemsize, True, num_segments=segs,
                          lookups=lookups, plain_sum=True) == "sparse"
    # not 16-byte aligned, or not a plain sum: the rows kernel
    assert kernel_variant("sls", emb, itemsize, False, num_segments=segs,
                          lookups=lookups, plain_sum=True) == "rows"
    assert kernel_variant("sls", emb, itemsize, True, num_segments=segs,
                          lookups=lookups, plain_sum=False) == "rows"


@pytest.mark.parametrize("plain_sum", [False, True])
def test_sls_variant_keeps_the_rows_kernel_at_dlrms_fused_unit(plain_sum):
    """DLRM-DCNv2's fused unit (53,248 segments, 438,272 lookups, E = 128
    f32, seg_base: not a plain sum) keeps sls_kernel; so would its shape as
    a plain sum (8.2 lookups a segment), and so does a backward whose
    table has fewer blocks than it has lookups, or rows of 20 bytes."""
    assert kernel_variant("sls", 128, 4, True, num_segments=53248,
                          lookups=438272, plain_sum=plain_sum) == "rows"
    assert kernel_variant("sls", 64, 4, True, num_segments=50, lookups=300,
                          plain_sum=True) == "rows"
    assert kernel_variant("sls", 5, 4, True, num_segments=5000, lookups=300,
                          plain_sum=True) == "rows"
