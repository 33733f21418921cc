"""The kernels' gradients on the training path against the JAX package on
the CPU: flash attention through its ``FlashAttention`` Function (whose
backward on CPU tensors is the plain ``ref.attention_backward``, the
recurrence the backward kernel runs) against ``jax.grad`` of the
reference's ``blockwise_attention``, at every (q/k, v) width pair the
kernel takes, causal with and without the band, GQA groups 1 and 4 (and,
at every width pair, the plain version's ``tensor_cores`` mode -- P and dS
rounded to bf16 as the wgmma kernels take them -- on its own); and the
block gather's (``BlockGather``: an ``index_add_`` on the CPU, ``ember_sls``
over the transposed lookups on the card) against ``jax.grad`` of
``jnp.take``, duplicate ids included.  The same numpy inputs go through
both.  Tolerances: f32 2e-5 and bf16 5e-2, the reference's own for
attention (tests/test_kernels.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import ops as kops, ref
from repro_torch.kernels.flash_attention import HEAD_DIMS

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# Flash attention and the block gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,dv", HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("window", [None, 7])
def test_flash_attention_gradients_match_jax_grad(dtype, d, dv, group,
                                                  window):
    rng = np.random.default_rng(d + group + (window or 0))
    b, s, hkv = 2, 24, 2
    h = hkv * group
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for shape in
                   ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, dv),
                    (b, s, h, dv)))
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)

    def f(q_, k_, v_):
        o = jattn.blockwise_attention(q_, k_, v_, causal=True,
                                      window=window, chunk=8)
        return jnp.sum(o.astype(jnp.float32) * do)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *(jnp.asarray(x, jd) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v)]
    out = kops.attention(*leaves, causal=True, window=window, chunk=8)
    out.backward(torch.from_numpy(do).to(td))
    tol = F32 if dtype == "float32" else BF16
    for t, w in zip(leaves, want):
        assert t.grad.dtype == td
        np.testing.assert_allclose(_np(t.grad), np.asarray(w, np.float32),
                                   **tol)


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("window", [None, 7])
def test_tensor_core_rounding_of_the_plain_backward_matches_jax_grad(
        d, dv, group, window):
    """``ref.attention_backward(..., tensor_cores=True)``, the plain version
    of the wgmma backward (P and dS rounded to bf16 before the products that
    take them, fp32 sums), from the plain forward's own o and lse, against
    ``jax.grad`` of ``blockwise_attention`` in bf16, at the bf16
    tolerance; and it differs from the fp32-P mode, so the rounding is
    there."""
    rng = np.random.default_rng(100 + d + group + (window or 0))
    b, s, hkv = 2, 24, 2
    h = hkv * group
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for shape in
                   ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, dv),
                    (b, s, h, dv)))

    def f(q_, k_, v_):
        o = jattn.blockwise_attention(q_, k_, v_, causal=True,
                                      window=window, chunk=8)
        return jnp.sum(o.astype(jnp.float32) * do)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    o, lse = ref.attention(tq, tk, tv, window=window, chunk=8,
                           return_lse=True)
    got = ref.attention_backward(tq, tk, tv, o, tdo, lse, window=window,
                                 tensor_cores=True)
    fp32_p = ref.attention_backward(tq, tk, tv, o, tdo, lse, window=window)
    for t, w in zip(got, want):
        assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(t), np.asarray(w, np.float32), **BF16)
    assert any(not torch.equal(a, b) for a, b in zip(got, fp32_p))
    with pytest.raises(ValueError, match="bf16"):
        ref.attention_backward(tq.float(), tk.float(), tv.float(), o.float(),
                               tdo.float(), lse, tensor_cores=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_rows", [1, 3])
def test_block_gather_gradient_matches_jax_grad_of_take(dtype, block_rows):
    rng = np.random.default_rng(block_rows)
    n_blocks, e = 12, 10
    table = rng.standard_normal((n_blocks * block_rows, e)).astype(np.float32)
    idxs = np.array([3, 3, 0, 11, 3, 7, 0, 5], np.int32)     # duplicates
    dout = rng.standard_normal((len(idxs), block_rows, e)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)

    def f(tbl):
        blocks = tbl.reshape(n_blocks, block_rows * e)
        g = jnp.take(blocks, jnp.asarray(idxs), axis=0)
        return jnp.sum(g.astype(jnp.float32).reshape(dout.shape) * dout)
    want = jax.grad(f)(jnp.asarray(table, jd))
    t = torch.from_numpy(table).to(td).requires_grad_()
    out = kops.block_gather(t, torch.from_numpy(idxs), block_rows=block_rows)
    out.backward(torch.from_numpy(dout).to(td))
    np.testing.assert_allclose(_np(t.grad), np.asarray(want, np.float32),
                               **(F32 if dtype == "float32" else BF16))
    assert float(t.grad[n_blocks * block_rows - 1].abs().sum()) == 0 or \
        n_blocks - 1 in idxs


@pytest.mark.parametrize("dv", sorted({dv for _, dv in HEAD_DIMS}))
def test_plain_delta_sums_in_the_rows_kernels_order(dv):
    """The plain backward's delta = rowsum(dout * o) on bf16 inputs: the
    rows kernel's order (32 lanes, each over j, j + 32, ...; then a
    butterfly), written out here in numpy fp32 one lane at a time, bit for
    bit; and the row sum within fp32 rounding."""
    rng = np.random.default_rng(dv)
    o, do = (torch.from_numpy(rng.standard_normal((2, 5, 3, dv)).astype(
        np.float32)).bfloat16() for _ in range(2))
    got = ref._rows_delta(o, do)
    prod = (_np(o) * _np(do)).astype(np.float32)
    lanes = np.zeros((2, 5, 3, 32), np.float32)
    for j in range(32):
        for c in range(j, dv, 32):
            lanes[..., j] = lanes[..., j] + prod[..., c]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ off]
    assert got.dtype == torch.float32 and got.shape == (2, 5, 3)
    np.testing.assert_array_equal(got.numpy(), lanes[..., 0])
    np.testing.assert_allclose(got.numpy(), prod.astype(np.float64).sum(-1),
                               rtol=1e-5, atol=1e-5)
