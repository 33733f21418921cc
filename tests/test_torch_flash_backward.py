"""The kernels' gradients on the training path against the JAX package on
the CPU: flash attention through its ``FlashAttention`` Function (whose
backward on CPU tensors is the plain ``ref.attention_backward``, the
recurrence the backward kernel runs) against ``jax.grad`` of the
reference's ``blockwise_attention``, at every (q/k, v) width pair the
kernel takes, causal with and without the band, GQA groups 1 and 4; and the
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
from repro_torch.kernels import ops as kops
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
