"""FusedMM in the port against the JAX package on the CPU: the plain version
(what the kernel wrapper runs for CPU tensors) against the reference's
oracle and its Pallas kernel in interpret mode, and a fusedmm program
through the port's executor against the numpy oracle and the reference's
executor.  Tolerance 1e-4, the reference's own for fusedmm
(tests/test_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as jops
from repro.core.executor import ProgramExecutor as JProgramExecutor
from repro.core.pipeline import compile_program as jcompile_program
from repro.kernels import ops as jkops, ref as jref
from repro.kernels.sls import max_lookups_of
from repro_torch.convert import program_inputs_to_torch
from repro_torch.core import ops as tops
from repro_torch.core.executor import executor_for
from repro_torch.kernels import ops as kops, ref

TOL = dict(rtol=1e-4, atol=1e-4)


def _csr(rng, segs, rows, avg, pad=0):
    lens = rng.poisson(avg, segs)
    lens[::3] = 0                        # empty segments
    ptrs = np.zeros(segs + 1, np.int32)
    np.cumsum(lens, out=ptrs[1:])
    nnz = int(ptrs[-1])
    idxs = np.zeros(nnz + pad, np.int32)  # capacity padding: never read
    idxs[:nnz] = rng.integers(0, rows, nnz)
    return ptrs, idxs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("fn", ["identity", "relu"])
@pytest.mark.parametrize("segs,rows,avg,e", [(5, 5, 3, 10), (4, 9, 2, 64),
                                             (6, 6, 4, 33), (7, 12, 3, 130)])
def test_plain_fusedmm_matches_the_reference(fn, segs, rows, avg, e):
    rng = np.random.default_rng(segs * 100 + e)
    ptrs, idxs = _csr(rng, segs, rows, avg)
    x = rng.standard_normal((rows, e)).astype(np.float32)
    got = kops.fusedmm(_t(x), _t(ptrs), _t(idxs), num_segments=segs, fn=fn)
    assert got.dtype == torch.float32 and got.shape == (segs, e)
    want = jref.fusedmm(jnp.asarray(x), jnp.asarray(idxs),
                        jnp.asarray(jref.csr_to_lookups(ptrs)),
                        num_segments=segs, fn=fn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pallas = jkops.fusedmm(jnp.asarray(x), jnp.asarray(ptrs),
                           jnp.asarray(idxs), num_segments=segs,
                           max_lookups=max_lookups_of(ptrs), fn=fn,
                           interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    assert (got[_t(np.diff(ptrs) == 0)] == 0).all()


@pytest.mark.parametrize("degrees", [(0, 1, 40), (1,), (40, 0), (0,)])
def test_plain_fusedmm_over_segment_degrees(degrees):
    """Degrees 0, 1 and more than the card's ring holds (16 rows), in runs
    of segments: the plain version against the reference's oracle."""
    rng = np.random.default_rng(len(degrees))
    segs, e = 12, 24
    lens = np.resize(np.asarray(degrees), segs)
    ptrs = np.zeros(segs + 1, np.int32)
    np.cumsum(lens, out=ptrs[1:])
    idxs = rng.integers(0, segs, int(ptrs[-1])).astype(np.int32)
    x = rng.standard_normal((segs, e)).astype(np.float32)
    got = kops.fusedmm(_t(x), _t(ptrs), _t(idxs), num_segments=segs)
    want = jref.fusedmm(jnp.asarray(x), jnp.asarray(idxs),
                        jnp.asarray(jref.csr_to_lookups(ptrs)),
                        num_segments=segs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got[_t(lens == 0)] == 0).all()


def test_plain_fusedmm_never_reads_the_padded_tail():
    rng = np.random.default_rng(3)
    ptrs, idxs = _csr(rng, 9, 9, 3, pad=5)
    x = rng.standard_normal((9, 16)).astype(np.float32)
    want = ref.fusedmm(_t(x), _t(ptrs), _t(idxs[:ptrs[-1]]), num_segments=9)
    idxs[ptrs[-1]:] = 10 ** 6              # out of bounds if ever read
    got = ref.fusedmm(_t(x), _t(ptrs), _t(idxs), num_segments=9)
    assert torch.equal(got, want)


@pytest.mark.parametrize("chunk", [1, 4, 7])
def test_plain_fusedmm_in_chunks_of_segments_equals_whole(chunk):
    """How a large graph is checked: slices of ptrs with first_segment."""
    rng = np.random.default_rng(chunk)
    segs = 13
    ptrs, idxs = _csr(rng, segs, segs, 3)
    x = _t(rng.standard_normal((segs, 24)).astype(np.float32))
    whole = ref.fusedmm(x, _t(ptrs), _t(idxs), num_segments=segs, fn="relu")
    parts = [ref.fusedmm(x, _t(ptrs[lo:min(lo + chunk, segs) + 1]),
                         _t(idxs), num_segments=min(chunk, segs - lo),
                         fn="relu", first_segment=lo)
             for lo in range(0, segs, chunk)]
    torch.testing.assert_close(torch.cat(parts), whole, rtol=0, atol=0)


def test_plain_fusedmm_bf16_accumulates_in_fp32():
    rng = np.random.default_rng(5)
    ptrs, idxs = _csr(rng, 8, 8, 5)
    x = _t(rng.standard_normal((8, 40)).astype(np.float32)).bfloat16()
    got = kops.fusedmm(x, _t(ptrs), _t(idxs), num_segments=8)
    assert got.dtype == torch.bfloat16
    want = jref.fusedmm(jnp.asarray(x.float().numpy()), jnp.asarray(idxs),
                        jnp.asarray(jref.csr_to_lookups(ptrs)),
                        num_segments=8)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=5e-2, atol=5e-2)


def test_fusedmm_wrapper_checks_its_arguments():
    x = torch.zeros(4, 8)
    ptrs = torch.zeros(5, dtype=torch.int32)
    idxs = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="fn"):
        kops.fusedmm(x, ptrs, idxs, num_segments=4, fn="tanh")
    with pytest.raises(ValueError, match="rows"):
        kops.fusedmm(x, torch.zeros(6, dtype=torch.int32), idxs,
                     num_segments=5)
    with pytest.raises(ValueError, match="int32"):
        kops.fusedmm(x, ptrs.long(), idxs, num_segments=4)
    assert kops.fusedmm(x, ptrs, idxs, num_segments=4).abs().sum() == 0


def _program(m, fmt="offsets"):
    """One fusedmm op, built from either package's ops."""
    return m.EmbeddingProgram("mp", (("mp", m.EmbeddingOp(
        "fusedmm", 6, 6, 8, avg_lookups=2, index_format=fmt)),))


@pytest.mark.parametrize("fmt", ["offsets", "lengths"])
def test_fusedmm_program_through_the_executor_takes_fresh_x(fmt):
    """The port of tests/test_executor.py's fresh-x test: x is per-step data
    bound by identity, never frozen at step 1; the port's executor equals
    the numpy oracle and the reference executor for two seeds."""
    jprog, tprog = _program(jops, fmt), _program(tops, fmt)
    jex = JProgramExecutor(jcompile_program(jprog, "O2", vlen=4,
                                            use_cache=False))
    tex = executor_for(tprog, "O2", vlen=4, device="cpu")
    kops.reset_launch_counts()
    for seed in (0, 1):
        host = jops.make_program_inputs(jprog, seed=seed)
        got = tex.step(program_inputs_to_torch(host, "cpu"))["mp"]
        assert got.shape == (6, 8)
        want = jops.program_reference(jprog, host)["mp"]
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"seed {seed}",
                                   **TOL)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jex.step(host)["mp"]), **TOL)
    assert tex.stats["table_rebinds"] == 1
    assert kops.launch_counts()["fusedmm"] == 0     # CPU: plain version


def test_fusedmm_capacity_buckets_pad_nnz_and_reuse_staging():
    tprog = _program(tops)
    tex = executor_for(tprog, "O3", device="cpu")
    host = [tops.make_program_inputs(tprog, seed=s) for s in range(4)]
    for ins in host:
        got = tex.step(program_inputs_to_torch(ins, "cpu"))["mp"]
        np.testing.assert_allclose(got.numpy(),
                                   tops.program_reference(tprog, ins)["mp"],
                                   **TOL)
    caps = {tex._units[0].plan.lattice.lookup_capacity(len(i["mp"]["idxs"]))
            for i in host}
    assert tex.stats["marshal_misses"] == len(caps)
