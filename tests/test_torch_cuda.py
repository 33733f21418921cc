"""The hand-written Hopper kernels held against their plain PyTorch versions
on the card.  Every test carries the ``cuda`` marker and skips where there
is no CUDA device.  Run them on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(This file imports no JAX, so it runs where only PyTorch is installed.)"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as kops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _csr(rng, segs, rows, avg, pad=3):
    lens = rng.poisson(avg, segs)
    lens[::3] = 0
    ptrs = np.zeros(segs + 1, np.int32)
    np.cumsum(lens, out=ptrs[1:])
    idxs = np.zeros(int(ptrs[-1]) + pad, np.int32)
    idxs[:int(ptrs[-1])] = rng.integers(0, rows, int(ptrs[-1]))
    return ptrs, idxs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("emb", [5, 96, 128])
@pytest.mark.parametrize("add_op", ["add", "max", "min"])
@pytest.mark.parametrize("mul_op", [None, "mul", "add"])
def test_sls_kernel_matches_plain(cuda, dtype, emb, add_op, mul_op):
    rng = np.random.default_rng(emb)
    rows, segs = 200, 41
    ptrs, idxs = _csr(rng, segs, rows // 2, 4)
    table = torch.from_numpy(rng.standard_normal((rows, emb))
                             .astype(np.float32)).to(cuda, dtype)
    w = None
    if mul_op:
        w = torch.from_numpy(rng.standard_normal(len(idxs))
                             .astype(np.float32)).to(cuda, dtype)
    base = torch.from_numpy(rng.integers(0, rows // 2, segs)
                            .astype(np.int32)).to(cuda)
    args = (table, torch.from_numpy(ptrs).to(cuda),
            torch.from_numpy(idxs).to(cuda), w)
    kw = dict(num_segments=segs, add_op=add_op, mul_op=mul_op or "mul",
              seg_base=base)
    before = kops.launch_counts()["sls"]
    got = kops.sls(*args, **kw)
    torch.cuda.synchronize()
    assert kops.launch_counts()["sls"] == before + 1
    want = ref.sls(*args, **kw)
    if dtype == torch.bfloat16:
        tol = dict(rtol=5e-2, atol=5e-2)
    elif add_op == "add":       # fp32 sums in another order
        tol = dict(rtol=1e-5, atol=2e-4)
    else:                       # max/min select: exact
        tol = dict(rtol=0, atol=0)
    torch.testing.assert_close(got, want, **tol)
    assert (got[torch.from_numpy(np.diff(ptrs) == 0).to(cuda)] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("emb", [5, 96, 2048])
@pytest.mark.parametrize("block_rows", [1, 4])
@pytest.mark.parametrize("with_roff", [False, True])
def test_gather_kernel_is_bit_exact(cuda, dtype, emb, block_rows, with_roff):
    rng = np.random.default_rng(emb + block_rows)
    n, g = 40, 57
    table = torch.from_numpy(rng.standard_normal((n * block_rows, emb))
                             .astype(np.float32)).to(cuda, dtype)
    idxs = torch.from_numpy(rng.integers(0, n // 2, g)
                            .astype(np.int32)).to(cuda)
    roff = None
    if with_roff:
        roff = torch.from_numpy(rng.integers(0, n // 2, g)
                                .astype(np.int32)).to(cuda)
    got = kops.block_gather(table, idxs, block_rows=block_rows, roff=roff)
    want = ref.block_gather(table, idxs, block_rows=block_rows, roff=roff)
    assert torch.equal(got, want)


def test_executor_on_the_card_matches_the_cpu(cuda):
    from repro_torch.convert import program_inputs_to_torch
    from repro_torch.core.executor import executor_for
    from repro_torch.core.ops import (EmbeddingOp, EmbeddingProgram,
                                      make_program_inputs)
    prog = EmbeddingProgram("card", (
        ("a", EmbeddingOp("sls", 30, 50, 64, avg_lookups=3, weighted=True)),
        ("b", EmbeddingOp("kg", 20, 40, 64)),
        ("g1", EmbeddingOp("gather", 25, 60, 64)),
        ("g2", EmbeddingOp("gather", 25, 60, 64)),
    ), shared_tables=(("g1", "g2"),))
    host = make_program_inputs(prog, seed=4)
    kops.reset_launch_counts()
    got = executor_for(prog, "O3").step(program_inputs_to_torch(host))
    assert kops.launch_counts() == {"sls": 1, "block_gather": 1}
    want = executor_for(prog, "O3", device="cpu").step(
        program_inputs_to_torch(host, "cpu"))
    for name in want:
        torch.testing.assert_close(got[name].cpu(), want[name],
                                   rtol=1e-5, atol=2e-4)


def _unaligned(rng, rows, emb, device):
    """A contiguous (rows, emb) fp32 view one element into a flat buffer (a
    slice of a flat parameter buffer): not 16-byte aligned."""
    flat = torch.from_numpy(rng.standard_normal(rows * emb + 1)
                            .astype(np.float32)).to(device)
    table = flat[1:].view(rows, emb)
    assert table.is_contiguous() and table.data_ptr() % 16 != 0
    return table


@pytest.mark.parametrize("emb", [8, 64])
def test_executor_on_an_unaligned_table(cuda, emb):
    """Single-slot units run on the caller's tensor as given; on an
    unaligned table the kernels take one element per access, and the launch
    shape follows the tensors, not the compiled plan."""
    from repro_torch.core.executor import executor_for
    from repro_torch.core.ops import EmbeddingOp, EmbeddingProgram
    rng = np.random.default_rng(emb)
    rows, segs, gathers = 70, 30, 25
    prog = EmbeddingProgram("unaligned", (
        ("s", EmbeddingOp("sls", segs, rows, emb, avg_lookups=3)),
        ("g", EmbeddingOp("gather", gathers, rows, emb)),
    ))
    ptrs, idxs = _csr(rng, segs, rows, 3, pad=0)
    gidx = rng.integers(0, rows, gathers).astype(np.int32)
    ins = {"s": {"table": _unaligned(rng, rows, emb, cuda), "ptrs": ptrs,
                 "idxs": idxs},
           "g": {"table": _unaligned(rng, rows, emb, cuda), "idxs": gidx}}
    ex = executor_for(prog, "O3")
    kops.reset_launch_counts()
    got = ex.step(ins)
    assert kops.launch_counts() == {"sls": 1, "block_gather": 1}
    assert all(u.table.data_ptr() % 16 for u in ex._units)
    want_s = ref.sls(ins["s"]["table"], torch.from_numpy(ptrs).to(cuda),
                     torch.from_numpy(idxs).to(cuda), num_segments=segs)
    torch.testing.assert_close(got["s"], want_s, rtol=1e-5, atol=2e-4)
    want_g = ref.block_gather(ins["g"]["table"],
                              torch.from_numpy(gidx).to(cuda))
    assert torch.equal(got["g"], want_g)


def test_launch_errors_raise(cuda):
    from repro_torch.kernels import _build
    table = torch.randn(10, 8, device=cuda)
    idxs = torch.zeros(3, dtype=torch.int32, device=cuda)
    out = torch.empty(3, 1, 8, device=cuda)
    # 32 threads per row x 1024 rows per block: more than a block may hold
    err = _build.library().ember_block_gather(
        table.data_ptr(), idxs.data_ptr(), None, out.data_ptr(), 3, 1, 32,
        16, 32, 1024, torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="failed to launch"):
        _build.check(err, "ember_block_gather")
