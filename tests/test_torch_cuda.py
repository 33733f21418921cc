"""The hand-written Hopper kernels held against their plain PyTorch versions
on the card.  Every test carries the ``cuda`` marker and skips where there
is no CUDA device.  Run them on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(This file imports no JAX, so it runs where only PyTorch is installed.)"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as kops, ref
from repro_torch.kernels.agreement import check_bf16
from repro_torch.kernels.flash_attention import kv_tile

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
        check_bf16(got, want, "sls")
    elif add_op == "add":       # fp32 sums in another order
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-4)
    else:                       # max/min select: exact
        torch.testing.assert_close(got, want, rtol=0, atol=0)
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


def _variant_delta(kernel, before):
    after = kops.variant_launch_counts()[kernel]
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


# id streams and shapes for the bulk gather: (blocks in the table, lookups,
# E, block_rows, dtype, ids, roff); "rows" marks the old variant's cases
_GATHER_CASES = {
    "all_equal": (50, 300, 64, 1, torch.float32, "equal", False),
    "all_distinct": (500, 300, 64, 1, torch.float32, "distinct", False),
    "zipf": (1000, 3000, 128, 1, torch.float32, "zipf", False),
    # 3 blocks for 4000 lookups: each block's chain of outputs far
    # outnumbers the ring's 8 stages and a work item's 32 outputs
    "chain_longer_than_the_ring": (30, 4000, 96, 1, torch.float32, "three",
                                   False),
    "block_rows_4": (40, 57, 96, 4, torch.float32, "uniform", False),
    "roff": (40, 57, 96, 1, torch.float32, "uniform", True),
    "bf16": (40, 57, 96, 1, torch.bfloat16, "uniform", True),
    # blocks of 16 KiB and 32 KiB: two and four 8 KiB stages
    "rows_larger_than_a_stage": (40, 57, 4096, 1, torch.float32, "uniform",
                                 False),
    "blocks_larger_than_a_stage": (40, 57, 2048, 4, torch.float32, "zipf",
                                   True),
    "many_lookups": (20000, 131072, 256, 1, torch.float32, "uniform", True),
    "e5_rows": (40, 57, 5, 1, torch.float32, "uniform", True),
    "unaligned_rows": (40, 57, 64, 1, torch.float32, "uniform", False),
}


@pytest.mark.parametrize("case", sorted(_GATHER_CASES))
def test_gather_variants_are_bit_exact(cuda, case):
    """Each case goes through the variant kernel_variant picks (bulk:
    grouping pass + bulk copy; rows: the row kernel) and must equal the
    plain version bit for bit."""
    from repro_torch.kernels.sls import kernel_variant
    n, g, emb, block_rows, dtype, ids, with_roff = _GATHER_CASES[case]
    rng = np.random.default_rng(len(case))
    if case == "unaligned_rows":
        table = _unaligned(rng, n * block_rows, emb, cuda)
    else:
        table = torch.from_numpy(rng.standard_normal(
            (n * block_rows, emb)).astype(np.float32)).to(cuda, dtype)
    half = n // 2 if with_roff else n
    stream = {"equal": lambda: np.full(g, half // 3),
              "distinct": lambda: rng.permutation(half)[:g],
              "zipf": lambda: np.minimum(rng.zipf(1.05, g), half) - 1,
              "three": lambda: rng.integers(0, 3, g),
              "uniform": lambda: rng.integers(0, half, g)}[ids]()
    idxs = torch.from_numpy(stream.astype(np.int32)).to(cuda)
    roff = None
    if with_roff:
        roff = torch.from_numpy(rng.integers(0, n - half + 1, g)
                                .astype(np.int32)).to(cuda)
    before = kops.variant_launch_counts()["block_gather"]
    got = kops.block_gather(table, idxs, block_rows=block_rows, roff=roff)
    torch.cuda.synchronize()
    variant = kernel_variant("block_gather", emb, table.element_size(),
                             table.data_ptr() % 16 == 0)
    assert variant == ("rows" if case.endswith("_rows") else "bulk")
    want_delta = ({"bulk": 1, "group": 1} if variant == "bulk"
                  else {"rows": 1})
    assert _variant_delta("block_gather", before) == want_delta
    assert torch.equal(got, ref.block_gather(table, idxs,
                                             block_rows=block_rows,
                                             roff=roff))
    if variant == "bulk":
        # the rows variant takes every shape: launched as the wrapper
        # launches it, it must give the same bits
        from repro_torch.kernels.gather import launch_variant
        rows_out = torch.empty_like(got)
        launch_variant("rows", table, idxs, rows_out, block_rows=block_rows,
                       roff=roff)
        assert torch.equal(rows_out, got)


def test_bulk_gather_refuses_what_it_does_not_take(cuda):
    """The C entry points of the bulk variant refuse rows that are not
    16-byte units and unaligned tables (the wrapper never sends them)."""
    from repro_torch.kernels import _build
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    table = torch.randn(10, 8, device=cuda)
    idxs = torch.zeros(3, dtype=torch.int32, device=cuda)
    out = torch.empty(3, 1, 8, device=cuda)
    scratch = torch.empty(lib.ember_gather_scratch_bytes(3),
                          dtype=torch.uint8, device=cuda)
    assert lib.ember_gather_group(idxs.data_ptr(), None, scratch.data_ptr(),
                                  3, stream) == 0
    assert lib.ember_block_gather_bulk(
        table.data_ptr(), out.data_ptr(), scratch.data_ptr(), 3, 24,
        stream) != 0
    assert lib.ember_block_gather_bulk(
        table.data_ptr() + 4, out.data_ptr(), scratch.data_ptr(), 3, 32,
        stream) != 0
    assert lib.ember_gather_scratch_bytes(0) == 0
    torch.cuda.synchronize()


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
    assert kops.launch_counts() == {"sls": 1, "block_gather": 1,
                                   "fusedmm": 0, "flash_attention": 0}
    assert kops.variant_launch_counts()["block_gather"] == {
        "bulk": 1, "group": 1, "rows": 0}
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
    assert kops.launch_counts() == {"sls": 1, "block_gather": 1,
                                   "fusedmm": 0, "flash_attention": 0}
    assert kops.variant_launch_counts()["block_gather"] == {
        "bulk": 0, "group": 0, "rows": 1}
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


def test_fusedmm_and_flash_launch_errors_raise(cuda):
    from repro_torch.kernels import _build
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.randn(10, 8, device=cuda)
    ptrs = torch.zeros(4, dtype=torch.int32, device=cuda)
    out = torch.empty(3, 8, device=cuda)
    # 32 threads per row x 1024 rows per block: more than a block may hold
    err = lib.ember_fusedmm(x.data_ptr(), ptrs.data_ptr(), ptrs.data_ptr(),
                            out.data_ptr(), 3, 8, 0, 0, 1, 32, 1024, stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="failed to launch"):
        _build.check(err, "ember_fusedmm")
    q = torch.randn(1, 8, 2, 96, device=cuda)
    err = lib.ember_flash_attention(q.data_ptr(), q.data_ptr(), q.data_ptr(),
                                    q.data_ptr(), 1, 8, 8, 2, 2, 96, 96, 0,
                                    1, 96 ** -0.5, stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="failed to launch"):
        _build.check(err, "ember_flash_attention")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("emb", [5, 8, 64, 100, 128, 520, 1024])
@pytest.mark.parametrize("fn", ["identity", "relu"])
def test_fusedmm_kernel_matches_plain(cuda, dtype, emb, fn):
    rng = np.random.default_rng(emb)
    rows = 150
    ptrs, idxs = _csr(rng, rows, rows, 6)
    x = torch.from_numpy(rng.standard_normal((rows, emb))
                         .astype(np.float32)).to(cuda, dtype)
    args = (x, torch.from_numpy(ptrs).to(cuda),
            torch.from_numpy(idxs).to(cuda))
    before = kops.launch_counts()["fusedmm"]
    variants = kops.variant_launch_counts()["fusedmm"]
    got = kops.fusedmm(*args, num_segments=rows, fn=fn)
    torch.cuda.synchronize()
    assert kops.launch_counts()["fusedmm"] == before + 1
    # the ring takes rows of whole 16-byte units wider than 1 KB (f32 E =
    # 520 and 1024, bf16 E = 1024); narrower rows, E = 5 and bf16 E = 100
    # (200 B) keep the row kernel
    from repro_torch.kernels.sls import kernel_variant
    assert _variant_delta("fusedmm", variants) == {
        kernel_variant("fusedmm", emb, x.element_size(), True): 1}
    want = ref.fusedmm(*args, num_segments=rows, fn=fn)
    # fp32 dots of up to 520 terms and sums of ~10 scaled rows in another
    # order; bf16 rounds the output once
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    else:
        check_bf16(got, want, "fusedmm")
    assert (got[torch.from_numpy(np.diff(ptrs) == 0).to(cuda)] == 0).all()


def test_fusedmm_kernel_on_an_unaligned_table(cuda):
    rng = np.random.default_rng(1)
    x = _unaligned(rng, 90, 64, cuda)
    ptrs, idxs = _csr(rng, 90, 90, 5)
    args = (x, torch.from_numpy(ptrs).to(cuda),
            torch.from_numpy(idxs).to(cuda))
    variants = kops.variant_launch_counts()["fusedmm"]
    torch.testing.assert_close(kops.fusedmm(*args, num_segments=90),
                               ref.fusedmm(*args, num_segments=90),
                               rtol=1e-4, atol=1e-3)
    assert _variant_delta("fusedmm", variants) == {"rows": 1}


@pytest.mark.parametrize("degrees", [(0, 1, 40), (1,), (40, 0), (0,),
                                     (200, 3, 0, 0, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fusedmm_ring_over_segment_degrees(cuda, degrees, dtype):
    """Degrees 0, 1 and more than the ring's stages (16 at E = 64) in runs
    of segments, so a warp's ring runs on across segment boundaries; more
    segments than the grid has warps, and fewer.  The ring is launched as
    the wrapper launches it, at a width the wrapper gives the rows
    variant: its deepest ring."""
    from repro_torch.kernels.fusedmm import launch_variant
    rng = np.random.default_rng(len(degrees))
    for segs in (37, 9000):
        lens = np.resize(np.asarray(degrees), segs)
        ptrs = np.zeros(segs + 1, np.int32)
        np.cumsum(lens, out=ptrs[1:])
        idxs = rng.integers(0, segs, int(ptrs[-1]) + 3).astype(np.int32)
        x = torch.from_numpy(rng.standard_normal((segs, 64)).astype(
            np.float32)).to(cuda, dtype)
        args = (x, torch.from_numpy(ptrs).to(cuda),
                torch.from_numpy(idxs).to(cuda))
        variants = kops.variant_launch_counts()["fusedmm"]
        got = torch.empty_like(x)
        launch_variant("ring", *args, got, fn="relu")
        torch.cuda.synchronize()
        assert _variant_delta("fusedmm", variants) == {"ring": 1}
        want = ref.fusedmm(*args, num_segments=segs, fn="relu")
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
        else:
            check_bf16(got, want, f"fusedmm ring degrees {degrees}")
        assert (got[torch.from_numpy(lens == 0).to(cuda)] == 0).all()


def test_fusedmm_ring_refuses_what_it_does_not_take(cuda):
    """The ring's C entry point refuses rows that are not 16-byte units,
    rows over 4 KB and unaligned x (the wrapper never sends them)."""
    from repro_torch.kernels import _build
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.randn(10, 2048, device=cuda)
    ptrs = torch.zeros(11, dtype=torch.int32, device=cuda)
    out = torch.empty(10, 2048, device=cuda)
    p = (ptrs.data_ptr(), ptrs.data_ptr())
    assert lib.ember_fusedmm_ring(x.data_ptr(), *p, out.data_ptr(), 10, 5, 0,
                                  0, stream) != 0
    assert lib.ember_fusedmm_ring(x.data_ptr(), *p, out.data_ptr(), 10, 2048,
                                  0, 0, stream) != 0
    assert lib.ember_fusedmm_ring(x.data_ptr() + 4, *p, out.data_ptr(), 10,
                                  64, 0, 0, stream) != 0
    assert lib.ember_fusedmm_ring(x.data_ptr(), *p, out.data_ptr(), 10, 64,
                                  0, 0, stream) == 0
    torch.cuda.synchronize()


def test_fusedmm_program_on_the_card_matches_the_cpu(cuda):
    from repro_torch.convert import program_inputs_to_torch
    from repro_torch.core.executor import executor_for
    from repro_torch.core.ops import (EmbeddingOp, EmbeddingProgram,
                                      make_program_inputs)
    prog = EmbeddingProgram("gnn", (
        ("mp", EmbeddingOp("fusedmm", 300, 300, 100, avg_lookups=7)),))
    ex = executor_for(prog, "O3")
    kops.reset_launch_counts()
    for seed in (0, 1):          # fresh x every step
        host = make_program_inputs(prog, seed=seed)
        got = ex.step(program_inputs_to_torch(host))["mp"]
        want = executor_for(prog, "O3", device="cpu").step(
            program_inputs_to_torch(host, "cpu"))["mp"]
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-3)
    assert kops.launch_counts()["fusedmm"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2), (16, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,sk", [(128, 128), (200, 200), (200, 328)])
def test_flash_kernel_matches_plain(cuda, dtype, d, h, hkv, causal, s, sk):
    g = torch.Generator(device=cuda).manual_seed(s + sk + d)
    q = torch.randn((2, s, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, sk, hkv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, sk, hkv, d), generator=g, device=cuda).to(dtype)
    before = kops.launch_counts()["flash_attention"]
    got = kops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kops.launch_counts()["flash_attention"] == before + 1
    want = ref.attention(q, k, v, causal=causal, chunk=kv_tile(dtype))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        check_bf16(got, want, "flash attention")


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_bf16_attention_on_the_card_matches_the_cpu(cuda, d, causal):
    """On the card the plain version sums bf16 products on the tensor cores
    (cuBLAS bf16 -> fp32), on the CPU in fp32 after a cast: the same
    function, the sums in another order.  A score summed otherwise may
    round a p to the other side of a bf16 step, so a few elements of a
    few-key row may move by more than one step; the share of elements
    differing and the relative L2 hold to check_bf16's bounds."""
    from repro_torch.kernels.agreement import (
        BF16_MAX_REL_L2, BF16_MAX_SHARE_DIFFERING, bf16_agreement)
    g = torch.Generator(device=cuda).manual_seed(d + causal)
    q = torch.randn((2, 200, 16, d), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, 328, 1, d), generator=g, device=cuda).bfloat16()
    v = torch.randn((2, 328, 1, d), generator=g, device=cuda).bfloat16()
    chunk = kv_tile(torch.bfloat16)
    got = ref.attention(q, k, v, causal=causal, chunk=chunk)
    want = ref.attention(q.cpu(), k.cpu(), v.cpu(), causal=causal,
                         chunk=chunk)
    a = bf16_agreement(got.cpu(), want)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert a["share_differing"] <= BF16_MAX_SHARE_DIFFERING, a
    assert a["rel_l2"] <= BF16_MAX_REL_L2, a


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", [(4, 4), (32, 32), (8, 2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,sk", [(128, 128), (200, 200), (200, 328)])
def test_flash_kernel_at_head_dim_80_matches_plain(cuda, dtype, h, hkv,
                                                   causal, s, sk):
    """stablelm-3b's head dim: the D = 128 kernels on zero-padded columns
    (80-wide tensor maps in bf16, guarded loads in f32), against the plain
    version at the real width."""
    g = torch.Generator(device=cuda).manual_seed(s + sk + h)
    q = torch.randn((2, s, h, 80), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, sk, hkv, 80), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, sk, hkv, 80), generator=g, device=cuda).to(dtype)
    before = kops.launch_counts()["flash_attention"]
    got = kops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kops.launch_counts()["flash_attention"] == before + 1
    assert got.shape == q.shape
    want = ref.attention(q, k, v, causal=causal, chunk=kv_tile(dtype))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        check_bf16(got, want, "flash attention at D = 80")


def test_flash_kernel_at_head_dim_80_leaves_its_neighbours_alone(cuda):
    """The 80-wide output map stores only the 80 real columns: a view of
    q, k, v and o inside larger buffers keeps the bytes past each tensor."""
    g = torch.Generator(device=cuda).manual_seed(80)
    q, k, v = (torch.randn((1, 256, 4, 80), generator=g,
                           device=cuda).bfloat16() for _ in range(3))
    out = kops.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    check_bf16(out, ref.attention(q, k, v, causal=True,
                                  chunk=kv_tile(torch.bfloat16)), "D = 80")
    from repro_torch.kernels import _build
    buf = torch.full((2 * out.numel(),), 7.0, device=cuda).bfloat16()
    o = buf[:out.numel()].view_as(out)
    err = _build.library().ember_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, 256, 256,
        4, 4, 80, 80, 1, 1, 80 ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(o, out)
    assert bool((buf[out.numel():] == 7.0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", [(4, 4), (16, 16), (8, 2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,sk", [(128, 128), (256, 256), (200, 200),
                                  (200, 328)])
def test_flash_kernel_at_mla_widths_matches_plain(cuda, dtype, h, hkv,
                                                  causal, s, sk):
    """DeepSeek's MLA prefill: q/k width 192 (128 no-rotary + 64 rotary
    columns) over v width 128, scale 192^-1/2, against the plain version:
    bf16 by check_bf16, f32 at 1e-5 (the same recurrence over the same
    64-key tiles, sums in another order)."""
    g = torch.Generator(device=cuda).manual_seed(s + sk + h + 192)
    q = torch.randn((2, s, h, 192), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, sk, hkv, 192), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, sk, hkv, 128), generator=g, device=cuda).to(dtype)
    before = kops.launch_counts()["flash_attention"]
    got = kops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kops.launch_counts()["flash_attention"] == before + 1
    assert got.shape == (2, s, h, 128) and got.dtype == dtype
    want = ref.attention(q, k, v, causal=causal, chunk=kv_tile(dtype))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        check_bf16(got, want, "flash attention at (192, 128)")


def test_flash_kernel_at_mla_widths_leaves_its_neighbours_alone(cuda):
    """The (192, 128) output is 128 wide: an output inside a larger buffer
    keeps the bytes past it (the O map stores v's width, not q's)."""
    g = torch.Generator(device=cuda).manual_seed(192)
    q, k = (torch.randn((1, 256, 4, 192), generator=g,
                        device=cuda).bfloat16() for _ in range(2))
    v = torch.randn((1, 256, 4, 128), generator=g, device=cuda).bfloat16()
    out = kops.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert out.shape == (1, 256, 4, 128)
    check_bf16(out, ref.attention(q, k, v, causal=True,
                                  chunk=kv_tile(torch.bfloat16)),
               "(192, 128)")
    from repro_torch.kernels import _build
    buf = torch.full((2 * q.numel(),), 7.0, device=cuda).bfloat16()
    o = buf[:out.numel()].view_as(out)
    err = _build.library().ember_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, 256, 256,
        4, 4, 192, 128, 1, 1, 192 ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(o, out)
    assert bool((buf[out.numel():] == 7.0).all())


def test_bf16_flash_kernel_at_mla_widths_at_prefill_length(cuda):
    """A DeepSeek-V2-Lite layer's shape cut to one sequence of 4096 tokens
    and 4 heads: many ring wrap-arounds of the three-box K stages."""
    g = torch.Generator(device=cuda).manual_seed(4096)
    q, k = (torch.randn((1, 4096, 4, 192), generator=g,
                        device=cuda).bfloat16() for _ in range(2))
    v = torch.randn((1, 4096, 4, 128), generator=g, device=cuda).bfloat16()
    got = kops.attention(q, k, v, causal=True)
    check_bf16(got, ref.attention(q, k, v, causal=True,
                                  chunk=kv_tile(torch.bfloat16)),
               "flash (192, 128) S=4096")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_tile_is_the_kernels_own(cuda, dtype):
    """The checks sum the plain version over kv_tile(dtype) keys: that must
    be the KV tile the built kernel streams."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.sls import DTYPES
    assert _build.library().ember_flash_kv_tile(DTYPES[dtype]) == \
        kv_tile(dtype)


@pytest.mark.parametrize("sq,sk", [(4096, 4096), (4000, 4096), (4000, 4000)])
def test_bf16_flash_kernel_at_prefill_length(cuda, sq, sk):
    """chatglm3's prefill length, with a ragged last q tile (4000 = 31 x
    128 + 32) and a ragged last KV tile: many ring wrap-arounds of the
    K/V stages, and TMA's zero fill past the end of q and k."""
    g = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn((1, sq, 16, 128), generator=g, device=cuda).bfloat16()
    k = torch.randn((1, sk, 1, 128), generator=g, device=cuda).bfloat16()
    v = torch.randn((1, sk, 1, 128), generator=g, device=cuda).bfloat16()
    got = kops.attention(q, k, v, causal=True)
    want = ref.attention(q, k, v, causal=True,
                         chunk=kv_tile(torch.bfloat16))
    check_bf16(got, want, f"flash Sq={sq} Sk={sk}")


def test_bf16_flash_kernel_refuses_unaligned_tensors(cuda):
    """TMA needs 16-byte aligned tensors: a bf16 view one element into
    a buffer is refused by the wrapper, and by the C entry point."""
    from repro_torch.kernels import _build
    flat = torch.randn(1 * 64 * 2 * 64 + 1, device=cuda).bfloat16()
    q = flat[1:].view(1, 64, 2, 64)
    k = torch.randn((1, 64, 2, 64), device=cuda).bfloat16()
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    before = kops.launch_counts()["flash_attention"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        kops.attention(q, k, k)
    assert kops.launch_counts()["flash_attention"] == before
    err = _build.library().ember_flash_attention(
        q.data_ptr(), k.data_ptr(), k.data_ptr(), k.data_ptr(), 1, 64, 64,
        2, 2, 64, 64, 1, 1, 64 ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0


def test_flash_kernel_raises_on_what_it_does_not_take(cuda):
    q = torch.randn((1, 16, 4, 64), device=cuda)
    k = torch.randn((1, 16, 2, 64), device=cuda)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        kops.attention(q, k, k, window=4)
    # (64, 32): a value width with no kernel at that q/k width
    with pytest.raises(ValueError, match="q/k 64, v 32"):
        kops.attention(q, k, torch.randn((1, 16, 2, 32), device=cuda))
    with pytest.raises(ValueError, match="head dims"):
        kops.attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                       k[..., :32].contiguous())


def test_cross_attention_raises_on_the_card(cuda):
    from repro_torch.configs import get_reduced
    from repro_torch.models.attention import attn_forward, init_attn
    cfg = get_reduced("chatglm3-6b")
    p = init_attn(torch.Generator(device=cuda).manual_seed(0), cfg,
                  torch.float32, cuda)
    x = torch.randn((1, 8, cfg.d_model), device=cuda)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        attn_forward(p, x, cfg, positions=torch.arange(8, device=cuda),
                     kv=torch.randn((1, 12, cfg.d_model), device=cuda))


@contextlib.contextmanager
def _attention_through(fn):
    """The model's attention (``kernels.ops.attention``) through ``fn``;
    restored on exit."""
    from repro_torch.kernels import ops as ops_mod
    saved = ops_mod.attention
    ops_mod.attention = fn
    try:
        yield
    finally:
        ops_mod.attention = saved


def _plain_over_kernel_tiles(q, k, v, **kw):
    return ref.attention(q, k, v, **{**kw, "chunk": kv_tile(q.dtype)})


def test_small_lm_prefill_with_the_kernel_matches_plain(cuda):
    """Every layer's kernel output agrees with the plain version on that
    layer's own q, k, v; the last hidden state with a prefill through plain
    attention (bf16 steps amplified by two layers' GEMMs: 5e-2)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(get_reduced("chatglm3-6b"), d_model=512,
                              d_ff=1024, attn_chunk=64, dtype="bfloat16")
    model = LM(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 192), device=cuda)
    kops.reset_launch_counts()
    got = model.prefill(tokens)
    assert kops.launch_counts()["flash_attention"] == cfg.num_layers
    held = []

    def checked(q, k, v, **kw):
        out = kops.flash_attention_cuda(q, k, v, **kw)
        held.append(check_bf16(out, _plain_over_kernel_tiles(q, k, v, **kw),
                               f"layer {len(held)}"))
        return out
    with _attention_through(checked):
        assert torch.equal(model.prefill(tokens), got)
    assert len(held) == cfg.num_layers
    with _attention_through(_plain_over_kernel_tiles):
        want = model.prefill(tokens)
    assert kops.launch_counts()["flash_attention"] == 2 * cfg.num_layers
    torch.testing.assert_close(got, want, rtol=5e-2, atol=5e-2)


def test_head_dim_80_lm_forward_on_the_card_matches_plain(cuda):
    """LM.forward on a head-dim-80 config (stablelm-3b's partial rotary, 8
    heads of 80, bf16) on the card: every layer's kernel output against the
    plain version on that layer's own q, k, v, and the hidden states
    against a forward through plain attention (5e-2, as above)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(get_reduced("stablelm-3b"), d_model=640,
                              num_heads=8, num_kv_heads=8, d_ff=1024,
                              dtype="bfloat16")
    assert cfg.hd == 80
    model = LM(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), device=cuda)
    kops.reset_launch_counts()
    with torch.inference_mode():
        got = model(tokens)
    assert kops.launch_counts()["flash_attention"] == cfg.num_layers
    held = []

    def checked(q, k, v, **kw):
        out = kops.flash_attention_cuda(q, k, v, **kw)
        held.append(check_bf16(out, _plain_over_kernel_tiles(q, k, v, **kw),
                               f"layer {len(held)}"))
        return out
    with _attention_through(checked), torch.inference_mode():
        assert torch.equal(model(tokens), got)
    assert len(held) == cfg.num_layers
    with _attention_through(_plain_over_kernel_tiles), \
            torch.inference_mode():
        want = model(tokens)
    assert got.shape == (2, 200, cfg.d_model)
    torch.testing.assert_close(got, want, rtol=5e-2, atol=5e-2)


# ---------------------------------------------------------------------------
# The serving path: pipeline waves, backends, the reduced LM served
# ---------------------------------------------------------------------------

def _two_table_gather(e):
    from repro_torch.core.ops import EmbeddingOp, EmbeddingProgram
    return EmbeddingProgram(f"wave-{e}", (
        ("g1", EmbeddingOp("gather", 256, 4096, e)),
        ("g2", EmbeddingOp("gather", 256, 4096, e))))


def test_submit_wave_result_waits_for_the_deferred_copy_and_launch(cuda):
    """A torch-backend wave stages its streams and launches at the group's
    flush.  Its handles share ONE event, recorded after the last deferred
    launch: with a long kernel queued first, the handle is not ready after
    submit_wave, result() waits for the copy and the gather, and repacking
    the staging right after result() (more waves through the same pool)
    leaves the step's outputs as they were."""
    from repro_torch.core.executor import ProgramExecutor, pipeline_group
    from repro_torch.core.pipeline import compile_program
    prog = _two_table_gather(1024)
    grp = pipeline_group([ProgramExecutor(
        compile_program(prog, "O3", use_cache=False), backend="torch")],
        n_slots=2)
    g = torch.Generator(device=cuda).manual_seed(0)
    t1 = torch.randn(4096, 1024, generator=g, device=cuda)
    t2 = torch.randn(4096, 1024, generator=g, device=cuda)
    rng = np.random.default_rng(0)

    def wave():
        return {"wave-1024": {n: {"table": t, "idxs": rng.integers(
            0, 4096, 256).astype(np.int32)} for n, t in (("g1", t1),
                                                         ("g2", t2))}}
    grp.submit_wave(wave())["wave-1024"].result()   # pinned buffers made
    w0 = wave()
    torch.cuda._sleep(200_000_000)          # ~0.1 s of a busy stream
    h = grp.submit_wave(w0)["wave-1024"]
    assert not h.deferred and h.event is not None and not h.ready()
    out = h.result()
    snap = {n: t.clone() for n, t in out.items()}
    for _ in range(4):                      # repack every staging slot
        torch.cuda._sleep(50_000_000)
        grp.submit_wave(wave())
    grp.drain()
    for n, t in (("g1", t1), ("g2", t2)):
        idx = torch.from_numpy(w0["wave-1024"][n]["idxs"]).long().to(cuda)
        assert torch.equal(out[n][:, 0], t[idx])
        assert torch.equal(out[n], snap[n])
    assert grp.group_stats()["batched_copies"] == 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e", [5, 4096])
def test_cuda_and_torch_backends_are_bit_equal_on_a_gather_program(
        cuda, dtype, e):
    """A gather is a copy: the hand-written kernel (bulk or rows variant)
    and index_select give the same bits, through step and submit_wave."""
    from repro_torch.core.executor import executor_for, pipeline_group
    prog = _two_table_gather(e)
    g = torch.Generator(device=cuda).manual_seed(e)
    tables = {n: torch.randn(4096, e, generator=g, device=cuda).to(dtype)
              for n in ("g1", "g2")}
    rng = np.random.default_rng(e)
    ins = {n: {"table": t, "idxs": rng.integers(0, 4096, 256).astype(
        np.int32)} for n, t in tables.items()}
    kops.reset_launch_counts()
    got = executor_for(prog, "O3").step(ins)
    assert kops.launch_counts()["block_gather"] == 1
    want = executor_for(prog, "O3", backend="torch").step(ins)
    assert kops.launch_counts()["block_gather"] == 1
    for n in ins:
        assert torch.equal(got[n], want[n]), n
    waves = [pipeline_group([executor_for(prog, "O3", depth=3,
                                          backend=b)]).submit_wave(
        {prog.name: ins})[prog.name].result() for b in ("cuda", "torch")]
    for n in ins:
        assert torch.equal(waves[0][n], waves[1][n]) and \
            torch.equal(waves[0][n], got[n]), n


def test_reduced_lm_served_on_the_card_matches_the_cpu(cuda):
    """The reduced chatglm3 (fp32) served on the card with the decode-embed
    pipeline: every emitted token is the CPU model's argmax on the same
    teacher-forced sequence, or within 1e-4 of its largest logit (an
    argmax tie); the gather ran once a wave."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.lm import LM
    from repro_torch.runtime.server import DecodeServer, Request
    cfg = get_reduced("chatglm3-6b")
    host = LM(cfg, device="cpu", seed=0)
    card = LM(cfg, seed=0)
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in (9, 4, 13, 6, 2)]
    reqs = [Request(prompt=p.copy(), max_new_tokens=8) for p in prompts]
    srv = DecodeServer(card, batch_slots=2, max_len=64, prefill_chunk=4,
                       pipeline=True)
    kops.reset_launch_counts()
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    variants = kops.variant_launch_counts()["block_gather"]
    assert variants["bulk"] == variants["group"] == srv.serve_stats["waves"]
    for p, r in zip(prompts, reqs):
        assert r.status == "ok" and len(r.out) == 8
        caches = host.init_caches(1, 64)
        logits, caches = host.wave_step(p[None], np.array([len(p)]), caches)
        for j, tok in enumerate(r.out):
            lg = logits[0, 0]
            assert float(lg[tok]) >= float(lg.max()) - 1e-4, (j, tok)
            logits, caches = host.wave_step(np.array([[tok]]),
                                            np.array([1]), caches)


def _lockstep(model, prompts, new_tokens, **kw):
    """Serve ``prompts`` through two servers stepped in turn: one replays
    its captured graphs, the other runs the LM's eager wave on its own
    caches.  After every serving iteration the two waves' logits and every
    cache leaf must be the same bits; returns both servers' requests."""
    from repro_torch.runtime.server import DecodeServer, Request, WaveGraph
    graph = DecodeServer(model, **kw)
    eager = DecodeServer(model, **kw)
    assert isinstance(graph._wave, WaveGraph)
    eager._wave, eager._reset = model.wave_step, model.reset_slots
    last = {}
    for name, srv in (("graph", graph), ("eager", eager)):
        wave = srv._wave

        def spy(tokens, lens, caches, wave=wave, name=name):
            logits, caches = wave(tokens, lens, caches)
            last[name] = logits
            return logits, caches
        srv._wave = spy
    reqs = {n: [Request(prompt=p.copy(), max_new_tokens=new_tokens)
                for p in prompts] for n in ("graph", "eager")}
    for n, srv in (("graph", graph), ("eager", eager)):
        for r in reqs[n]:
            srv.submit(r)
    waves = 0
    while graph.queue or any(r is not None for r in graph.active):
        graph.step()
        eager.step()
        waves += 1
        assert torch.equal(last["graph"], last["eager"]), waves
        for cg, ce in zip(graph.caches, eager.caches):
            for k in cg:
                assert torch.equal(cg[k], ce[k]), (waves, k)
    assert not eager.queue and all(r is None for r in eager.active)
    assert graph.serve_stats["waves"] == eager.serve_stats["waves"] == waves
    return reqs["graph"], reqs["eager"]


@pytest.mark.parametrize("arch,over", [
    ("chatglm3-6b", {}), ("chatglm3-6b", {"kv_cache_dtype": "int8"}),
    ("stablelm-3b", {}), ("stablelm-3b", {"dtype": "bfloat16"}),
    ("deepseek-v2-lite-16b", {}),
    ("deepseek-v2-lite-16b", {"dtype": "bfloat16"}),
    ("qwen3-moe-235b-a22b", {})])
def test_graph_served_drive_equals_the_eager_drive_bit_for_bit(cuda, arch,
                                                               over):
    """The captured wave (two mask forms) and slot reset against the eager
    wave on a reduced model: every wave's logits, every cache leaf after
    every serving iteration (resets included), and every emitted token."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.lm import LM
    model = LM(dataclasses.replace(get_reduced(arch), **over), seed=0)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, model.cfg.vocab_size, int(n)).astype(np.int32)
               for n in (9, 4, 13, 6, 2)]
    got, want = _lockstep(model, prompts, 6, batch_slots=2, max_len=48,
                          prefill_chunk=4, pipeline=True)
    for g, w in zip(got, want):
        assert g.status == w.status == "ok" and g.out == w.out


def test_wave_graph_is_built_once_on_the_servers_caches(cuda):
    """The server captures its three graphs at construction on its own
    caches, zeroed after the warm-up, and a wave refuses other caches."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.lm import LM
    from repro_torch.runtime.server import DecodeServer
    model = LM(get_reduced("chatglm3-6b"), seed=0)
    srv = DecodeServer(model, batch_slots=2, max_len=16)
    assert set(srv._wave.graphs) == {"micro-step", "masked micro-step",
                                     "slot reset"}
    assert srv._wave.caches is srv.caches
    assert all(int(t.count_nonzero()) == 0 for c in srv.caches
               for t in c.values())
    with pytest.raises(ValueError, match="caches it was built on"):
        srv._wave(np.array([[1], [2]]), np.array([1, 1]),
                  model.init_caches(2, 16))


# ---------------------------------------------------------------------------
# MoE and MLA on the card
# ---------------------------------------------------------------------------

def _moe_cfg(arch="deepseek-v2-lite-16b", **over):
    from repro_torch.configs import get_reduced
    return dataclasses.replace(get_reduced(arch), **over)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("t", [8, 40])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda, arch, t):
    """fp32 (TF32 off): the same routing (top-k ids, slots) on both
    devices, out and aux at 1e-4 (cuBLAS and the CPU sum the expert
    products in another order); the un-dispatch ran through the block
    gather kernel once."""
    from repro_torch.models import moe as tmoe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_cfg(arch)
    p = tmoe.init_moe(torch.Generator().manual_seed(t), cfg, torch.float32)
    x = torch.randn((t, cfg.d_model), generator=torch.Generator()
                    .manual_seed(t + 1))
    want, waux = tmoe.moe_ffn_local(p, x, cfg)
    before = kops.launch_counts()["block_gather"]
    got, aux = tmoe.moe_ffn_local(_to(p, cuda), x.to(cuda), cfg)
    torch.cuda.synchronize()
    assert kops.launch_counts()["block_gather"] == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), waux, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_undispatch_gather_equals_indexing(cuda, dtype):
    """The MoE un-dispatch ``out_buf[slot]`` through the block gather kernel
    at DeepSeek-V2-Lite's width (2048) is ``out_buf[slot]`` bit for bit,
    slots repeating (clamped dropped assignments) included."""
    from repro_torch.models import moe as tmoe
    g = torch.Generator(device=cuda).manual_seed(6)
    out_buf = torch.randn((64 * 5, 2048), generator=g, device=cuda).to(dtype)
    ids = torch.randint(0, 64, (96,), generator=g, device=cuda)
    ids[:30] = 7                                   # expert 7 overflows
    slot, keep = tmoe._slot_assignments(ids, 64, 5)
    assert not bool(keep.all())
    got = kops.block_gather(out_buf, slot.to(torch.int32))
    torch.cuda.synchronize()
    assert torch.equal(got[:, 0], out_buf[slot])


@pytest.mark.parametrize("masked", [False, True])
def test_mla_block_on_the_card_matches_the_cpu(cuda, masked):
    """An MlaBlock (MLA + MoE FFN, fp32) on the card against the same
    block on the CPU: a forward over 12 tokens (the reduced widths, q/k 24
    and v 16, have no flash kernel, so the card runs the plain attention
    too) and three decode steps; outputs and the latent cache at 1e-4
    (fp32 GEMMs summed in another order), ``len`` exactly."""
    from repro_torch.models.attention import init_mla_cache
    from repro_torch.models.lm import MlaBlock
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_cfg()
    host = MlaBlock(cfg, torch.Generator().manual_seed(1), torch.float32,
                    torch.device("cpu"))
    card = MlaBlock(cfg, None, torch.float32, cuda)
    card.load_state_dict(host.state_dict())
    x = torch.randn((2, 12, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    pos = torch.arange(12, dtype=torch.float32)[None].expand(2, 12)
    want, waux = host(x, pos)
    with _attention_through(_plain_over_kernel_tiles):
        got, aux = card(x.to(cuda), pos.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), waux, rtol=1e-5, atol=1e-6)
    hc = init_mla_cache(cfg, 3, 8, torch.float32)
    cc = init_mla_cache(cfg, 3, 8, torch.float32, cuda)
    for t in range(3):
        xt = torch.randn((3, 1, cfg.d_model), generator=torch.Generator()
                         .manual_seed(10 + t))
        act = torch.tensor([True, t != 1, t == 0]) if masked else None
        want = host.decode(xt, hc, act)
        got = card.decode(xt.to(cuda), cc,
                          None if act is None else act.to(cuda))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        for key in ("c", "kr"):
            torch.testing.assert_close(cc[key].cpu(), hc[key], rtol=1e-4,
                                       atol=1e-4)
        assert torch.equal(cc["len"].cpu(), hc["len"])


def test_mla_lm_prefill_with_the_kernel_matches_plain(cuda):
    """A two-layer bf16 MLA model at DeepSeek-V2-Lite's head widths (4
    heads of q/k 192, v 128; d_model 512, 8 experts): every layer's flash
    output agrees with the plain version on that layer's own q, k, v
    (check_bf16), and the last hidden state with a prefill through plain
    attention (5e-2 relative L2: bf16 steps amplified by two layers)."""
    from repro_torch.models.lm import LM
    cfg = _moe_cfg(d_model=512, num_heads=4, num_kv_heads=4, head_dim=128,
                   rope_head_dim=64, kv_lora_rank=64, moe_d_ff=256,
                   attn_chunk=128, dtype="bfloat16")
    model = LM(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda)
    checked = []

    def held(q, k, v, **kw):
        assert q.shape[-1] == 192 and v.shape[-1] == 128
        out = kops.flash_attention_cuda(q, k, v, **kw)
        checked.append(check_bf16(out, _plain_over_kernel_tiles(q, k, v,
                                                                 **kw),
                                  f"layer {len(checked)}"))
        return out
    kops.reset_launch_counts()
    with _attention_through(held):
        last = model.prefill(tokens)
    assert len(checked) == 2 and kops.launch_counts()["flash_attention"] == 2
    assert kops.launch_counts()["block_gather"] == 2
    with _attention_through(_plain_over_kernel_tiles):
        plain = model.prefill(tokens)
    rel = float((last.float() - plain.float()).norm() / plain.float().norm())
    assert rel <= 5e-2, rel


def test_moe_wave_graph_replays_one_undispatch_gather_a_layer(cuda):
    """A captured MoE micro-step holds one un-dispatch gather a layer.  The
    wrapper counts the warm-up's eager launches and the launches the two
    micro-step captures record; a replay counts nothing, and the device
    trace of a wave shows one bulk gather (and one grouping pass) a layer
    in every replayed micro-step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.lm import LM
    from repro_torch.runtime.server import DecodeServer
    model = LM(_moe_cfg(), seed=0)
    n = model.cfg.num_layers
    kops.reset_launch_counts()
    srv = DecodeServer(model, batch_slots=2, max_len=16)
    assert kops.launch_counts()["block_gather"] == 4 * n
    kops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as tp:
        srv._wave(np.array([[1, 2], [3, 0]]), np.array([2, 1]), srv.caches)
        torch.cuda.synchronize()
    assert kops.launch_counts()["block_gather"] == 0
    names = [e.name() for e in tp.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    assert sum("gather_bulk_kernel" in k for k in names) == 2 * n
    assert sum("group_insert_kernel" in k for k in names) == 2 * n
