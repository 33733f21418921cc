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
from repro_torch.kernels.agreement import bf16_agreement, check_bf16
from repro_torch.kernels.flash_attention import (backward_variant,
                                                 kv_tile, launch_backward,
                                                 plain_backward)

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


def test_disagg_replica_on_the_card_matches_the_inproc_executor(cuda):
    """A one-replica pool on the card (backend "cuda"): the replica's
    outputs of an SLS + gather program are the in-process executor's bits
    on the card, and the replica (its own process) reports its SLS and
    block-gather launches, the card, and no JAX."""
    from repro_torch.convert import program_inputs_to_torch
    from repro_torch.core.executor import executor_for
    from repro_torch.core.ops import (EmbeddingOp, EmbeddingProgram,
                                      make_program_inputs)
    from repro_torch.runtime.embedding_service import ServicePool
    prog = EmbeddingProgram("card_disagg", (
        ("a", EmbeddingOp("sls", 30, 50, 64, avg_lookups=3, weighted=True)),
        ("g1", EmbeddingOp("gather", 25, 60, 64)),
        ("g2", EmbeddingOp("gather", 25, 60, 64)),
    ), shared_tables=(("g1", "g2"),))
    ins = program_inputs_to_torch(make_program_inputs(prog, seed=6))
    want = [executor_for(prog, "O3").step(ins) for _ in range(3)]
    with ServicePool(1, device="cuda", backoff_s=0.01) as pool:
        ex = executor_for(prog, "O3", service="disagg", service_pool=pool)
        got = [ex.step(ins) for _ in range(3)]
        ping = pool.replicas[0].hb.call("ping")[0]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in w:
            assert g[name].device == w[name].device
            assert torch.equal(g[name], w[name]), name
    assert ping["device"] == torch.cuda.get_device_name(0)
    assert ping["launches"]["sls"] == 3
    assert ping["launches"]["block_gather"] == 3
    assert ping["variant_launches"]["block_gather"]["bulk"] == 3
    assert ping["foreign_modules"] == [] and ping["peak_bytes"] > 0


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
                                    1, 0, 96 ** -0.5, None, stream)
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
    want = ref.attention(q, k, v, causal=causal, chunk=kv_tile(dtype, d))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        check_bf16(got, want, "flash attention")


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_bf16_attention_on_the_card_matches_the_cpu(cuda, d, causal):
    """On the card the plain version sums bf16 products on the tensor cores
    (cuBLAS bf16 -> fp32), on the CPU exactly (fp64, rounded to fp32 once,
    the same bits on every host: tests/test_torch_kernels.py): the same
    function, the sums in another order.  A score summed otherwise may
    round a p to the other side of a bf16 step, so a few elements of a
    few-key row may move by more than one step; the share of elements
    differing and the relative L2 hold to check_bf16's bounds.  The card's
    call is made 20 times: the same bits every time (cuBLAS takes one
    algorithm for these shapes), each held to the bounds."""
    from repro_torch.kernels.agreement import (
        BF16_MAX_REL_L2, BF16_MAX_SHARE_DIFFERING, bf16_agreement)
    g = torch.Generator(device=cuda).manual_seed(d + causal)
    q = torch.randn((2, 200, 16, d), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, 328, 1, d), generator=g, device=cuda).bfloat16()
    v = torch.randn((2, 328, 1, d), generator=g, device=cuda).bfloat16()
    chunk = kv_tile(torch.bfloat16, d)
    want = ref.attention(q.cpu(), k.cpu(), v.cpu(), causal=causal,
                         chunk=chunk)
    first = ref.attention(q, k, v, causal=causal, chunk=chunk)
    assert first.dtype == torch.bfloat16 and bool(torch.isfinite(first).all())
    for _ in range(20):
        got = ref.attention(q, k, v, causal=causal, chunk=chunk)
        assert torch.equal(got, first)
        a = bf16_agreement(got.cpu(), want)
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
    want = ref.attention(q, k, v, causal=causal, chunk=kv_tile(dtype, 80))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        check_bf16(got, want, "flash attention at D = 80")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", [(4, 4), (32, 32), (8, 2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,sk", [(128, 128), (200, 200), (200, 328),
                                  (333, 333)])
def test_flash_kernel_at_head_dim_112_matches_plain(cuda, dtype, h, hkv,
                                                    causal, s, sk):
    """zamba2-7b's head dim: the D = 128 kernels on zero-padded columns
    (112-wide tensor maps in bf16, guarded loads in f32), against the plain
    version at the real width, ragged lengths included; one launch a
    call, counted under its instance."""
    g = torch.Generator(device=cuda).manual_seed(s + sk + h + 112)
    q = torch.randn((2, s, h, 112), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, sk, hkv, 112), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, sk, hkv, 112), generator=g, device=cuda).to(dtype)
    before = kops.launch_counts()["flash_attention"]
    key = f"{str(dtype).split('.')[-1]} 112/112" + (" causal" if causal
                                                    else "")
    seen = kops.flash_attention_cuda.instances[key]
    got = kops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kops.launch_counts()["flash_attention"] == before + 1
    assert kops.flash_attention_cuda.instances[key] == seen + 1
    assert got.shape == q.shape
    want = ref.attention(q, k, v, causal=causal, chunk=kv_tile(dtype, 112))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        check_bf16(got, want, "flash attention at D = 112")


def test_flash_kernel_at_head_dim_112_leaves_its_neighbours_alone(cuda):
    """The 112-wide output map stores only the 112 real columns (TMA clips
    the second 64-column box): bytes past the output are kept."""
    from repro_torch.kernels import _build
    g = torch.Generator(device=cuda).manual_seed(112)
    q, k, v = (torch.randn((1, 256, 4, 112), generator=g,
                           device=cuda).bfloat16() for _ in range(3))
    out = kops.attention(q, k, v, causal=True)
    buf = torch.full((2 * out.numel(),), 7.0, device=cuda).bfloat16()
    o = buf[:out.numel()].view_as(out)
    err = _build.library().ember_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, 256, 256,
        4, 4, 112, 112, 1, 1, 0, 112 ** -0.5, None,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(o, out)
    assert bool((buf[out.numel():] == 7.0).all())


def test_flash_backward_refuses_head_dim_112_before_any_launch(cuda):
    """The backward at (112, 112) is not written (ROADMAP.md, K1): the
    wrapper refuses it before a launch, on a direct call and under
    autograd (there before the forward runs), and the C entry returns an
    error without launching."""
    from repro_torch.kernels import _build
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((1, 128, 2, 112), generator=g,
                           device=cuda).bfloat16() for _ in range(3))
    out, lse = kops.flash_attention_cuda(q, k, v, return_lse=True)
    fwd = kops.launch_counts()["flash_attention"]
    bwd = kops.backward_launch_counts()["flash_attention_bwd"]
    with pytest.raises(NotImplementedError, match="K1"):
        kops.flash_attention_bwd_cuda(q, k, v, out, out, lse)
    with pytest.raises(NotImplementedError, match="K1"):
        kops.attention(q.requires_grad_(True), k, v)
    assert kops.launch_counts()["flash_attention"] == fwd
    assert kops.backward_launch_counts()["flash_attention_bwd"] == bwd
    lib = _build.library()
    rows = torch.empty((1, 2, 2, lib.ember_flash_bwd_rows(128)),
                       device=cuda)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for variant in (0, 1):
        err = lib.ember_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            out.data_ptr(), lse.data_ptr(), rows.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), 1, 128, 128, 2, 2, 112, 112, 1, 1,
            0, 112 ** -0.5, variant, torch.cuda.current_stream().cuda_stream)
        assert err != 0


def test_flash_kernel_at_head_dim_80_leaves_its_neighbours_alone(cuda):
    """The 80-wide output map stores only the 80 real columns: a view of
    q, k, v and o inside larger buffers keeps the bytes past each tensor."""
    g = torch.Generator(device=cuda).manual_seed(80)
    q, k, v = (torch.randn((1, 256, 4, 80), generator=g,
                           device=cuda).bfloat16() for _ in range(3))
    out = kops.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    check_bf16(out, ref.attention(q, k, v, causal=True,
                                  chunk=kv_tile(torch.bfloat16, 80)),
               "D = 80")
    from repro_torch.kernels import _build
    buf = torch.full((2 * out.numel(),), 7.0, device=cuda).bfloat16()
    o = buf[:out.numel()].view_as(out)
    err = _build.library().ember_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, 256, 256,
        4, 4, 80, 80, 1, 1, 0, 80 ** -0.5, None,
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
    want = ref.attention(q, k, v, causal=causal, chunk=kv_tile(dtype, 192))
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
                                  chunk=kv_tile(torch.bfloat16, 192)),
               "(192, 128)")
    from repro_torch.kernels import _build
    buf = torch.full((2 * q.numel(),), 7.0, device=cuda).bfloat16()
    o = buf[:out.numel()].view_as(out)
    err = _build.library().ember_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, 256, 256,
        4, 4, 192, 128, 1, 1, 0, 192 ** -0.5, None,
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
                                  chunk=kv_tile(torch.bfloat16, 192)),
               "flash (192, 128) S=4096")


def _held(got, q, k, v, what, **kw):
    """The kernel's output against the plain version over its own tiles:
    f32 at 1e-5 (the same recurrence, sums in another order), bf16 by
    check_bf16."""
    want = _plain_over_kernel_tiles(q, k, v, **kw)
    if q.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        check_bf16(got, want, what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 4), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,sk", [(64, 64), (128, 128), (200, 200),
                                  (200, 328)])
def test_flash_kernel_at_head_dim_256_matches_plain(cuda, dtype, h, hkv,
                                                    causal, s, sk):
    """gemma3-4b's heads: q/k and v width 256, on 64-key K/V tiles in bf16
    (two stages of 128-key tiles would not fit shared memory)."""
    g = torch.Generator(device=cuda).manual_seed(s + sk + h + 256)
    q = torch.randn((2, s, h, 256), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, sk, hkv, 256), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, sk, hkv, 256), generator=g, device=cuda).to(dtype)
    before = kops.launch_counts()["flash_attention"]
    got = kops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kops.launch_counts()["flash_attention"] == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    _held(got, q, k, v, "flash attention at (256, 256)", causal=causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [80, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 100, 128, 129, 299])
def test_flash_kernel_with_a_window_matches_plain(cuda, dtype, d, causal,
                                                  window):
    """The sliding-window band (q - k < window): windows that are and are
    not a multiple of either KV tile, over a ragged 300 keys (q tiles whose
    first visited KV tile holds rows with no key in their band), and 200
    queries over 328 keys."""
    g = torch.Generator(device=cuda).manual_seed(d + window + causal)
    for s, sk in ((300, 300), (200, 328)):
        q = torch.randn((2, s, 8, d), generator=g, device=cuda).to(dtype)
        k = torch.randn((2, sk, 2, d), generator=g, device=cuda).to(dtype)
        v = torch.randn((2, sk, 2, d), generator=g, device=cuda).to(dtype)
        before = dict(kops.flash_attention_cuda.instances)
        got = kops.attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        key = f"{str(dtype)[6:]} {d}/{d}{' causal' if causal else ''}"
        if window < s:        # a window of Sq or more runs as none
            key += f" window {window}"
        assert kops.flash_attention_cuda.instances[key] == \
            before.get(key, 0) + 1
        _held(got, q, k, v, f"window {window} Sq={s} Sk={sk}",
              causal=causal, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [80, 256])
def test_flash_kernel_window_of_sk_or_more_is_no_window(cuda, dtype, d):
    """A window of Sk or more masks nothing: the bits of no window."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn((1, 200, 4, d), generator=g,
                           device=cuda).to(dtype) for _ in range(3))
    for causal in (True, False):
        none = kops.attention(q, k, v, causal=causal)
        for window in (200, 201, 10 ** 6):
            assert torch.equal(kops.attention(q, k, v, causal=causal,
                                              window=window), none)


def test_flash_kernel_with_a_window_of_one_returns_v(cuda):
    """A window of 1 keeps only the diagonal: p = 1, so each output row is
    its own value row, to the bit."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((1, 300, 4, 256), generator=g,
                           device=cuda).bfloat16() for _ in range(3))
    assert torch.equal(kops.attention(q, k, v, causal=True, window=1), v)


@pytest.mark.parametrize("d,window", [(256, 1024), (80, 4096)])
def test_bf16_flash_kernel_with_a_window_at_prefill_length(cuda, d, window):
    """gemma3-4b's local layer (head dim 256, window 1024) and
    h2o-danube-1.8b's (head dim 80, window 4096) cut to a few heads, at a
    length where the band skips most KV tiles."""
    g = torch.Generator(device=cuda).manual_seed(window)
    s = 2 * window + 300
    q = torch.randn((1, s, 4, d), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((1, s, 2, d), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    got = kops.attention(q, k, v, causal=True, window=window)
    _held(got, q, k, v, f"flash D={d} window {window} S={s}", causal=True,
          window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 112, 128, 192, 256])
def test_kv_tile_is_the_kernels_own(cuda, dtype, d):
    """The checks sum the plain version over kv_tile(dtype, d) keys: that
    must be the KV tile the built kernel streams at that q/k width."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.sls import DTYPES
    assert _build.library().ember_flash_kv_tile(DTYPES[dtype], d) == \
        kv_tile(dtype, d)


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
                         chunk=kv_tile(torch.bfloat16, 128))
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
        2, 2, 64, 64, 1, 1, 0, 64 ** -0.5, None,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0


def test_flash_kernel_raises_on_what_it_does_not_take(cuda):
    q = torch.randn((1, 16, 4, 64), device=cuda)
    k = torch.randn((1, 16, 2, 64), device=cuda)
    before = kops.launch_counts()["flash_attention"]
    for window in (0, -3):
        with pytest.raises(ValueError, match="window must be positive"):
            kops.attention(q, k, k, window=window)
    # rows 8.. of 16 queries over 4 keys keep no key of a window of 5
    with pytest.raises(ValueError, match="keep no key"):
        kops.attention(q, k[:, :4].contiguous(), k[:, :4].contiguous(),
                       window=5)
    assert kops.launch_counts()["flash_attention"] == before
    # (64, 32): a value width with no kernel at that q/k width
    with pytest.raises(ValueError, match="q/k 64, v 32"):
        kops.attention(q, k, torch.randn((1, 16, 2, 32), device=cuda))
    with pytest.raises(ValueError, match="head dims"):
        kops.attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                       k[..., :32].contiguous())


#: whisper's cross-attention shapes (B, Sq, Sk): a decode step's one query
#: row over 1500 frames (the first launch below one 128-row q tile), a few
#: rows, the prefill's 1500 over 1500 (the last KV tile 92 keys), and one
#: key
CROSS_SHAPES = [(8, 1, 1500), (2, 5, 1500), (2, 1500, 1500), (3, 1, 1),
                (2, 200, 1500)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk", CROSS_SHAPES)
def test_cross_attention_kernel_matches_plain(cuda, dtype, b, sq, sk):
    """Non-causal attention at whisper's head dim 64 (20 heads, MHA) with
    Sq != Sk, the kernel against the plain version over the kernel's own
    KV tiles: check_bf16 for bf16, 1e-5 for f32.  The output is written
    into a larger buffer through the C entry as well: nothing past its
    Sq rows is touched (the Q and O tensor maps' 64-row boxes are larger
    than the tensor at Sq < 64)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.sls import DTYPES
    g = torch.Generator(device=cuda).manual_seed(b + sq + sk)
    q, k, v = (torch.randn((b, n, 20, 64), generator=g, device=cuda).to(dtype)
               for n in (sq, sk, sk))
    before = kops.launch_counts()["flash_attention"]
    got = kops.attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert kops.launch_counts()["flash_attention"] == before + 1
    want = ref.attention(q, k, v, causal=False, chunk=kv_tile(dtype, 64))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        check_bf16(got, want, f"cross attention {b}x{sq} over {sk}")
    n = got.numel()
    buf = torch.full((n + 64 * 20 * 64,), 7.0, device=cuda, dtype=dtype)
    err = _build.library().ember_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(), b, sq, sk,
        20, 20, 64, 64, DTYPES[dtype], 0, 0, 64 ** -0.5, None,
        torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(buf[:n].view_as(got), got)
    assert bool((buf[n:] == 7).all())


def test_cross_attention_layer_on_the_card_matches_the_cpu(cuda):
    """attn_forward(kv=) on the card -- the xdec layers' cross-attention,
    K and V projected from the encoder's output, the flash kernel at Sq =
    12 and at Sq = 1 (a decode step) over 40 frames -- against the same
    call on the CPU, f32, 1e-5 (no cross-attention raises any more)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.attention import attn_forward, init_attn
    cfg = dataclasses.replace(get_reduced("whisper-large-v3"), d_model=256)
    assert cfg.hd == 64
    p = init_attn(torch.Generator().manual_seed(0), cfg, torch.float32)
    kv = torch.randn((2, 40, cfg.d_model))
    for s in (12, 1):
        x = torch.randn((2, s, cfg.d_model))
        before = kops.launch_counts()["flash_attention"]
        got = attn_forward({n: w.to(cuda) for n, w in p.items()}, x.to(cuda),
                           cfg, positions=None, causal=False, kv=kv.to(cuda))
        assert kops.launch_counts()["flash_attention"] == before + 1
        want = attn_forward(p, x, cfg, positions=None, causal=False, kv=kv)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_flash_backward_at_whisper_length(cuda, causal):
    """The wgmma backward at (64, 64) over whisper's 1500 frames (the last
    KV tile 92 keys), causal (the decoder) and not (the encoder): against
    plain_backward by check_bf16, and bit-equal twice."""
    q, k, v, dout = _bwd_inputs(cuda, torch.bfloat16, 1, 1500, 1500, 20, 20,
                                64, 64, 15)
    o, lse = kops.flash_attention_cuda(q, k, v, causal=causal,
                                       return_lse=True)
    got = kops.flash_attention_bwd_cuda(q, k, v, o, dout, lse, causal=causal)
    again = kops.flash_attention_bwd_cuda(q, k, v, o, dout, lse,
                                          causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = plain_backward(q, k, v, o, dout, lse, causal=causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        check_bf16(a, w, f"whisper-length backward {name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_take_gradient_on_the_card_is_deterministic(cuda, dtype):
    """The token embedding's gradient on the card (embedding_engine.Take:
    one ember_sls launch over the transposed lookups) on heavily repeated
    ids: bit-equal over two calls, and held to the CPU's (index_add_ in
    fp32): 1e-5 for f32, check_bf16 for bf16; the forward is
    index_select's bits."""
    from repro_torch.core import embedding_engine as ee
    rng = np.random.default_rng(11)
    table = torch.from_numpy(rng.standard_normal((5000, 256)).astype(
        np.float32)).to(dtype)
    ids = torch.from_numpy(rng.integers(0, 300, (4, 1500)))
    dout = torch.from_numpy(rng.standard_normal((4, 1500, 256)).astype(
        np.float32)).to(dtype)

    def grad(dev):
        t = table.to(dev, copy=True).requires_grad_(True)
        out = ee.lookup(t, ids.to(dev), strategy="take")
        out.backward(dout.to(dev))
        return out.detach(), t.grad

    kops.reset_launch_counts()
    out, got = grad(cuda)
    assert kops.backward_launch_counts()["block_gather_bwd"] == 1
    assert kops.launch_counts()["sls"] == 1
    assert torch.equal(out, table.to(cuda)[ids.to(cuda)])
    assert torch.equal(grad(cuda)[1], got)
    want = grad("cpu")[1]
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    else:
        check_bf16(got.cpu(), want, "take gradient")


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
    return ref.attention(q, k, v,
                         **{**kw, "chunk": kv_tile(q.dtype, q.shape[3])})


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


def test_gemma3_like_lm_forward_on_the_card_matches_plain(cuda):
    """LM.forward on a gemma3-like config (five dense_local layers with a
    100-token window and a dense one, 2 heads of 256 over 1 KV head, bf16)
    on the card: the local layers launch the windowed (256, 256) kernel,
    the global one the causal one; every layer's kernel output against the
    plain version on its own q, k, v, and the hidden states against a
    forward through plain attention (5e-2, as above)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(get_reduced("gemma3-4b"), num_layers=6,
                              d_model=512, num_heads=2, num_kv_heads=1,
                              head_dim=256, d_ff=1024, sliding_window=100,
                              dtype="bfloat16")
    model = LM(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 300), device=cuda)
    kops.reset_launch_counts()
    with torch.inference_mode():
        got = model(tokens)
    assert dict(kops.flash_attention_cuda.instances) == {
        "bfloat16 256/256 causal window 100": 5,
        "bfloat16 256/256 causal": 1}
    held = []

    def checked(q, k, v, **kw):
        out = kops.flash_attention_cuda(q, k, v, **kw)
        held.append(kw.get("window"))
        _held(out, q, k, v, f"layer {len(held)}", **kw)
        return out
    with _attention_through(checked), torch.inference_mode():
        assert torch.equal(model(tokens), got)
    assert held == [100] * 5 + [None]
    with _attention_through(_plain_over_kernel_tiles), \
            torch.inference_mode():
        want = model(tokens)
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


def test_reduced_zamba2_at_head_dim_112_served_on_the_card_matches_the_cpu(
        cuda):
    """The reduced zamba2 widened to d_model 448 (4 heads of 112, the full
    model's head dim; fp32) served on the card through the captured wave
    (the mamba decode and the shared attention in its graphs): every
    emitted token is the CPU model's argmax on the same teacher-forced
    sequence, or within 1e-4 of its largest logit; the gather ran once a
    wave; a prefill at head dim 112 (the two shared_attn layers'
    flash launches) agrees with the CPU's at 1e-4."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.lm import LM
    from repro_torch.runtime.server import DecodeServer, Request, WaveGraph
    cfg = dataclasses.replace(get_reduced("zamba2-7b"), d_model=448,
                              d_ff=512)
    assert cfg.hd == 112
    host = LM(cfg, device="cpu", seed=0)
    card = LM(cfg, seed=0)
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in (9, 4, 13, 6, 2)]
    reqs = [Request(prompt=p.copy(), max_new_tokens=8) for p in prompts]
    srv = DecodeServer(card, batch_slots=2, max_len=64, prefill_chunk=4,
                       pipeline=True)
    assert isinstance(srv._wave, WaveGraph)
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
    # the prefill at head dim 112 through the flash kernel
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    before = kops.flash_attention_cuda.instances["float32 112/112 causal"]
    got = card.prefill(tokens.cuda())
    assert kops.flash_attention_cuda.instances["float32 112/112 causal"] == \
        before + 2
    torch.testing.assert_close(got.cpu(), host.prefill(tokens), rtol=1e-4,
                               atol=1e-4)


def test_reduced_xlstm_on_the_card_matches_the_cpu(cuda):
    """The reduced xlstm (fp32; 3 mlstm and 1 slstm layers, d_model 64)
    from one set of weights on the card and on the CPU: the forward over
    2 x 40 tokens (chunks of 8) at 1e-4; six decode steps of 3 slots, one
    of them masked, the logits and every cache leaf (``C``, ``n``; ``h``,
    ``c``, ``n``, ``m``) at 1e-4; the mLSTM's fp32 gates within 2e-5 of
    the CPU's with TF32 allowed for the caller (the gates turn it off
    around their product and restore the flag); and a drive served
    through the captured wave, whose every token is the CPU model's argmax
    on the same teacher-forced sequence or within 1e-4 of its largest
    logit, the gather once a wave."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import xlstm
    from repro_torch.models.lm import LM
    from repro_torch.runtime.server import DecodeServer, Request, WaveGraph
    cfg = get_reduced("xlstm-1.3b")
    host = LM(cfg, device="cpu", seed=0)
    card = LM(cfg, seed=0)
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    torch.testing.assert_close(card(tokens.cuda()).cpu(), host(tokens),
                               rtol=1e-4, atol=1e-4)
    tc, hc = card.init_caches(3, 16), host.init_caches(3, 16)
    for t in range(6):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1)))
        active = torch.tensor([True, t != 2, True])
        kw = dict(active=active) if t in (2, 4) else {}
        gl, tc = card.decode_step(tok.cuda(), tc, **{
            k: v.cuda() for k, v in kw.items()})
        hl, hc = host.decode_step(tok, hc, **kw)
        torch.testing.assert_close(gl.cpu(), hl, rtol=1e-4, atol=1e-4)
        for cg, ch in zip(tc, hc):
            assert cg.keys() == ch.keys()
            for k in cg:
                assert cg[k].dtype == ch[k].dtype
                torch.testing.assert_close(cg[k].cpu(), ch[k], rtol=1e-4,
                                           atol=1e-4, msg=k)
    x = torch.from_numpy(rng.standard_normal((2, 40, cfg.d_model)).astype(
        np.float32))
    p_host = host.blocks[0].mlstm
    want = xlstm._mlstm_gates(p_host, x)
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = xlstm._mlstm_gates(card.blocks[0].mlstm, x.cuda())
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=2e-5, atol=2e-5)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in (9, 4, 13, 6, 2)]
    reqs = [Request(prompt=p.copy(), max_new_tokens=8) for p in prompts]
    srv = DecodeServer(card, batch_slots=2, max_len=64, prefill_chunk=4,
                       pipeline=True)
    assert isinstance(srv._wave, WaveGraph)
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
    ("zamba2-7b", {}), ("zamba2-7b", {"dtype": "bfloat16"}),
    ("xlstm-1.3b", {}), ("xlstm-1.3b", {"dtype": "bfloat16"}),
    ("deepseek-v2-lite-16b", {}),
    ("deepseek-v2-lite-16b", {"dtype": "bfloat16"}),
    ("qwen3-moe-235b-a22b", {}),
    ("gemma3-4b", {}), ("gemma3-4b", {"dtype": "bfloat16"}),
    ("h2o-danube-1.8b", {}), ("llava-next-34b", {})])
def test_graph_served_drive_equals_the_eager_drive_bit_for_bit(cuda, arch,
                                                               over):
    """The captured wave (two mask forms) and slot reset against the eager
    wave on a reduced model: every wave's logits, every cache leaf after
    every serving iteration (resets included), and every emitted token.
    The dense_local models' window of 8 is passed by the 9- and 13-token
    prompts and by every request's decode: their windowed micro-steps are
    captured too."""
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
    with _attention_through(ref.attention):
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
    attention (5e-2 relative L2: bf16 steps amplified by two layers).  The
    plain prefill's MoE routing is pinned to the kernel prefill's (each
    layer's top-k experts, weighted by the plain prefill's own
    probabilities), as chip_smoke.py's phase 9 pins it: a bf16 step of
    attention flips near-tie routing decisions of random weights
    (ROADMAP.md, reference caveat (d)), and a flipped expert moves the
    hidden state past any bf16 bound.  The tokens come from a seeded
    generator."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.lm import LM
    cfg = _moe_cfg(d_model=512, num_heads=4, num_kv_heads=4, head_dim=128,
                   rope_head_dim=64, kv_lora_rank=64, moe_d_ff=256,
                   attn_chunk=128, dtype="bfloat16")
    model = LM(cfg, seed=0)
    gen = torch.Generator(device=cuda).manual_seed(1480)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda,
                           generator=gen)
    route = moe_mod.route
    routing = []

    def recorded(x2d, router, k):
        probs, topw, tope = route(x2d, router, k)
        routing.append(tope)
        return probs, topw, tope

    def pinned(x2d, router, k):
        probs, _, _ = route(x2d, router, k)
        tope = routing[pinned.layer]
        pinned.layer += 1
        topw = probs.gather(-1, tope)
        return probs, topw / topw.sum(-1, keepdim=True).clamp_min(1e-9), \
            tope
    pinned.layer = 0
    checked = []

    def held(q, k, v, **kw):
        assert q.shape[-1] == 192 and v.shape[-1] == 128
        out = kops.flash_attention_cuda(q, k, v, **kw)
        checked.append(check_bf16(out, _plain_over_kernel_tiles(q, k, v,
                                                                 **kw),
                                  f"layer {len(checked)}"))
        return out
    kops.reset_launch_counts()
    try:
        moe_mod.route = recorded
        with _attention_through(held):
            last = model.prefill(tokens)
        assert len(checked) == 2 and \
            kops.launch_counts()["flash_attention"] == 2
        assert kops.launch_counts()["block_gather"] == 2
        moe_mod.route = pinned
        with _attention_through(_plain_over_kernel_tiles):
            plain = model.prefill(tokens)
    finally:
        moe_mod.route = route
    assert len(routing) == pinned.layer == 2
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


# ---------------------------------------------------------------------------
# The backward: flash attention's kernels and the block gather's gradient
# ---------------------------------------------------------------------------

def _bwd_inputs(cuda, dtype, b, s, sk, h, hkv, d, dv, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, sk, hkv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, sk, hkv, dv), generator=g, device=cuda).to(dtype)
    dout = torch.randn((b, s, h, dv), generator=g, device=cuda).to(dtype)
    return q, k, v, dout


def _hold_grads(got, want, dtype, what):
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        if dtype == torch.float32:
            # fp32 sums of up to ~1000 products in another order
            torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4,
                                       msg=f"{what} {name}")
        else:
            check_bf16(a, w, f"{what} {name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv", [(64, 64), (80, 80), (128, 128),
                                  (192, 128), (256, 256)])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("s,window", [(200, None), (200, 37), (200, 128),
                                      (333, 128), (1000, 300)])
def test_flash_backward_kernel_matches_plain(cuda, dtype, d, dv, h, hkv, s,
                                             window):
    """The backward kernels (the lse/delta rows, dK/dV, dQ) of the variant
    ``backward_variant`` picks -- wgmma for bf16 at (64, 64), (80, 80),
    (128, 128), SIMT otherwise -- against its plain version
    (``plain_backward``: P and dS rounded to bf16 for wgmma) on the same q,
    k, v, o, dout and lse, causal, at every (q/k, v) width pair, GQA groups
    1, 4 and 8, with and without the band, over ragged lengths (200, 333
    and 1000 tokens: many q and KV tiles, the band's edge crossing them);
    the forward's lse against the plain version's."""
    q, k, v, dout = _bwd_inputs(cuda, dtype, 2, s, s, h, hkv, d, dv,
                                d + h + (window or 0))
    o, lse = kops.flash_attention_cuda(q, k, v, window=window,
                                       return_lse=True)
    _, lse_plain = ref.attention(q, k, v, window=window,
                                 chunk=kv_tile(dtype, d), return_lse=True)
    torch.testing.assert_close(lse, lse_plain, rtol=1e-5, atol=1e-5)
    variant = backward_variant(dtype, d, dv)
    assert variant == ("wgmma" if dtype == torch.bfloat16 and d <= 128
                       else "simt")
    before = kops.variant_launch_counts()["flash_attention_bwd"]
    got = kops.flash_attention_bwd_cuda(q, k, v, o, dout, lse,
                                        window=window)
    torch.cuda.synchronize()
    after = kops.variant_launch_counts()["flash_attention_bwd"]
    assert after == {**before, variant: before[variant] + 1}
    want = plain_backward(q, k, v, o, dout, lse, window=window)
    _hold_grads(got, want, dtype, f"flash backward {variant} {d}/{dv}")


@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 37),
                                           (False, None)])
def test_flash_backward_simt_variant_matches_plain_in_bf16(cuda, d, causal,
                                                           window):
    """The SIMT kernels still take bf16 at the wgmma widths (launched
    through the wrapper's own launch path, as chip_smoke.py times them):
    against the fp32-P plain version; and the wgmma variant on the same
    inputs against its own, both within check_bf16."""
    q, k, v, dout = _bwd_inputs(cuda, torch.bfloat16, 2, 200, 200, 8, 2, d,
                                d, 7 * d)
    o, lse = kops.flash_attention_cuda(q, k, v, causal=causal,
                                       window=window, return_lse=True)
    for variant in ("simt", "wgmma"):
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        launch_backward(variant, q, k, v, o, dout, lse, grads, causal=causal,
                        window=window or 0)
        want = plain_backward(q, k, v, o, dout, lse, causal=causal,
                              window=window, variant=variant)
        _hold_grads(grads, want, torch.bfloat16, f"{variant} at {d}")


def test_wgmma_flash_backward_refuses_what_it_does_not_take(cuda):
    """The wgmma variant raises on unaligned tensors (TMA) and, through its
    launch path, on f32 and widths past 128: nothing gives way to SIMT."""
    q, k, v, dout = _bwd_inputs(cuda, torch.bfloat16, 1, 64, 64, 2, 2, 64,
                                64, 1)
    o, lse = kops.flash_attention_cuda(q, k, v, return_lse=True)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    q_odd = buf[1:].view(q.shape).copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kops.flash_attention_bwd_cuda(q_odd, k, v, o, dout, lse)
    qf, kf, vf, of, df = (t.float() for t in (q, k, v, o, dout))
    with pytest.raises(RuntimeError, match="wgmma"):
        launch_backward("wgmma", qf, kf, vf, of, df, lse,
                        tuple(torch.empty_like(t) for t in (qf, kf, vf)),
                        causal=True, window=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv", [(64, 64), (80, 80), (128, 128),
                                  (256, 256)])
@pytest.mark.parametrize("h,hkv", [(2, 2), (4, 2)])
def test_flash_backward_kernel_with_a_window_of_one(cuda, dtype, d, dv, h,
                                                    hkv):
    """A window of one key: each row attends to itself alone, P = 1 and
    o = v, so dS = do.v - do.o = 0 -- dq and dk are 0 up to the fp32
    rounding of two sums of the same products, held by absolute value (no
    relative measure holds there; GQA sums a group's zeros into dk) --
    and dv = dout summed over the KV head's group.  With a group, that
    fp32 sum of bf16 values often lies on a bf16 tie: the wgmma variant
    takes P as bf16, exactly 1, and rounds the tie as the plain sum does
    (check_bf16); the SIMT one multiplies by an fp32 P of 1 +- an ulp,
    which tips the tie either way, so there dv is held within one bf16
    step of the sum elementwise."""
    q, k, v, dout = _bwd_inputs(cuda, dtype, 2, 200, 200, h, hkv, d, dv, 1)
    o, lse = kops.flash_attention_cuda(q, k, v, window=1, return_lse=True)
    dq, dk, dv_got = kops.flash_attention_bwd_cuda(q, k, v, o, dout, lse,
                                                   window=1)
    assert float(dq.abs().max()) < 1e-5 and float(dk.abs().max()) < 1e-5
    want = dout.float().view(2, 200, hkv, h // hkv, dv).sum(3)
    if dtype == torch.float32:
        torch.testing.assert_close(dv_got, want, rtol=1e-5, atol=1e-5)
    elif h == hkv or backward_variant(dtype, d, dv) == "wgmma":
        check_bf16(dv_got, want.to(dtype), "flash backward dv at window 1")
    else:
        assert bf16_agreement(dv_got, want.to(dtype))["worst"] <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,sk", [(128, 128), (200, 328)])
@pytest.mark.parametrize("window", [None, 100])
def test_flash_backward_kernel_not_causal_matches_plain(cuda, dtype, d, s,
                                                        sk, window):
    """Not causal, with and without a band of 100 keys (q - k < 100, keys
    past the row kept)."""
    q, k, v, dout = _bwd_inputs(cuda, dtype, 2, s, sk, 8, 2, d, d, s + d)
    o, lse = kops.flash_attention_cuda(q, k, v, causal=False, window=window,
                                       return_lse=True)
    got = kops.flash_attention_bwd_cuda(q, k, v, o, dout, lse, causal=False,
                                        window=window)
    want = plain_backward(q, k, v, o, dout, lse, causal=False,
                          window=window)
    _hold_grads(got, want, dtype, "non-causal flash backward")


@pytest.mark.parametrize("window", [None, 4096])
def test_bf16_flash_backward_at_training_length(cuda, window):
    """h2o-danube-1.8b's attention at one 8192-token sequence: 32 heads
    over 8 KV heads at head dim 80, the band of its 4096-token window."""
    q, k, v, dout = _bwd_inputs(cuda, torch.bfloat16, 1, 8192, 8192, 32, 8,
                                80, 80, 5)
    o, lse = kops.flash_attention_cuda(q, k, v, window=window,
                                       return_lse=True)
    got = kops.flash_attention_bwd_cuda(q, k, v, o, dout, lse,
                                        window=window)
    want = plain_backward(q, k, v, o, dout, lse, window=window)
    _hold_grads(got, want, torch.bfloat16, "danube-sized flash backward")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_flash_backward_is_deterministic(cuda, dtype, d):
    q, k, v, dout = _bwd_inputs(cuda, dtype, 2, 300, 300, 8, 2, d, d, 3)
    o, lse = kops.flash_attention_cuda(q, k, v, window=100, return_lse=True)
    first = kops.flash_attention_bwd_cuda(q, k, v, o, dout, lse, window=100)
    second = kops.flash_attention_bwd_cuda(q, k, v, o, dout, lse, window=100)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv", [(80, 80), (128, 128), (192, 128),
                                  (256, 256)])
@pytest.mark.parametrize("window", [None, 100])
def test_flash_forward_bits_do_not_depend_on_the_lse_output(cuda, dtype, d,
                                                           dv, window):
    q, k, v, _ = _bwd_inputs(cuda, dtype, 2, 300, 300, 8, 2, d, dv, d)
    plain_out = kops.flash_attention_cuda(q, k, v, window=window)
    out, lse = kops.flash_attention_cuda(q, k, v, window=window,
                                         return_lse=True)
    assert torch.equal(out, plain_out)
    assert lse.shape == (2, 8, 300) and bool(torch.isfinite(lse).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_function_matches_the_cpu(cuda, dtype):
    """kops.attention under autograd on the card (FlashAttention: the
    kernels) against the same call on the CPU (the plain versions)."""
    q, k, v, dout = _bwd_inputs(cuda, dtype, 2, 150, 150, 8, 2, 64, 64, 9)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        out = kops.attention(*leaves, window=70)
        out.backward(dout.to(dev))
        grads.append([out.detach().cpu()] +
                     [t.grad.cpu() for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **({} if dtype == torch.float32
                                            else dict(rtol=5e-2, atol=5e-2)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_rows", [1, 4])
@pytest.mark.parametrize("emb", [5, 64, 2048])
def test_block_gather_backward_on_sls_matches_index_add(cuda, dtype,
                                                        block_rows, emb):
    rng = np.random.default_rng(emb + block_rows)
    n_blocks, g = 50, 300
    idxs = torch.from_numpy(rng.integers(0, n_blocks // 2, g)
                            .astype(np.int32)).to(cuda)   # duplicates
    roff = torch.from_numpy(rng.integers(0, 3, g).astype(np.int32)).to(cuda)
    dout = torch.from_numpy(rng.standard_normal((g, block_rows, emb))
                            .astype(np.float32)).to(cuda, dtype)
    kops.reset_launch_counts()
    got = kops.block_gather_backward(dout, idxs, n_blocks * block_rows,
                                     block_rows=block_rows, roff=roff)
    torch.cuda.synchronize()
    assert kops.backward_launch_counts()["block_gather_bwd"] == 1
    assert kops.backward_launch_counts()["gather_transpose"] == 1
    assert kops.launch_counts()["sls"] == 1
    # 300 lookups into 50 blocks: more lookups than segments, the rows kernel
    assert kops.variant_launch_counts()["sls"] == {"rows": 1, "sparse": 0}
    want = ref.block_gather_backward(dout, idxs, n_blocks * block_rows,
                                     block_rows=block_rows, roff=roff)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        check_bf16(got, want, "block gather backward")
    again = kops.block_gather_backward(dout, idxs, n_blocks * block_rows,
                                       block_rows=block_rows, roff=roff)
    assert torch.equal(got, again)


def _block_ids(rng, kind, n_tbl, g):
    """g block ids below n_tbl: one id repeated (padding or EOS), all
    distinct, the last id among uniform ones, a Zipf(1.1) head."""
    if kind == "hot":
        return np.full(g, min(7, n_tbl - 1), np.int32)
    if kind == "distinct":
        return rng.permutation(n_tbl)[:g].astype(np.int32)
    if kind == "last":
        ids = rng.integers(0, n_tbl, g)
        ids[::3] = n_tbl - 1
        return ids.astype(np.int32)
    return (np.minimum(rng.zipf(1.1, g), n_tbl) - 1).astype(np.int32)


@pytest.mark.parametrize("kind,n_tbl,g,with_roff", [
    ("hot", 50, 300, False), ("hot", 32000, 8192, False),
    ("distinct", 5000, 5000, False), ("last", 1000, 777, False),
    ("zipf", 32000, 8192, False), ("zipf", 51968, 1500, False),
    ("zipf", 2568, 2048, True), ("last", 9, 1, False), ("hot", 12, 0, False),
    ("zipf", 256, 4000, False),                 # one radix pass
    ("zipf", 262144, 8192, False),              # three passes, one block
    ("last", 70000, 8193, True),                # the tiled passes
    ("hot", 122944, 98304, False), ("zipf", 122944, 98304, False),
    ("distinct", 160000, 98304, True),
])
def test_transposition_kernel_equals_the_argsort_path(cuda, kind, n_tbl, g,
                                                      with_roff):
    """ember_transpose's order and ptrs are the stable argsort + bincount
    path's, element for element, on the streams a token stream produces,
    at every size class of the kernel (one block of 2 to 8 items a thread,
    tiled passes past 8,192) and one to three radix passes."""
    from repro_torch.kernels.gather import transposed_lookups
    rng = np.random.default_rng(g + n_tbl)
    roff = None
    span = n_tbl
    if with_roff:
        span = n_tbl - n_tbl // 3
        roff = torch.from_numpy(rng.integers(0, n_tbl // 3, g).astype(
            np.int32)).to(cuda)
    idxs = torch.from_numpy(_block_ids(rng, kind, span, g)).to(cuda)
    kops.reset_launch_counts()
    order, ptrs = transposed_lookups(idxs, roff, n_tbl)
    torch.cuda.synchronize()
    assert kops.backward_launch_counts()["gather_transpose"] == (g > 0)
    want_order, want_ptrs = ref.transposed_lookups(idxs, roff, n_tbl)
    assert torch.equal(order, want_order)
    assert torch.equal(ptrs, want_ptrs)


def _parent_backward(dout, idxs, num_rows, block_rows, roff):
    """The block gather's backward as the parent commit composed it: the
    argsort transposition and one launch of sls_kernel (the rows
    variant)."""
    from repro_torch.kernels.sls import launch_variant
    g, _, emb = dout.shape
    n_tbl = num_rows // block_rows
    order, ptrs = ref.transposed_lookups(idxs, roff, n_tbl)
    rows = dout.reshape(g, block_rows * emb).contiguous()
    out = torch.empty((n_tbl, block_rows * emb), dtype=dout.dtype,
                      device=dout.device)
    launch_variant("rows", rows, ptrs, order, out)
    return out.view(num_rows, emb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("emb", [5, 64, 2048, 2560])
@pytest.mark.parametrize("block_rows", [1, 4])
@pytest.mark.parametrize("with_roff", [False, True])
@pytest.mark.parametrize("stream", ["sparse", "hot", "dense"])
def test_block_gather_backward_equals_the_parent_composition(
        cuda, dtype, emb, block_rows, with_roff, stream):
    """The backward through the transposition kernel and the SLS variant
    kernel_variant picks is torch.equal to the argsort path plus
    sls_kernel: a Zipf stream over more blocks than lookups (the sparse
    variant where rows are whole 16-byte units), a hot id over as many, and
    more lookups than blocks (the rows kernel)."""
    from repro_torch.kernels.sls import kernel_variant
    rng = np.random.default_rng(emb + block_rows + 7 * with_roff)
    n_tbl, g = {"sparse": (600, 400), "hot": (600, 600),
                "dense": (50, 300)}[stream]
    span = n_tbl - n_tbl // 3 if with_roff else n_tbl
    idxs = _block_ids(rng, "zipf" if stream != "hot" else "hot", span, g)
    if stream == "hot":
        idxs[::4] = rng.integers(0, span, len(idxs[::4]))
    roff = torch.from_numpy(rng.integers(0, n_tbl // 3, g).astype(
        np.int32)).to(cuda) if with_roff else None
    idxs = torch.from_numpy(idxs).to(cuda)
    dout = torch.from_numpy(rng.standard_normal((g, block_rows, emb))
                            .astype(np.float32)).to(cuda, dtype)
    num_rows = n_tbl * block_rows
    kops.reset_launch_counts()
    got = kops.block_gather_backward(dout, idxs, num_rows,
                                     block_rows=block_rows, roff=roff)
    torch.cuda.synchronize()
    variant = kernel_variant("sls", block_rows * emb, dout.element_size(),
                             True, num_segments=n_tbl, lookups=g,
                             plain_sum=True)
    want_variants = {"rows": 0, "sparse": 0}
    want_variants[variant] = 1
    assert kops.variant_launch_counts()["sls"] == want_variants
    assert kops.backward_launch_counts()["gather_transpose"] == 1
    assert torch.equal(got, _parent_backward(dout, idxs, num_rows,
                                             block_rows, roff))


def test_block_gather_backward_gives_one_result_over_twenty_calls(cuda):
    """A hot Zipf head at danube's token embedding width, bf16: twenty
    calls, one result, the parent composition's."""
    rng = np.random.default_rng(20)
    n_tbl, g = 32000, 8192
    idxs = torch.from_numpy(_block_ids(rng, "zipf", n_tbl, g)).to(cuda)
    dout = torch.from_numpy(rng.standard_normal((g, 1, 2560)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    first = kops.block_gather_backward(dout, idxs, n_tbl)
    for _ in range(19):
        assert torch.equal(kops.block_gather_backward(dout, idxs, n_tbl),
                           first)
    assert torch.equal(first, _parent_backward(dout, idxs, n_tbl, 1, None))


def test_sparse_sls_variant_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.sls import launch_variant
    table = torch.randn((8, 16), device=cuda)
    ptrs = torch.tensor([0, 2, 2, 4], dtype=torch.int32, device=cuda)
    idxs = torch.tensor([1, 3, 0, 7], dtype=torch.int32, device=cuda)
    out = torch.empty((3, 16), device=cuda)
    with pytest.raises(ValueError, match="sparse"):
        launch_variant("sparse", table, ptrs, idxs, out,
                       torch.ones(4, device=cuda))
    with pytest.raises(RuntimeError, match="ember_sls"):   # 20-byte rows
        launch_variant("sparse", torch.randn((8, 5), device=cuda), ptrs,
                       idxs, torch.empty((3, 5), device=cuda))
    launch_variant("sparse", table, ptrs, idxs, out)
    assert torch.equal(out, ref.sls(table, ptrs, idxs, num_segments=3))


def test_block_gather_function_gives_the_table_its_gradient(cuda):
    table = torch.randn((40, 16), device=cuda, requires_grad=True)
    idxs = torch.tensor([3, 3, 7, 0, 39, 3], dtype=torch.int32, device=cuda)
    out = kops.block_gather(table, idxs)
    out.sum().backward()
    want = torch.zeros(40, 16, device=cuda)
    want[3], want[7], want[0], want[39] = 3, 1, 1, 1
    assert torch.equal(table.grad, want)


def test_kernels_under_autograd_without_their_function_raise(cuda):
    q = torch.randn((1, 64, 2, 64), device=cuda, requires_grad=True)
    k = torch.randn((1, 64, 2, 64), device=cuda)
    with pytest.raises(RuntimeError, match="autograd"):
        kops.flash_attention_cuda(q, k, k)
    table = torch.randn((8, 16), device=cuda, requires_grad=True)
    idxs = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="autograd"):
        kops.block_gather_cuda(table, idxs)
    ptrs = torch.tensor([0, 4], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="autograd"):
        kops.sls(table, ptrs, idxs, num_segments=1)
    with torch.no_grad():          # no gradient wanted: the kernel runs
        assert kops.flash_attention_cuda(q, k, k).shape == (1, 64, 2, 64)


# ---------------------------------------------------------------------------
# Training on the card
# ---------------------------------------------------------------------------

#: reduced configs of every ported kind, widened to a head width the flash
#: kernel takes (the reduced ones have heads of 8 or 16); f32
TRAIN_CONFIGS = [
    ("stablelm-3b", dict(d_model=256, num_heads=4, num_kv_heads=4)),
    ("chatglm3-6b", dict(d_model=256, num_heads=4, num_kv_heads=2)),
    ("h2o-danube-1.8b", dict(d_model=320, num_heads=4, num_kv_heads=2)),
    ("gemma3-4b", dict(d_model=256, num_heads=2, num_kv_heads=1,
                       head_dim=256)),
    ("deepseek-v2-lite-16b", dict(d_model=256, num_heads=2, num_kv_heads=2,
                                  head_dim=128, rope_head_dim=64,
                                  kv_lora_rank=64)),
    ("qwen3-moe-235b-a22b", dict(d_model=256, num_heads=4, num_kv_heads=2)),
    ("llava-next-34b", dict(d_model=256, num_heads=4, num_kv_heads=2)),
    ("whisper-large-v3", dict(d_model=256, num_heads=4, num_kv_heads=4)),
    ("zamba2-7b", dict(d_model=256, num_heads=4, num_kv_heads=4)),
    ("xlstm-1.3b", dict(d_model=256, num_heads=4, num_kv_heads=4)),
]


def _attention_layers(cfg) -> int:
    """Flash launches a forward: a decoder layer's self-attention (every
    kind but the recurrent ones), an xdec layer's cross-attention besides,
    an encoder layer's."""
    from repro_torch.models.lm import layer_kinds
    kinds = layer_kinds(cfg)
    recurrent = sum(kinds.count(k) for k in ("mamba", "mlstm", "slstm"))
    return len(kinds) - recurrent + kinds.count("xdec") + cfg.enc_layers


@pytest.mark.parametrize("arch,over", TRAIN_CONFIGS)
def test_reduced_training_on_the_card_matches_the_cpu(cuda, tmp_path, arch,
                                                      over):
    """Three trainer steps from the same weights on the card (the flash
    kernels and their backward, the MoE un-dispatch gather and its
    ember_sls backward, the token embedding's gradient on ember_sls) and
    on the CPU (the plain versions): the losses at 1e-4 relative; the
    parameters after the steps within 1e-3 (AdamW's normalised step can
    turn a gradient of ~0 either way: a few lr)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.lm import LM, has_moe
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_reduced(arch), d_ff=256, **over)
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=24, global_batch=2,
        modality=cfg.modality, d_model=cfg.d_model))
    outs = []
    kops.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        model = LM(cfg, device="cpu", seed=4).to(dev)
        outs.append(Trainer(model, data, TrainerConfig(
            total_steps=3, ckpt_every=100,
            ckpt_dir=str(tmp_path / dev))).run())
    counts = kops.backward_launch_counts()
    assert counts["flash_attention_bwd"] == 3 * _attention_layers(cfg)
    # the un-dispatch gathers' and, once a step, the token embedding's
    assert counts["block_gather_bwd"] == 3 * (
        cfg.num_layers if has_moe(cfg) else 0) + 3
    np.testing.assert_allclose(outs[1]["losses"], outs[0]["losses"],
                               rtol=1e-4)
    for k, p in outs[0]["state"]["params"].items():
        torch.testing.assert_close(outs[1]["state"]["params"][k].cpu(), p,
                                   rtol=1e-3, atol=1e-3, msg=k)


def test_bf16_logits_gradient_is_the_transposed_product(cuda):
    """The bf16 logits on the card (cuBLAS bf16 x bf16 -> fp32, through
    Bf16Logits under autograd): dx = (dl @ table) and dtable = (dl^T @ x),
    each summed in fp32 and cast to bf16 once, against the same products
    in fp64."""
    from repro_torch.core.embedding_engine import logits
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn((3, 50, 64), generator=g, device=cuda).bfloat16()
    table = torch.randn((300, 64), generator=g, device=cuda).bfloat16()
    dl = torch.randn((3, 50, 300), generator=g, device=cuda)
    x.requires_grad_()
    table.requires_grad_()
    out = logits(x, table)
    assert out.dtype == torch.float32 and out.grad_fn is not None
    out.backward(dl)
    with torch.no_grad():
        want_dx = (dl.double() @ table.double()).bfloat16()
        want_dt = (dl.double().reshape(-1, 300).t() @
                   x.double().reshape(-1, 64)).bfloat16()
    check_bf16(x.grad, want_dx, "logits dx")
    check_bf16(table.grad, want_dt, "logits dtable")


@pytest.mark.parametrize("arch,over", [TRAIN_CONFIGS[2], TRAIN_CONFIGS[4]])
def test_reduced_bf16_training_on_the_card_matches_the_cpu(cuda, tmp_path,
                                                           arch, over):
    """The same three steps in bf16, the model's training dtype: the card's
    bf16 paths (the wgmma forward, the backward kernels on bf16, the
    logits' Bf16Logits transpose) against the CPU's plain versions; the
    losses at 1e-2 relative (bf16 rounds at other places on each)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.lm import LM
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_reduced(arch), d_ff=256, dtype="bfloat16",
                              **over)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=24,
                                      global_batch=2))
    losses = []
    for dev in ("cpu", "cuda"):
        model = LM(cfg, device="cpu", seed=4).to(dev)
        losses.append(Trainer(model, data, TrainerConfig(
            total_steps=3, ckpt_every=100,
            ckpt_dir=str(tmp_path / dev))).run()["losses"])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-2)


# ---------------------------------------------------------------------------
# The vocab-sharded executor on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards,cap,nseg", [(2, 1, 3), (2, 64, 40),
                                             (2, 4096, 2048),
                                             (4, 1024, 777),
                                             (2, 131072, 53248)])
def test_lattice_rebuild_on_the_card_equals_the_plain_one(cuda, shards, cap,
                                                          nseg):
    """The collective exchange's received lattice (segment ids with the
    pad sentinel ``nseg``) rebuilt into a local CSR by ``ember_transpose``:
    order and ptrs equal to the plain transposition's, and the pool over
    it equal to the plain pool over the unsorted lattice."""
    from repro_torch.core import shard_plan as sp
    from repro_torch.kernels.gather import transposed_lookups
    rng = np.random.default_rng(cap + nseg)
    fill = rng.integers(0, cap + 1, shards)       # valid slots per source
    segs = np.full((shards, cap), nseg, np.int32)
    for s, n in enumerate(fill):
        segs[s, :n] = np.sort(rng.integers(0, nseg, n))
    rows = 97
    idxs = rng.integers(0, rows, (shards, cap)).astype(np.int32)
    segs_t = torch.from_numpy(segs.reshape(-1)).to(cuda)
    idxs_t = torch.from_numpy(idxs.reshape(-1)).to(cuda)
    before = kops.backward_launch_counts()["gather_transpose"]
    order, ptrs = transposed_lookups(segs_t, None, nseg + 1)
    assert kops.backward_launch_counts()["gather_transpose"] == before + 1
    p_order, p_ptrs = ref.transposed_lookups(segs_t, None, nseg + 1)
    assert torch.equal(order, p_order) and torch.equal(ptrs, p_ptrs)
    assert int(ptrs[nseg]) == int(fill.sum())     # sentinels sort last
    table = torch.from_numpy(rng.standard_normal((rows, 64))
                             .astype(np.float32)).to(cuda)
    roff = torch.zeros(nseg, dtype=torch.int32, device=cuda)
    for add_op in ("add", "max"):
        got, counts = sp._local_pool_csr(
            table, roff, ptrs[:nseg + 1], idxs_t.index_select(0, order),
            None, backend="cuda", add_op=add_op, mul_op="mul", nseg=nseg)
        want, want_counts = ref.segment_pool(table, segs_t, idxs_t, None,
                                             num_segments=nseg,
                                             add_op=add_op)
        assert torch.equal(counts, want_counts)
        if add_op == "add":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-4)
        else:
            assert torch.equal(got, want)


def _two_ranks_on_the_card(rank: int, world: int) -> dict:
    """Two gloo ranks sharing cuda:0 run a small mixed program through the
    sharded executor in both exchanges and placements; returns each
    config's worst error against the numpy oracle, its staged bytes and
    the kernel launches."""
    from repro_torch.convert import program_inputs_to_torch
    from repro_torch.core.executor import ProgramExecutor
    from repro_torch.core.ops import (EmbeddingOp, EmbeddingProgram,
                                      Semiring, make_program_inputs,
                                      program_reference)
    from repro_torch.core.pipeline import compile_program
    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.set_device(0)
    mesh = make_host_mesh(world)
    prog = EmbeddingProgram("card-mixed", (
        ("w", EmbeddingOp("sls", 50, 90, 96, avg_lookups=3, weighted=True)),
        ("u", EmbeddingOp("sls", 40, 70, 96, avg_lookups=2)),
        ("k", EmbeddingOp("kg", 60, 110, 96)),
        ("g1", EmbeddingOp("gather", 60, 200, 96)),
        ("g2", EmbeddingOp("gather", 60, 200, 96)),
        ("mx", EmbeddingOp("sls", 30, 40, 128, avg_lookups=3,
                           semiring=Semiring("max"))),
    ), shared_tables=(("g1", "g2"),))
    host = make_program_inputs(prog, seed=0)
    ins = program_inputs_to_torch(host, "cuda")
    want = program_reference(prog, host)
    pres = compile_program(prog, "O3", use_cache=False)
    out = {}
    for exchange in ("host", "collective"):
        for repl in (True, False):
            kops.reset_launch_counts()
            ex = ProgramExecutor(pres, mesh=mesh, exchange=exchange,
                                 replicate_outputs=repl,
                                 hot_rows={"g1": (0, 1, 2), "u": (3,)})
            got = ex.full_outputs(ex.step(ins))
            torch.cuda.synchronize()
            out[f"{exchange}/{int(repl)}"] = {
                "err": max(float(np.abs(got[n].cpu().numpy().reshape(
                    w.shape) - w).max()) for n, w in want.items()),
                "staged": ex.stats["staged_bytes"],
                "launches": dict(kops.launch_counts()),
                "transposes": kops.backward_launch_counts()[
                    "gather_transpose"]}
    return out


def test_two_gloo_ranks_share_the_card(cuda):
    from repro_torch.launch.mesh import run_ranks
    for res in run_ranks(_two_ranks_on_the_card, 2, timeout_s=300):
        for tag, r in res.items():
            assert r["err"] < 1e-4, (tag, r)
            assert r["staged"] > 0, tag          # gloo: staged through host
            assert r["launches"]["sls"] > 0 and \
                r["launches"]["block_gather"] > 0, (tag, r)
            if tag.startswith("collective"):
                assert r["transposes"] > 0, (tag, r)


def _masked_lookup_ranks(rank: int, world: int) -> dict:
    """Two gloo ranks sharing cuda:0, each holding half the rows of a bf16
    table, run the three vocab-sharded lookup strategies; the masked ones
    gather through the block gather kernel."""
    from repro_torch.core import embedding_engine as ee
    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.set_device(0)
    mesh = make_host_mesh(world)
    table, ids = _lookup_case()
    rows = table.shape[0] // world
    local = table[rank * rows:(rank + 1) * rows].to("cuda")
    ids = ids.to("cuda")
    out = {}
    for s in ("masked_psum", "masked_psum_scatter", "one_hot"):
        before = kops.launch_counts()["block_gather"]
        got = ee.lookup(local, ids, mesh=mesh, vocab_axis="model",
                        strategy=s)
        out[s] = (got.float().cpu().numpy(),
                  kops.launch_counts()["block_gather"] - before)
    return out


def _lookup_case():
    rng = np.random.default_rng(29)
    table = torch.from_numpy(rng.standard_normal((1024, 128))
                             .astype(np.float32)).to(torch.bfloat16)
    ids = torch.from_numpy(rng.integers(0, 1024, (2, 64)))
    return table, ids


def test_masked_lookup_on_two_gloo_ranks_matches_the_cpu(cuda):
    """The vocab-sharded lookups on the card equal the CPU's
    ``index_select`` bit for bit on both ranks (a row's one owner adds
    exact zeros from the other); the masked strategies launch the block
    gather once each."""
    from repro_torch.launch.mesh import run_ranks
    table, ids = _lookup_case()
    want = table[ids].float().numpy()
    for rank, res in enumerate(run_ranks(_masked_lookup_ranks, 2,
                                         timeout_s=300)):
        for s, (got, launches) in res.items():
            w = want[:, rank * 32:(rank + 1) * 32] \
                if s == "masked_psum_scatter" else want
            np.testing.assert_array_equal(got, w, err_msg=f"{s} {rank}")
            assert launches == (0 if s == "one_hot" else 1), s


def _tp_cfg():
    """chatglm3-6b's widths (32 heads of 128 over 2 KV heads, d_ff 13696,
    vocab 65024, bf16) at two layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("chatglm3-6b"), num_layers=2)


def _tp_forward_ranks(rank: int, world: int) -> dict:
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM, ShardCtx
    torch.cuda.set_device(0)
    mesh = make_host_mesh(world)
    model = LM(_tp_cfg(), seed=0, shard=ShardCtx(mesh))
    kops.reset_launch_counts()
    last = model.prefill(_tp_tokens().to("cuda"))
    return {"last": last.float().cpu().numpy(),
            "flash": kops.launch_counts()["flash_attention"],
            "gather": kops.launch_counts()["block_gather"],
            "collectives": model.collective_stats["collectives"]}


def _tp_tokens():
    return torch.from_numpy(np.random.default_rng(31).integers(
        0, 65024, (2, 128)))


def test_two_layer_chatglm3_width_tp_forward_matches_the_single_device(cuda):
    """Two gloo ranks on the card each run half the heads and half the MLP
    of a two-layer chatglm3-6b-width model (one KV head a rank: GQA at 16
    query heads a KV head); the last hidden state equals the single
    device's within 5e-2 relative L2 (bf16) on both ranks, the ranks
    agree bit for bit, and each rank launched the flash kernel once a
    layer and the block gather once (the masked embed lookup)."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.lm import LM
    model = LM(_tp_cfg(), seed=0)
    want = model.prefill(_tp_tokens().to(cuda)).float().cpu()
    del model
    torch.cuda.empty_cache()
    res = run_ranks(_tp_forward_ranks, 2, timeout_s=600)
    np.testing.assert_array_equal(res[0]["last"], res[1]["last"])
    for r in res:
        got = torch.from_numpy(r["last"])
        rel = float((got - want).norm() / want.norm())
        assert rel <= 5e-2, rel
        assert r["flash"] == 2 and r["gather"] == 1
        # the embed lookup, and a row-parallel sum after each attention and MLP
        assert r["collectives"] == 1 + 2 * 2


def _axis_function_ranks(rank: int, world: int) -> dict:
    """Two gloo ranks sharing cuda:0: the model axis's differentiable sum,
    enter, gather and scatter (forward and backward) on CUDA tensors, and
    a bf16 row-parallel product's backward on the rank's columns of h and
    rows of w."""
    from repro_torch.core.shard_plan import model_axis
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import row_parallel
    torch.cuda.set_device(0)
    mesh = make_host_mesh(world)
    ax = model_axis(mesh, "model", "cuda")
    x = torch.from_numpy(_axis_x(rank)).cuda().requires_grad_()
    out = {}
    for name, fn in (("sum", ax.sum), ("enter", ax.enter),
                     ("gather", lambda t: ax.gather(t, 1)),
                     ("scatter", lambda t: ax.scatter(t, 0))):
        y = fn(x)
        cot = torch.from_numpy(_axis_cot(tuple(y.shape))).cuda()
        (dx,) = torch.autograd.grad(y, x, cot)
        out[name] = (y.detach().cpu().numpy(), dx.cpu().numpy())
    h, w, dout = _row_case()
    k = h.shape[1] // world
    hr = h[:, rank * k:(rank + 1) * k].cuda().requires_grad_()
    wr = w[rank * k:(rank + 1) * k].cuda().requires_grad_()
    y = row_parallel(hr, wr, ax)
    y.backward(dout.cuda())
    out["row"] = tuple(t.detach().float().cpu().numpy()
                       for t in (y, hr.grad, wr.grad))
    out["staged"] = ax.stats["staged_bytes"]
    return out


def _axis_x(rank: int) -> np.ndarray:
    return np.random.default_rng(41 + rank).standard_normal(
        (4, 6)).astype(np.float32)


def _axis_cot(shape: tuple) -> np.ndarray:
    return np.random.default_rng(43).standard_normal(shape).astype(
        np.float32)


def _row_case() -> tuple:
    rng = np.random.default_rng(47)
    h, w, dout = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16) for s in ((256, 512), (512, 384),
                                                   (256, 384)))
    return h, w, dout


def test_axis_functions_and_row_parallel_backward_on_two_ranks(cuda):
    """The differentiable collectives on the card (two gloo ranks, staged
    through the host): sum's backward is the identity, enter's the sum of
    the ranks' cotangents, gather's the rank's block, scatter's the
    gathered cotangent; and ``row_parallel``'s written-out backward (fp32
    sums, one rounding) gives each rank the single device's bf16 dh
    columns and dw rows within 1e-2 relative L2, its forward the single
    device's product."""
    from repro_torch.launch.mesh import run_ranks
    res = run_ranks(_axis_function_ranks, 2, timeout_s=300)
    xs = [_axis_x(r) for r in range(2)]
    for r, got in enumerate(res):
        assert got["staged"] > 0
        y, dx = got["sum"]
        np.testing.assert_allclose(y, xs[0] + xs[1], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(dx, _axis_cot((4, 6)))
        y, dx = got["enter"]
        np.testing.assert_array_equal(y, xs[r])
        np.testing.assert_allclose(dx, 2 * _axis_cot((4, 6)), rtol=1e-6)
        y, dx = got["gather"]
        np.testing.assert_array_equal(y, np.concatenate(xs, 1))
        np.testing.assert_array_equal(dx, _axis_cot((4, 12))[:,
                                                            6 * r:6 * r + 6])
        y, dx = got["scatter"]
        np.testing.assert_allclose(y, (xs[0] + xs[1])[2 * r:2 * r + 2],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(dx, np.concatenate(
            [_axis_cot((2, 6))] * 2))
    h, w, dout = (t.to(cuda).requires_grad_() for t in _row_case())
    y = h @ w
    y.backward(dout)
    want = (y, h.grad, w.grad)
    k = h.shape[1] // 2

    def rel(a, b):
        b = b.detach().float().cpu()
        return float((torch.from_numpy(a) - b).norm() / b.norm())
    for r, got in enumerate(res):
        gy, gdh, gdw = got["row"]
        assert rel(gy, want[0]) <= 1e-2
        assert rel(gdh, want[1][:, r * k:(r + 1) * k]) <= 1e-2
        assert rel(gdw, want[2][r * k:(r + 1) * k]) <= 1e-2
    np.testing.assert_array_equal(res[0]["row"][0], res[1]["row"][0])


def _ep_train_ranks(rank: int, world: int, arch: str, seq: int,
                    device: str) -> dict:
    """Two gloo ranks (sharing cuda:0, or on the CPU), each holding its
    slices of the CPU-seeded single-device weights: the reduced fp32 MoE
    config's ``TrainStep.loss_and_grads`` over a (1, 2) mesh -- the
    expert-parallel backward (the all-to-alls' transposes on seq-split, the
    dispatch buffer's sum on replicated tokens, the whole leaves' gradient
    sums) -- with the launches it made."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import local_leaf
    from repro_torch.models.lm import LM, ShardCtx
    from repro_torch.runtime.trainer import TrainStep
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    over = dict(TRAIN_CONFIGS)[arch]
    cfg = dataclasses.replace(get_reduced(arch), d_ff=256, **over)
    mesh = make_host_mesh(world, device=device)
    lm = LM(cfg, device=device, seed=4, shard=ShardCtx(mesh))
    # the same weights on both devices: the CPU generator's, sliced
    full = LM(cfg, device="cpu", seed=4).state_dict()
    lm.load_state_dict({k: local_leaf(v, k, cfg, world, rank).to(device)
                        for k, v in full.items()})
    st = TrainStep(lm, 2, seq)
    rng = np.random.default_rng(31)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
             for k in ("tokens", "labels")}
    kops.reset_launch_counts()
    loss, grads = st.loss_and_grads(st.init_state()["params"],
                                    st.local_batch(batch))
    return {"loss": float(loss),
            "grads": {k: g.detach().cpu().numpy() for k, g in grads.items()},
            "bwd": dict(kops.backward_launch_counts()),
            "staged": lm.collective_stats["staged_bytes"]}


#: the largest relative L2 of one leaf's gradient on one rank, two card
#: ranks against two CPU ranks, in the reduced MoE loss's backward: above
#: the sound runs' readings (at most 4.63e-6 over the four cases on an
#: NVIDIA H100 80GB HBM3) and below the smallest a planted fault gives
#: (1.91e-2: the aux term's gradient dropped, qwen3-moe on seq-split; one
#: entry's sum over the axis skipped -- the router's, the shared
#: experts', MLA's latent projections', the replicated-token dispatch
#: buffer's -- reads 0.78-1.0)
EP_GRAD_REL_L2 = 1e-4


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    """||got - want|| / ||want|| (0 where both are zero)."""
    return float(np.linalg.norm(got - want) /
                 max(float(np.linalg.norm(want)), 1e-30))


@pytest.mark.parametrize("seq", [48, 47], ids=["seq_split", "replicated"])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_reduced_moe_loss_backward_on_two_ranks_matches_the_cpu(cuda, arch,
                                                                seq):
    """The reduced MoE loss's backward over two gloo ranks on the card (the
    flash backward, the un-dispatch gather's backward through the
    transposition and the sparse sum, the staged all-to-alls and sums)
    against the same two ranks on the CPU (the plain versions): the loss
    at 1e-4 relative, every rank's gradient of every leaf within
    EP_GRAD_REL_L2 relative L2 (printed: the largest); the card's ranks
    made the kernels' backward launches and staged their collectives; no
    expert leaf's gradient is zero."""
    from repro_torch.launch.mesh import run_ranks
    got = run_ranks(_ep_train_ranks, 2, (arch, seq, "cuda"), timeout_s=600)
    want = run_ranks(_ep_train_ranks, 2, (arch, seq, "cpu"), timeout_s=600)
    rel = {}
    for r, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        assert g["staged"] > 0 and w["staged"] == 0
        assert g["bwd"]["flash_attention_bwd"] > 0
        assert g["bwd"]["block_gather_bwd"] > 0 and \
            g["bwd"]["gather_transpose"] > 0
        for k, v in w["grads"].items():
            rel[f"rank {r} {k}"] = _rel_l2(g["grads"][k], v)
            if ".moe." in k:
                assert np.any(g["grads"][k]), (r, k)
    worst = max(rel, key=rel.get)
    print(f"{arch} S={seq}: the largest gradient relative L2 "
          f"{rel[worst]:.3g} ({worst})")
    assert rel[worst] <= EP_GRAD_REL_L2, (worst, rel[worst])


#: reduced zamba2 at a width the flash backward takes: 8 heads of 64,
#: ssm_state 16, ``mamba, mamba, shared_attn`` twice, fp32
ZAMBA_TRAIN_CONFIG = dict(d_model=512, num_heads=8, num_kv_heads=8,
                          ssm_state=16, d_ff=1024, num_layers=6)


def _zamba_train_ranks(rank: int, world: int, device: str) -> dict:
    """Two gloo ranks (sharing cuda:0, or on the CPU), each holding its
    slices of the CPU-seeded single-device weights of
    ZAMBA_TRAIN_CONFIG: ``TrainStep.loss_and_grads`` over a (1, 2) mesh --
    each mamba layer's scan on the rank's 4 SSM heads, its input and B | C
    entering the rank, the shared attention on its 4 heads -- with the
    launches it made."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import local_leaf
    from repro_torch.models.lm import LM, ShardCtx
    from repro_torch.runtime.trainer import TrainStep
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_reduced("zamba2-7b"), **ZAMBA_TRAIN_CONFIG)
    mesh = make_host_mesh(world, device=device)
    lm = LM(cfg, device=device, seed=4, shard=ShardCtx(mesh))
    full = LM(cfg, device="cpu", seed=4).state_dict()
    lm.load_state_dict({k: local_leaf(v, k, cfg, world, rank).to(device)
                        for k, v in full.items()})
    st = TrainStep(lm, 2, 48)
    rng = np.random.default_rng(37)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
             for k in ("tokens", "labels")}
    kops.reset_launch_counts()
    loss, grads = st.loss_and_grads(st.init_state()["params"],
                                    st.local_batch(batch))
    return {"loss": float(loss),
            "grads": {k: g.detach().cpu().numpy() for k, g in grads.items()},
            "fwd": dict(kops.launch_counts()),
            "bwd": dict(kops.backward_launch_counts()),
            "staged": lm.collective_stats["staged_bytes"]}


def test_reduced_zamba2_loss_backward_on_two_ranks_matches_the_cpu(cuda):
    """zamba2 trained over two gloo ranks on the card at a kernel width
    (the flash forward and backward on the shared attention's rank heads,
    the masked lookup's gather and its backward, the staged sums of each
    mamba layer's input and B | C gradients) against the same two ranks on
    the CPU: the loss at 1e-4 relative, every rank's gradient of every
    leaf within EP_GRAD_REL_L2 relative L2 (printed: the largest), the
    B | C columns' gradients the same bits on both card ranks; the card's
    ranks made the kernels' launches and staged their collectives."""
    from repro_torch.launch.mesh import run_ranks
    got = run_ranks(_zamba_train_ranks, 2, ("cuda",), timeout_s=600)
    want = run_ranks(_zamba_train_ranks, 2, ("cpu",), timeout_s=600)
    rel = {}
    for r, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        assert g["staged"] > 0 and w["staged"] == 0
        assert g["fwd"]["flash_attention"] > 0 and \
            g["fwd"]["block_gather"] > 0
        assert g["bwd"]["flash_attention_bwd"] > 0
        assert g["bwd"]["block_gather_bwd"] > 0 and \
            g["bwd"]["gather_transpose"] > 0
        for k, v in w["grads"].items():
            rel[f"rank {r} {k}"] = _rel_l2(g["grads"][k], v)
    # a rank's w_in: its x and z (d_inner / 2 = d_model columns each),
    # then B | C
    ns, di = ZAMBA_TRAIN_CONFIG["ssm_state"], ZAMBA_TRAIN_CONFIG["d_model"]
    bc = slice(2 * di, 2 * di + 2 * ns)
    for k in [k for k in got[0]["grads"] if k.endswith("mamba.w_in")]:
        np.testing.assert_array_equal(got[0]["grads"][k][:, bc],
                                      got[1]["grads"][k][:, bc])
    worst = max(rel, key=rel.get)
    print(f"zamba2: the largest gradient relative L2 {rel[worst]:.3g} "
          f"({worst})")
    assert rel[worst] <= EP_GRAD_REL_L2, (worst, rel[worst])


# ---------------------------------------------------------------------------
# The dry run's lowering options on the card
# ---------------------------------------------------------------------------

#: a dense and an MoE config at a head width the kernels take (the MoE one
#: runs the un-dispatch gather and its backward in every layer)
REMAT_CONFIGS = [TRAIN_CONFIGS[1], TRAIN_CONFIGS[5]]


@pytest.mark.parametrize("arch,over", REMAT_CONFIGS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_remat_is_bit_equal_through_the_kernels(cuda, arch, over, dtype):
    """``ShardCtx.remat`` "dots" and "full" on the card: the loss and every
    gradient bit-equal to "none"'s; the flash forward (and an MoE layer's
    gather) recomputed in the backward, so launched twice a layer; the
    backward kernels launched as often as without remat."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.lm import LM, REMATS, ShardCtx, has_moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_reduced(arch), d_ff=256, dtype=dtype,
                              **over)
    rng = np.random.default_rng(29)
    tok, lab = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 48))
                                 .astype(np.int32)).to(cuda)
                for _ in range(2))
    runs = {}
    for remat in REMATS:
        kops.reset_launch_counts()
        lm = LM(cfg, device=cuda, seed=4,
                shard=ShardCtx(remat=remat)).requires_grad_(True)
        loss = lm.loss(tok, lab)
        loss.backward()
        torch.cuda.synchronize()
        runs[remat] = (loss.detach(),
                       {k: p.grad for k, p in lm.named_parameters()},
                       kops.launch_counts(), kops.backward_launch_counts())
    loss0, grads0, fwd0, bwd0 = runs["none"]
    assert fwd0["flash_attention"] == cfg.num_layers
    for remat in ("dots", "full"):
        loss, grads, fwd, bwd = runs[remat]
        assert torch.equal(loss, loss0), remat
        for k, g in grads.items():
            assert torch.equal(g, grads0[k]), (remat, k)
        assert fwd["flash_attention"] == 2 * fwd0["flash_attention"]
        if has_moe(cfg):
            assert fwd["block_gather"] == 2 * fwd0["block_gather"] > 0
        assert bwd == bwd0, remat


def test_dry_run_mm_flops_equal_the_cards_count(cuda):
    """A prefill and a training step (remat "dots") of a bf16 dense config
    on a 1 x 1 mesh: the matrix products' FLOPs the dry run counts on meta
    equal what the same counter counts running the step on the card."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.shard_plan import DryMesh
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import count_bundle
    from repro_torch.roofline import analysis
    arch, over = TRAIN_CONFIGS[1]
    cfg = dataclasses.replace(get_reduced(arch), d_ff=256, dtype="bfloat16",
                              **over)
    one = DryMesh({"data": 1, "model": 1})
    rng = np.random.default_rng(21)
    for build in (steps.build_prefill_bundle, steps.build_train_bundle):
        dry = count_bundle(build(cfg, one, 64, 2), one)
        card = build(cfg, one, 64, 2, device="cuda")
        for t in card.args[-1].values():
            t.copy_(torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                  tuple(t.shape))))
        with analysis.flop_counter() as fc:
            card.fn(*card.args)
        torch.cuda.synchronize()
        mm = sum(n for op, n in fc.get_flop_counts()["Global"].items()
                 if str(op) in analysis.MM_OPS)
        assert mm == dry["mm_flops"] > 0, build.__name__
