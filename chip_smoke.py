#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--steps N] [--sweep-only]

Phases, one line each (a failed check raises and the run exits non-zero):

1. the card (``nvidia-smi`` name and power limit) -- exits 2 without CUDA;
2. the build of the hand-written kernels (``nvcc`` time, ptxas summary);
3. each kernel against its plain PyTorch version on the card over a sweep
   (add/max/min, weights with (x)=mul/add, bf16, empty segments, seg_base,
   block_rows=4, E=5/96/128/2048, tables not 16-byte aligned), and a small
   mixed program through the executor against the repo's numpy oracle
   (``program_reference``);
4. DLRM-DCNv2's sparse arch (26 SLS tables, dim 128, 2048 samples a step,
   rows capped at 10M per table, uniform ids) through
   ``executor_for(...).step`` for ``--steps`` steps, every op held against
   its plain per-op version, then
   the fused SLS unit's kernel against its plain version at that shape, and
   the times of the kernel, the plain version and ``F.embedding_bag``;
5. the same for DeepSeek-V2-Lite's step lookups (8 x 2048 tokens: token
   embedding, label gather, MoE dispatch, fused into one gather unit), with
   ``torch.index_select`` as the library call;
6. one JSON line listing both kernels with their main-path launches, error,
   times and bounds;
7. ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

# DLRM-DCNv2, the MLPerf Training "recommendation" benchmark (torchrec
# examples/dlrm_v2, Criteo 1TB multi-hot): rows per table and multi-hot
# sizes as published; the one cut is rows <= 10M per table (hash-mod, as
# --max-ind-range does), so the stacked tables fit one 80 GB card.
DLRM_ROWS = (40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63,
             40000000, 3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14,
             40000000, 40000000, 40000000, 590152, 12973, 108, 36)
DLRM_MULTI_HOT = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1,
                  12, 100, 27, 10, 3, 1, 1)
DLRM_DIM = 128
DLRM_BATCH = 2048
DLRM_ROW_CAP = 10_000_000

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)

# tolerances of kernel vs plain version (the same fp32 arithmetic in
# another order: up to ~130 standard-normal terms per sum)
TOL_SUM_F32 = dict(rtol=1e-5, atol=2e-4)
TOL_BF16 = dict(rtol=5e-2, atol=5e-2)


class CheckFailed(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def max_err(got, want) -> float:
    if got.numel() == 0:
        return 0.0
    return float((got.float() - want.float()).abs().max())


def check_close(got, want, what: str, rtol: float = 0.0,
                atol: float = 0.0) -> float:
    """Hold ``got`` against ``want`` elementwise (exact when both tolerances
    are 0); returns the max absolute error."""
    import torch
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: {got.dtype}{tuple(got.shape)} vs "
            f"{want.dtype}{tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    g, w = got.float(), want.float()
    bad = (g - w).abs() > atol + rtol * w.abs()
    err = max_err(got, want)
    require(not bool(bad.any()),
            f"{what}: {int(bad.sum())} elements off, max abs err {err:.3g} "
            f"(rtol={rtol}, atol={atol})")
    return err


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def free_cuda() -> None:
    import torch
    from repro_torch.core.executor import clear_executor_cache
    clear_executor_cache()
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 1-2: the card and the build
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{name}, {torch.cuda.device_count()} device(s)")
    return name


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    rec = _build.build_record()
    where = rec.path.relative_to(REPO)
    if not rec.built:
        print(f"[2 build] loaded an earlier build (no nvcc run) in "
              f"{time.perf_counter() - t0:.2f} s; {where}")
        return
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", rec.log)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                         rec.log)]
    (rec.path.parent / "ptxas.log").write_text(rec.log)
    print(f"[2 build] nvcc {rec.seconds:.2f} s (load "
          f"{time.perf_counter() - t0:.2f} s): {len(regs)} kernels, max "
          f"{max(regs, default=0)} registers, {max(spills, default=0)} "
          f"bytes spill stores; {where}")


# ---------------------------------------------------------------------------
# Phase 3: kernels vs plain versions over a sweep, small program vs oracle
# ---------------------------------------------------------------------------

def _csr(rng, segs: int, rows: int, avg: float, pad: int = 0):
    lens = rng.poisson(avg, segs)
    lens[::4] = 0                      # empty segments
    ptrs = np.zeros(segs + 1, np.int32)
    np.cumsum(lens, out=ptrs[1:])
    nnz = int(ptrs[-1])
    idxs = np.zeros(nnz + pad, np.int32)   # capacity padding: never read
    idxs[:nnz] = rng.integers(0, rows, nnz)
    return ptrs, idxs


def phase_sweep(seed: int) -> dict:
    import torch
    from repro_torch.kernels import ops as kops, ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    errs = {"sls_sum_f32": 0.0, "sls_maxmin": 0.0, "sls_bf16": 0.0,
            "gather": 0.0}
    n_sls = n_gather = 0
    for dtype in (torch.float32, torch.bfloat16):
        for emb in (5, 96, 128):
            rows, segs = 300, 37
            table = torch.from_numpy(
                rng.standard_normal((rows, emb)).astype(np.float32)
            ).to(dev, dtype)
            for add in ("add", "max", "min"):
                for weighting in (None, "mul", "add"):
                    for based in (False, True):
                        ptrs, idxs = _csr(rng, segs, rows // 2, 5, pad=7)
                        w = None
                        if weighting:
                            w = torch.from_numpy(rng.standard_normal(
                                len(idxs)).astype(np.float32)).to(dev, dtype)
                        base = None
                        if based:
                            base = torch.from_numpy(rng.integers(
                                0, rows // 2, segs).astype(np.int32)).to(dev)
                        args = (table, torch.from_numpy(ptrs).to(dev),
                                torch.from_numpy(idxs).to(dev), w)
                        kw = dict(num_segments=segs, add_op=add,
                                  mul_op=weighting or "mul", seg_base=base)
                        got = kops.sls(*args, **kw)
                        want = ref.sls(*args, **kw)
                        what = (f"sls {dtype} E={emb} {add}/{weighting} "
                                f"seg_base={based}")
                        if dtype == torch.bfloat16:
                            key, tol = "sls_bf16", TOL_BF16
                        elif add == "add":
                            key, tol = "sls_sum_f32", TOL_SUM_F32
                        else:
                            key, tol = "sls_maxmin", {}
                        errs[key] = max(errs[key],
                                        check_close(got, want, what, **tol))
                        n_sls += 1
        for emb in (5, 96, 2048):
            for block_rows in (1, 4):
                n_blk, g = 50, 64
                table = torch.from_numpy(rng.standard_normal(
                    (n_blk * block_rows, emb)).astype(np.float32)).to(dev,
                                                                     dtype)
                idxs = torch.from_numpy(rng.integers(
                    0, n_blk // 2, g).astype(np.int32)).to(dev)
                for roff in (None, torch.from_numpy(rng.integers(
                        0, n_blk // 2, g).astype(np.int32)).to(dev)):
                    got = kops.block_gather(table, idxs, block_rows=block_rows,
                                            roff=roff)
                    want = ref.block_gather(table, idxs,
                                            block_rows=block_rows, roff=roff)
                    check_close(got, want, f"gather {dtype} E={emb} "
                                f"R={block_rows} roff={roff is not None}")
                    n_gather += 1
    # tables one element into a flat buffer (not 16-byte aligned): the
    # kernels take one element per access
    n_unaligned = 0
    for emb in (8, 64):
        rows, segs = 300, 37
        flat = torch.from_numpy(rng.standard_normal(rows * emb + 1)
                                .astype(np.float32)).to(dev)
        table = flat[1:].view(rows, emb)
        require(table.data_ptr() % 16 != 0, "unaligned view is aligned")
        ptrs, idxs = _csr(rng, segs, rows, 5)
        args = (table, torch.from_numpy(ptrs).to(dev),
                torch.from_numpy(idxs).to(dev))
        errs["sls_sum_f32"] = max(errs["sls_sum_f32"], check_close(
            kops.sls(*args, num_segments=segs),
            ref.sls(*args, num_segments=segs),
            f"sls unaligned E={emb}", **TOL_SUM_F32))
        check_close(kops.block_gather(table, args[2]),
                    ref.block_gather(table, args[2]),
                    f"gather unaligned E={emb}")
        n_unaligned += 1
    # degenerate launches: no segments, an all-empty batch, an empty gather
    t = torch.randn(10, 8, device=dev)
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    require(kops.sls(t, torch.zeros(1, dtype=torch.int32, device=dev), z,
                     num_segments=0).shape == (0, 8), "sls with 0 segments")
    empty = kops.sls(t, torch.zeros(4, dtype=torch.int32, device=dev), z,
                     num_segments=3, add_op="max")
    require(bool((empty == 0).all()), "all-empty max segments must be 0")
    require(kops.block_gather(t, z).shape == (0, 1, 8), "empty gather")
    torch.cuda.synchronize()
    print(f"[3 sweep] sls {n_sls} cases: max abs err sum/f32 "
          f"{errs['sls_sum_f32']:.3g} (tol rtol=1e-5 atol=2e-4), max/min "
          f"{errs['sls_maxmin']:.3g} (exact), bf16 {errs['sls_bf16']:.3g} "
          f"(tol 5e-2); gather {n_gather} cases bit-exact; {n_unaligned} "
          f"unaligned tables (sls + gather) ok; empty launches ok")
    return errs


def phase_small_program(seed: int) -> None:
    """A mixed program (weighted + unweighted + kg fused CSR, a fused gather
    over a shared table, an spmm singleton, a max-semiring singleton)
    through the executor on the card, against the numpy oracle."""
    from repro_torch.convert import program_inputs_to_torch
    from repro_torch.core.executor import executor_for
    from repro_torch.core.ops import (EmbeddingOp, EmbeddingProgram,
                                      Semiring, make_program_inputs,
                                      program_reference)
    prog = EmbeddingProgram("smoke-mixed", (
        ("w", EmbeddingOp("sls", 50, 90, 96, avg_lookups=3, weighted=True)),
        ("u", EmbeddingOp("sls", 40, 70, 96, avg_lookups=2)),
        ("k", EmbeddingOp("kg", 60, 110, 96)),
        ("g1", EmbeddingOp("gather", 60, 200, 96)),
        ("g2", EmbeddingOp("gather", 60, 200, 96)),
        ("solo", EmbeddingOp("spmm", 30, 50, 5, avg_lookups=2)),
        ("mx", EmbeddingOp("sls", 30, 40, 128, avg_lookups=3,
                           semiring=Semiring("max"))),
    ), shared_tables=(("g1", "g2"),))
    host = make_program_inputs(prog, seed=seed)
    ins = program_inputs_to_torch(host, "cuda")
    got = executor_for(prog, "O3").step(ins)
    worst = 0.0
    for name, want in program_reference(prog, host).items():
        g = got[name].cpu().numpy()
        require(g.shape == want.shape and np.isfinite(g).all(),
                f"small program {name}: shape {g.shape} vs {want.shape}")
        require(np.allclose(g, want, rtol=1e-4, atol=1e-4),
                f"small program {name}: disagrees with the numpy oracle")
        worst = max(worst, float(np.abs(g - want).max()))
    print(f"[3 oracle] {len(prog.ops)}-op mixed program through the executor "
          f"== numpy program_reference (max abs err {worst:.3g}, tol 1e-4)")


# ---------------------------------------------------------------------------
# Phase 4: DLRM-DCNv2 sparse arch
# ---------------------------------------------------------------------------

def dlrm_program():
    from repro_torch.core.ops import EmbeddingOp, EmbeddingProgram
    return EmbeddingProgram("dlrm-dcnv2", tuple(
        (f"f{i}", EmbeddingOp("sls", DLRM_BATCH, min(rows, DLRM_ROW_CAP),
                              DLRM_DIM, avg_lookups=hot))
        for i, (rows, hot) in enumerate(zip(DLRM_ROWS, DLRM_MULTI_HOT))))


def _time_steps(ex, steps):
    """Drive the executor one step at a time (submit, then wait on the
    step's result): host clock for the whole step and for ``submit`` alone
    (host-side validation, packing, copies and launches)."""
    import torch
    from repro_torch.kernels import ops as kops
    kops.reset_launch_counts()
    outs, times, submit = [], [], []
    for ins in steps:
        t0 = time.perf_counter()
        h = ex.submit(ins)
        t1 = time.perf_counter()
        out = h.result()
        ex.drain()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        submit.append(t1 - t0)
        outs.append(out)
    return outs, times, submit, kops.launch_counts()


def _where_the_time_goes(ex, ins, step_ms: float, top: int = 5) -> str:
    """Two more steps, one under cProfile (the host functions with the most
    own time) and one under torch.profiler (device time by kernel and copy,
    and its share of the unprofiled ``step_ms``)."""
    import cProfile
    import pstats
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prof = cProfile.Profile()
    prof.runcall(ex.step, ins)
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:top]
    host = ", ".join(f"{fn[2]} {tt * 1e3:.2f} ms"
                     for fn, (_, _, tt, _, _) in rows)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        ex.step(ins)
        torch.cuda.synchronize()
    dev = sorted(((e.key, e.self_device_time_total)
                  for e in tp.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), key=lambda kv: -kv[1])
    busy_ms = sum(us for _, us in dev) / 1e3
    if not dev:
        device = "device time not measured (the profiler saw no CUDA events)"
    else:
        device = (f"device busy {busy_ms:.4f} ms = "
                  f"{100 * busy_ms / step_ms:.1f}% of the {step_ms:.3f} ms "
                  f"step (idle {100 - 100 * busy_ms / step_ms:.1f}%): " +
                  ", ".join(f"{k[:40]} {us / 1e3:.4f} ms"
                            for k, us in dev[:top]))
    return f"host (cProfile, own time): {host}; {device}"


def _unique_rows(idxs: np.ndarray, roff: np.ndarray, ptrs=None) -> int:
    if ptrs is not None:
        seg = np.repeat(np.arange(len(ptrs) - 1), np.diff(ptrs))
        rows = idxs[:len(seg)].astype(np.int64) + roff[seg]
    else:
        rows = idxs.astype(np.int64) + roff
    return int(np.unique(rows).size)


def phase_dlrm(seed: int, n_steps: int) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.core.executor import executor_for
    from repro_torch.kernels import ops as kops, ref
    torch.cuda.reset_peak_memory_stats()
    prog = dlrm_program()
    t0 = time.perf_counter()
    ex = executor_for(prog, "O3")
    compile_s = time.perf_counter() - t0
    units = ex.compiled.units
    require(len(units) == 1 and len(units[0].names) == len(DLRM_ROWS),
            f"DLRM should fuse into one unit, got {len(units)}")
    g = torch.Generator(device="cuda").manual_seed(seed)
    tables = [torch.randn((op.num_embeddings, DLRM_DIM), generator=g,
                          device="cuda") for _, op in prog.ops]
    stacked_rows = sum(t.shape[0] for t in tables)
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(n_steps):
        ins = {}
        for (name, op), table, hot in zip(prog.ops, tables, DLRM_MULTI_HOT):
            ins[name] = {
                "table": table,
                "ptrs": np.arange(0, DLRM_BATCH * hot + 1, hot,
                                  dtype=np.int32),
                "idxs": rng.integers(0, op.num_embeddings,
                                     DLRM_BATCH * hot).astype(np.int32)}
        steps.append(ins)
    outs, times, submit, counts = _time_steps(ex, steps)
    require(counts["sls"] == n_steps,
            f"DLRM main path launched sls {counts['sls']} times, expected "
            f"{n_steps}")
    worst = 0.0
    for ins, out in zip(steps, outs):
        for name, _ in prog.ops:
            s = ins[name]
            want = ref.sls(s["table"], torch.from_numpy(s["ptrs"]).cuda(),
                           torch.from_numpy(s["idxs"]).cuda(),
                           num_segments=DLRM_BATCH)
            worst = max(worst, check_close(out[name], want,
                                           f"DLRM step op {name}",
                                           **TOL_SUM_F32))
    lookups = sum(len(s["idxs"]) for s in steps[-1].values())
    print(f"[4 dlrm] {n_steps} steps of {len(prog.ops)} tables -> 1 fused "
          f"SLS unit, {stacked_rows} stacked rows x {DLRM_DIM} fp32 "
          f"({stacked_rows * DLRM_DIM * 4 / 1e9:.2f} GB), batch {DLRM_BATCH}, "
          f"uniform ids: "
          f"{lookups} lookups/step ({lookups * DLRM_DIM * 4 / 1e6:.1f} MB of "
          f"rows); sls launches {counts['sls']}; compile {compile_s:.2f} s; "
          f"step 1 (binds + stacks) {times[0] * 1e3:.2f} ms, steps 2-"
          f"{n_steps} mean {np.mean(times[1:]) * 1e3:.3f} ms "
          f"(host clock + synchronize; submit alone "
          f"{np.mean(submit[1:]) * 1e3:.3f} ms); every op == plain per-op "
          f"SLS (max abs err {worst:.3g})")
    print(f"[4 dlrm where] "
          f"{_where_the_time_goes(ex, steps[-1], np.mean(times[1:]) * 1e3)}")
    # the fused unit's kernel at the main path's shape vs its plain version
    u = ex._units[0]
    fused = u.plan.fused_index_inputs(steps[-1])
    dev_in = {k: torch.from_numpy(np.ascontiguousarray(fused[k])).cuda()
              for k in ("ptrs", "idxs", "roff")}
    args = (u.table, dev_in["ptrs"], dev_in["idxs"])
    kw = dict(num_segments=u.plan.num_segments, seg_base=dev_in["roff"])
    got = kops.sls(*args, **kw)
    err = check_close(got, ref.sls(*args, **kw), "fused DLRM SLS unit",
                      **TOL_SUM_F32)
    seg = torch.repeat_interleave(
        torch.arange(u.plan.num_segments, device="cuda"),
        (dev_in["ptrs"][1:] - dev_in["ptrs"][:-1]).long())
    gidx = dev_in["idxs"].long() + dev_in["roff"].long()[seg]
    offsets = dev_in["ptrs"][:-1].long()

    def library():
        return F.embedding_bag(gidx, u.table, offsets, mode="sum")
    check_close(library(), got, "F.embedding_bag vs kernel", **TOL_SUM_F32)
    ms = time_ms(lambda: kops.sls(*args, **kw), 50)
    plain_ms = time_ms(lambda: ref.sls(*args, **kw), 10)
    library_ms = time_ms(library, 50)
    nnz, segs = int(fused["ptrs"][-1]), u.plan.num_segments
    uniq = _unique_rows(fused["idxs"], fused["roff"], fused["ptrs"])
    nbytes = (uniq * DLRM_DIM * 4 + (segs + 1) * 4 + nnz * 4 + segs * 4 +
              segs * DLRM_DIM * 4)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"[4 dlrm kernel] fused SLS {segs} segments, {nnz} lookups "
          f"({uniq} distinct rows): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, F.embedding_bag {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes / 1e6:.1f} MB at 3.35 TB/s; kernel at "
          f"{nbytes / ms / 1e6:.0f} GB/s); max abs err {err:.3g} vs plain; "
          f"peak device memory {peak / 2**30:.2f} GiB")
    result = {"name": "sls", "route": "cuda",
              "source": "src/repro_torch/csrc/ember_kernels.cu",
              "replaces": "src/repro/kernels/sls.py:67",
              "launches": counts["sls"], "max_abs_err": err, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
              "library_ms": library_ms, "held_against_plain": True}
    del ex, u, tables, steps, outs, args, kw, got, dev_in, gidx, seg
    free_cuda()
    return result


# ---------------------------------------------------------------------------
# Phase 5: DeepSeek-V2-Lite LM step lookups
# ---------------------------------------------------------------------------

def phase_deepseek(seed: int, n_steps: int) -> dict:
    import torch
    from repro_torch.configs.deepseek_v2_lite_16b import config
    from repro_torch.core.executor import executor_for
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.models.lm import embedding_program
    torch.cuda.reset_peak_memory_stats()
    cfg = config()
    batch, seq = 8, 2048
    prog = embedding_program(cfg, batch, seq)
    t0 = time.perf_counter()
    ex = executor_for(prog, "O3")
    compile_s = time.perf_counter() - t0
    units = ex.compiled.units
    require(len(units) == 1 and len(units[0].names) == 3,
            f"DeepSeek step lookups should fuse into one unit, got "
            f"{len(units)}")
    ops = dict(prog.ops)
    g = torch.Generator(device="cuda").manual_seed(seed)
    embed = torch.randn((cfg.padded_vocab, cfg.d_model), generator=g,
                        device="cuda")
    capacity = torch.randn((ops["moe_dispatch"].num_embeddings, cfg.d_model),
                           generator=g, device="cuda")
    tables = {"tok_embed": embed, "label_gather": embed,
              "moe_dispatch": capacity}
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(n_steps):
        steps.append({name: {"table": tables[name],
                             "idxs": rng.integers(
                                 0, op.num_embeddings if name == "moe_dispatch"
                                 else cfg.vocab_size,
                                 op.num_segments).astype(np.int32)}
                      for name, op in prog.ops})
    outs, times, submit, counts = _time_steps(ex, steps)
    require(counts["block_gather"] == n_steps,
            f"DeepSeek main path launched block_gather "
            f"{counts['block_gather']} times, expected {n_steps}")
    for ins, out in zip(steps, outs):
        for name, _ in prog.ops:
            s = ins[name]
            check_close(out[name], ref.block_gather(
                s["table"], torch.from_numpy(s["idxs"]).cuda()),
                f"DeepSeek step op {name}")
    u = ex._units[0]
    segs = u.plan.num_segments
    print(f"[5 deepseek] {cfg.name} {batch}x{seq} tokens (uniform ids): "
          f"{n_steps} steps of "
          f"{len(prog.ops)} gathers -> 1 fused gather unit, {segs} rows out "
          f"of a {u.table.shape[0]}-row stacked table x {cfg.d_model} fp32 "
          f"({u.table.numel() * 4 / 1e9:.2f} GB); block_gather launches "
          f"{counts['block_gather']}; compile {compile_s:.2f} s; step 1 "
          f"{times[0] * 1e3:.2f} ms, steps 2-{n_steps} mean "
          f"{np.mean(times[1:]) * 1e3:.3f} ms (submit alone "
          f"{np.mean(submit[1:]) * 1e3:.3f} ms); every op == plain per-op "
          f"gather (bit-exact)")
    print(f"[5 deepseek where] "
          f"{_where_the_time_goes(ex, steps[-1], np.mean(times[1:]) * 1e3)}")
    fused = u.plan.fused_index_inputs(steps[-1])
    idxs = torch.from_numpy(np.ascontiguousarray(fused["idxs"])).cuda()
    roff = torch.from_numpy(np.ascontiguousarray(fused["roff"])).cuda()
    got = kops.block_gather(u.table, idxs, roff=roff)
    err = check_close(got, ref.block_gather(u.table, idxs, roff=roff),
                      "fused DeepSeek gather unit")
    rows = idxs.long() + roff.long()

    def library():
        return torch.index_select(u.table, 0, rows)
    check_close(library(), got[:, 0], "torch.index_select vs kernel")
    ms = time_ms(lambda: kops.block_gather(u.table, idxs, roff=roff), 50)
    plain_ms = time_ms(lambda: ref.block_gather(u.table, idxs, roff=roff), 20)
    library_ms = time_ms(library, 50)
    uniq = _unique_rows(fused["idxs"], fused["roff"])
    row_bytes = cfg.d_model * 4
    nbytes = uniq * row_bytes + segs * 8 + segs * row_bytes
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"[5 deepseek kernel] fused gather {segs} rows ({uniq} distinct): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.index_select "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} "
          f"MB at 3.35 TB/s; kernel at {nbytes / ms / 1e6:.0f} GB/s); "
          f"bit-exact vs plain; peak device memory {peak / 2**30:.2f} GiB")
    result = {"name": "block_gather", "route": "cuda",
              "source": "src/repro_torch/csrc/ember_kernels.cu",
              "replaces": "src/repro/kernels/gather.py:32",
              "launches": counts["block_gather"], "max_abs_err": err,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": "bytes", "library_ms": library_ms,
              "held_against_plain": True}
    del ex, u, tables, embed, capacity, steps, outs, got, idxs, roff, rows
    free_cuda()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--sweep-only", action="store_true",
                    help="stop after phase 3 (a quick kernel check)")
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be >= 2")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    phase_build()
    phase_sweep(args.seed)
    phase_small_program(args.seed)
    if args.sweep_only:
        return 0
    kernels = [phase_dlrm(args.seed, args.steps),
               phase_deepseek(args.seed, args.steps)]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} never launched on the path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
