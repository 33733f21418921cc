#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--steps N] [--sweep-only]

Phases, one line each (a failed check raises and the run exits non-zero):

1. the card (``nvidia-smi`` name and power limit) -- exits 2 without CUDA;
2. the build of the hand-written kernels (one ``nvcc`` per source, in
   parallel; ptxas summary, and the registers and spills of the bf16 flash
   kernels, the bulk gather and the FusedMM ring, none of which may
   spill, nor may the four (q/k 192, v 128) flash instantiations), then
   ``cuobjdump -sass`` of the library: the bf16 flash kernels, the
   (192, 128) ones among them, must hold wgmma (``HGMMA``) and TMA load
   (``UTMALDG``) instructions, the
   bulk gather and every FusedMM ring kernel bulk copies (``UBLKCP``), and
   each flash kernel's KV tile must be ``kv_tile``'s;
3. each kernel against its plain PyTorch version on the card over a sweep
   (SLS: add/max/min, weights with (x)=mul/add, bf16, empty segments,
   seg_base; gather: block_rows=4, E=5/96/2048, uniform, all-equal and
   Zipf ids, both variants; FusedMM: identity/relu, f32/bf16,
   E=5/8/64/100/128/520/1024, empty segments and segments longer than the
   ring, zero segments, both variants; flash attention: causal or not, GQA
   groups 1/4/16, (q/k, v) widths (64, 64), (80, 80), (128, 128) and
   (192, 128), S=256, a ragged 200 and 200 queries over 328 keys,
   f32/bf16; tables not 16-byte aligned; bf16 held by
   ``kernels.agreement.check_bf16``), the bf16 flash kernel over 300
   causal cases of few-key rows (the four width pairs), and a small mixed
   program through the executor against the repo's numpy oracle
   (``program_reference``);
4. DLRM-DCNv2's sparse arch (26 SLS tables, dim 128, 2048 samples a step,
   rows capped at 10M per table, uniform ids) through
   ``executor_for(...).step`` for ``--steps`` steps, every op held against
   its plain per-op version, then the fused SLS unit's kernel against its
   plain version at that shape, and the times of the kernel, the plain
   version and ``F.embedding_bag``;
5. the same for DeepSeek-V2-Lite's step lookups (8 x 2048 tokens: token
   embedding, label gather, MoE dispatch, fused into one gather unit; the
   steps must run the bulk variant and its grouping pass once each a
   step), with ``torch.index_select`` as the library call, a contiguous
   ``copy_`` of the output's bytes as the rate the card streams, and the
   fused unit again on a realistic stream (Zipf(1.05) token ids, labels
   shifted by one, MoE dispatch a permutation of the capacity slots); the
   rows variant timed beside the bulk one on both streams;
6. GNN message passing at ogbn-products sizes (2,449,029 nodes, 123,718,280
   CSR entries, 100 fp32 features; a synthetic graph) as one ``fusedmm``
   program through ``executor_for(...).step``, fresh features each step
   (the steps must run the rows variant once each: at 400-byte rows it is
   faster than the ring), every output held against the plain version in
   chunks of segments, and the FusedMM kernel's time against its bound,
   against every neighbour row read from HBM, against ``F.embedding_bag``
   over the same reads and against a contiguous copy; both variants timed
   at that width and at other widths of the same graph;
7. chatglm3-6b (28 layers, full width, bf16, random weights) through
   ``LM.prefill`` over 4 x 4096 tokens: flash attention in every layer; in
   one more prefill every layer's kernel output is held against the plain
   version on that layer's own q, k, v (``check_bf16``), and the last
   hidden state against a prefill with plain attention; the kernel's time
   beside ``scaled_dot_product_attention``, also at one prefill_32k
   sequence; then stablelm-3b (32 layers, head dim 80, full width, bf16,
   random weights; chatglm3-6b freed first) over the same 4 x 4096
   tokens: flash at D = 80 in every layer, layer 0's kernel output held
   against the plain version, the kernel's time beside its bound and
   ``scaled_dot_product_attention``;
8. chatglm3-6b served (full width and depth, bf16, random weights):
   ``DecodeServer(batch_slots=8, max_len=512, prefill_chunk=16,
   pipeline=True)`` answers 16 requests (prompts of 32-128 uniform ids, 32
   new tokens each) through the server's CUDA graphs of the decode
   micro-step and the slot reset (``runtime.server.WaveGraph``), every
   decode-embed wave through the block gather (bulk variant and its
   grouping pass once a wave).  Checked: every request ends ok with 32
   tokens; a drive at ``prefill_chunk=1`` emits the same tokens with
   bit-identical final logits; the latest-admitted request served alone
   emits the same tokens; one request's teacher-forced decode logits agree
   with ``LM.forward`` (the flash prefill path) within phase 7's
   relative-L2 bound, with the same argmax wherever the top-2 margin
   exceeds that bound times the row's RMS; the group's outputs with
   ``backend="cuda"`` equal ``backend="torch"`` and ``embed[tokens]`` bit
   for bit; and the same 16 requests through a graph server and an eager
   server (``LM.wave_step`` / ``LM.reset_slots``) stepped in turn: every
   wave's logits, every cache leaf after every iteration and every token
   the same bits.  Printed: tokens/s, TTFT and per-token p50/p99, waves,
   host ms per wave and per micro-step (graph and eager, and the eager
   baseline beside them), device ms of one captured micro-step (CUDA
   events), the device busy share and top device operations
   (torch.profiler), peak device memory.  Then stablelm-3b served the
   same way (8 requests, 16 new tokens each), held to the eager wave the
   same way;
9. DeepSeek-V2-Lite (27 layers of MLA + MoE, full width, bf16, random
   weights; built once, stablelm-3b freed first): ``LM.prefill`` over the
   same 4 x 4096 tokens, a flash launch at (q/k 192, v 128) and an MoE
   un-dispatch gather in every layer, every layer's flash output held
   against the plain version on its own q, k, v (``check_bf16``) and its
   gather against the plain gather bit for bit, the last hidden state
   against a prefill with plain attention and the routing pinned to the
   kernel prefill's within a fixed bound that two planted faults (one
   layer's attention at the wrong scale, one KV tile's values lost) must
   exceed (and the routing decisions plain attention takes differently on
   its own), the flash kernel's time beside its bound, the plain version
   and ``scaled_dot_product_attention`` (each backend timed, or its
   refusal printed), the un-dispatch gather's (both variants) beside
   ``index_select`` and its bytes bound; then the model served as
   stablelm-3b is (8 requests, 16 new tokens), both pipeline members
   (decode-embed and MoE un-dispatch) fed every wave, the un-dispatch
   member held against the stock-op backend, the drive in lockstep with
   the eager wave, bit for bit, every gather launched eagerly there held
   against the plain gather bit for bit, and the gathers of every
   replayed micro-step counted in the device trace (the
   ``prefill_chunk=1`` check of phase 8 does not hold for an MoE model,
   in the reference either);
10. one JSON line listing the four kernels with the kernel (variant) that
   ran on the main path, its launches there (the gather's include the
   served waves of every model and DeepSeek's un-dispatch gathers,
   flash's the stablelm-3b and DeepSeek prefills), error, times and
   bounds;
11. ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
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

# ogbn-products (OGB, Hu et al. 2020): nodes, directed CSR entries (61,859,140
# undirected edges, both directions), node feature width.  The graph here is
# synthetic: Poisson degrees of the same mean, uniform neighbours.
OGBN_NODES = 2_449_029
OGBN_DIRECTED_EDGES = 123_718_280
OGBN_FEATURES = 100
GNN_CHECK_SEGMENTS = 100_000   # plain-version check in chunks of segments
# ring vs rows variant on the same graph at other fp32 widths: where the
# ring overtakes (kernels.sls.FUSEDMM_RING_MIN_ROW_BYTES)
GNN_SWEEP_WIDTHS = ((32, 64, 128, 160, 192, 240, 256, 272, 320, 384, 448,
                     512, 520, 768, 1024),        # fp32
                    (256, 512, 640, 1040))        # bf16

# chatglm3-6b prefill: 4 prompts x 4096 tokens (cut from launch/steps.py's
# prefill_32k, 32 x 32768), and one prefill_32k sequence for the kernel alone
PREFILL_BATCH, PREFILL_SEQ = 4, 4096
PREFILLS = 3                   # timed prefills
LONG_SEQ = 32768

# the kernels that move rows by cp.async.bulk, with their instantiations
# (gather: one; FusedMM ring: 2 dtypes x 2 f x 6 words per lane), and the
# SASS of a bulk copy
BULK_KERNELS = {"gather_bulk_kernel": 1, "fusedmm_ring_kernel": 24}
BULK_COPY_SASS = "UBLKCP"

# chatglm3-6b served: DecodeServer(batch_slots=8, max_len=512,
# prefill_chunk=16, pipeline=True), 16 requests of uniform 32-128 prompt
# tokens and uniform ids, 32 new tokens each, no EOS
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_CHUNK = 8, 512, 16
SERVE_REQUESTS, SERVE_NEW_TOKENS = 16, 32
SERVE_PROMPT_LEN = (32, 128)
# stablelm-3b served the same way, a shorter drive: one generation of 8
# slots, 16 new tokens each
STABLELM_REQUESTS, STABLELM_NEW_TOKENS = 8, 16
# the eager served path the captured wave is compared with: the same
# chatglm3-6b drive served eagerly (PERF.md §6; NVIDIA H100 80GB HBM3,
# 700.00 W)
EAGER_BASELINE = {"host_ms_micro_step": 42.84, "device_ms_micro_step": 9.15,
              "busy_pct": 21.2, "ms_decode_wave": 38.79,
              "tokens_per_s": 33.7, "ttft_p50_s": 7.33, "ttft_p99_s": 14.01,
              "per_token_p50_ms": 43.37, "per_token_p99_ms": 933.36}

# H100 SXM (NVIDIA data sheet, dense, 700 W): HBM3 rate and peak rates
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12           # outside the tensor cores
BF16_TC_FLOPS = 989e12

# tolerances of kernel vs plain version (the same fp32 arithmetic in
# another order: up to ~130 standard-normal terms per sum)
TOL_SUM_F32 = dict(rtol=1e-5, atol=2e-4)
# fusedmm: fp32 dots of up to 520 terms feed each scale, then sums of ~10
# scaled rows, each in another order than the plain version's
TOL_FMM_F32 = dict(rtol=1e-4, atol=1e-3)
# attention: the same recurrence over the same 64-key tiles, fp32 sums in
# another order; outputs are convex combinations of unit-normal values
TOL_ATTN_F32 = dict(rtol=1e-5, atol=1e-5)
# few-key causal rows of bf16 flash attention: cases of q (2, 200, 16, D)
# over k (2, 200, 1, D) and v (2, 200, 1, Dv), (D, Dv) cycling over
# FLASH_STRESS_DIMS.  A row near the
# start attends to a few keys, where a p rounded to the other side of a
# bf16 step (scores summed in another order) moves the output the most
FLASH_STRESS_CASES = 300
FLASH_STRESS_DIMS = ((128, 128), (64, 64), (80, 80), (192, 128))
# the flash kernel's (q/k width, v width) pairs, and its bf16 wgmma
# instantiations: 3 pairs ((80, 80) runs (128, 128)) x causal or not; the
# (192, 128) ones by their mangled template arguments
FLASH_DIMS = ((64, 64), (80, 80), (128, 128), (192, 128))
FLASH_WGMMA_KERNELS = 6
MLA_INSTANCE = "ILi192ELi128E"
# bf16 kernel outputs vs plain: kernels.agreement.check_bf16 (one bf16 step
# per element, <= 1 % of elements differing, relative L2 <= 2^-9).
# scaled_dot_product_attention rounds p against the running max of its own
# tiles, so it may differ from the kernel by a bf16 step in many elements:
# held to a relative L2 below one bf16 step
LIBRARY_REL_L2_BF16 = 2 ** -7
# ogbn-products message passing: each output sums ~50 terms s * x[j] with
# s ~ N(0, 100), so outputs are ~70 in size; 1e-2 is 1.4e-4 of that scale
TOL_GNN = dict(rtol=1e-4, atol=1e-2)
# last hidden state of the chatglm3 prefill, kernel vs plain attention:
# single bf16 steps in a few attention outputs are amplified by the bf16
# GEMMs and norms of 28 layers, so this end-to-end bound catches only a
# gross fault; the per-layer check_bf16 of every attention output is the
# precise one
PREFILL_REL_L2 = 5e-2
# DeepSeek-V2-Lite's random weights follow the reference's init, whose
# experts' fan-in scale is E^-1/2 (the leading dim of (E, D, F)): an expert
# output is ~90x its input's RMS, so the residual stream is the MoE
# layers' outputs and a rounding step of attention grows through the 27
# gated (quadratic) products.  Its end-to-end bound (last hidden state,
# kernel vs plain attention, routing pinned) is fixed between the sound
# readings on the H100 (the kernel 0.0647; two plain versions that differ
# only in their KV chunk 0.0777) and a planted fault (layer 0's attention
# at the v width's scale: 0.993), which the phase runs and requires above
# it.  A lost KV tile in a middle layer reads 0.0647 there too: only the
# per-layer check_bf16, the precise check, sees it
DEEPSEEK_PREFILL_REL_L2 = 0.15
# the keys whose values one planted fault loses: the second 128-key tile
FAULT_KEYS = (128, 256)


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


def _worst(acc: dict, a: dict) -> None:
    """Fold one check_bf16 result into the running worst of a sweep."""
    for key, val in a.items():
        acc[key] = max(acc.get(key, 0.0), val)


def _bf16_summary(a: dict) -> str:
    if not a:
        return "no cases"
    return (f"max abs {a['max_abs']:.3g} ({a['worst']:.3g} x its one-step "
            f"tol), <= {100 * a['share_differing']:.3g}% of elements "
            f"differing, relative L2 <= {a['rel_l2']:.3g}")


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
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{name}, {torch.cuda.device_count()} device(s)")
    return name, card


def _ptxas_by_kernel(log: str) -> dict:
    """ptxas -v's report, by mangled kernel name: (registers, spill-store
    bytes)."""
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        out[name] = (int(regs.group(1)) if regs else 0,
                     int(spill.group(1)) if spill else 0)
    return out


def _sass_counts(lib: Path, kernel: str, ops: tuple) -> tuple:
    """``cuobjdump -sass`` of the library: the number of functions whose
    name holds ``kernel``, and of their instructions starting with each of
    ``ops``."""
    from repro_torch.kernels import _build
    sass = subprocess.run([_build.cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    n_fn, counts = 0, dict.fromkeys(ops, 0)
    for part in sass.split("Function : ")[1:]:
        if kernel not in part.split("\n", 1)[0]:
            continue
        n_fn += 1
        for op in ops:
            counts[op] += len(re.findall(rf"\b{op}\b", part))
    return n_fn, counts


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kv_tile
    from repro_torch.kernels.sls import DTYPES
    t0 = time.perf_counter()
    _build.library()
    rec = _build.build_record()
    where = rec.path.relative_to(REPO)
    if not rec.built:
        print(f"[2 build] loaded an earlier build (no nvcc run) in "
              f"{time.perf_counter() - t0:.2f} s; {where}")
    else:
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", rec.log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                             rec.log)]
        (rec.path.parent / "ptxas.log").write_text(rec.log)
        print(f"[2 build] nvcc {rec.seconds:.2f} s (load "
              f"{time.perf_counter() - t0:.2f} s): {len(regs)} kernels, max "
              f"{max(regs, default=0)} registers, {max(spills, default=0)} "
              f"bytes spill stores; {where}")
        wgmma = {k: v for k, v in _ptxas_by_kernel(rec.log).items()
                 if "flash_wgmma_kernel" in k}
        flash_log = rec.log.split("== ember_flash_attention.cu\n")[-1]
        warnings = sorted({ln.strip() for ln in flash_log.split("\n== ")[0]
                           .splitlines() if "warning" in ln.lower()})
        print(f"[2 build flash] bf16 wgmma kernels (registers, spill-store "
              f"bytes): {sorted(wgmma.values())}; ptxas warnings on the "
              f"flash source: {warnings or 'none'}")
        require(len(wgmma) == FLASH_WGMMA_KERNELS and
                all(s == 0 for _, s in wgmma.values()),
                "the bf16 flash kernels must build without spills")
        mla = {k: v for k, v in _ptxas_by_kernel(rec.log).items()
               if MLA_INSTANCE in k}
        print(f"[2 build flash mla] the (192, 128) instantiations (bf16 "
              f"wgmma and f32 scalar, causal or not; registers, spill-store "
              f"bytes): {sorted(mla.values())}")
        require(len(mla) == 4 and all(s == 0 for _, s in mla.values()),
                "the (192, 128) flash kernels must build without spills")
        for kernel, n_want in BULK_KERNELS.items():
            got = {k: v for k, v in _ptxas_by_kernel(rec.log).items()
                   if kernel in k}
            print(f"[2 build {kernel}] (registers, spill-store bytes): "
                  f"{sorted(set(got.values()))}")
            spilled = sorted(k for k, (_, s) in got.items() if s)
            require(len(got) == n_want and not spilled,
                    f"the {kernel} instantiations must build without spills "
                    f"({len(got)} built; spilling: {spilled})")
    # proof that the bf16 flash kernel runs on the tensor cores and TMA
    n_fn, ops = _sass_counts(rec.path, "flash_wgmma_kernel",
                             ("HGMMA", "UTMALDG", "UTMASTG"))
    print(f"[2 sass] bf16 flash kernels ({n_fn} instantiations, cuobjdump "
          f"-sass): {ops['HGMMA']} HGMMA, {ops['UTMALDG']} UTMALDG (TMA "
          f"loads), {ops['UTMASTG']} UTMASTG (TMA stores)")
    require(n_fn == FLASH_WGMMA_KERNELS and ops["HGMMA"] > 0 and
            ops["UTMALDG"] > 0,
            "the bf16 flash kernel must hold wgmma (HGMMA) and TMA loads "
            "(UTMALDG)")
    n_fn, ops = _sass_counts(rec.path, "flash_wgmma_kernel" + MLA_INSTANCE,
                             ("HGMMA", "UTMALDG", "UTMASTG"))
    print(f"[2 sass] bf16 flash kernels at (192, 128) ({n_fn} "
          f"instantiations): {ops['HGMMA']} HGMMA, {ops['UTMALDG']} UTMALDG, "
          f"{ops['UTMASTG']} UTMASTG")
    require(n_fn == 2 and ops["HGMMA"] > 0 and ops["UTMALDG"] > 0,
            "the (192, 128) bf16 flash kernel must hold wgmma (HGMMA) and "
            "TMA loads (UTMALDG)")
    # proof that the row-streaming kernels move rows by bulk copies
    for kernel, n_want in BULK_KERNELS.items():
        n_fn, ops = _sass_counts(rec.path, kernel, (BULK_COPY_SASS,))
        print(f"[2 sass] {kernel} ({n_fn} instantiations): "
              f"{ops[BULK_COPY_SASS]} {BULK_COPY_SASS} (cp.async.bulk)")
        require(n_fn == n_want and ops[BULK_COPY_SASS] >= n_fn,
                f"every {kernel} must hold bulk copies ({BULK_COPY_SASS})")
    # every flash check holds the kernel to the plain version over kv_tile
    # keys: the library's own tiles must be those
    tiles = {dt: _build.library().ember_flash_kv_tile(code)
             for dt, code in DTYPES.items()}
    print("[2 kv tile] flash KV tiles of the library: " + ", ".join(
        f"{dt} {t} (kv_tile {kv_tile(dt)})" for dt, t in tiles.items()))
    require(all(t == kv_tile(dt) for dt, t in tiles.items()),
            "kv_tile must be the flash kernels' own KV tiles")


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


def _ids(rng, kind: str, n: int, g: int) -> np.ndarray:
    """g lookup ids below n: uniform, all one block, or a Zipf(1.05) head."""
    if kind == "equal":
        return np.full(g, n // 2, np.int32)
    if kind == "zipf":
        return (np.minimum(rng.zipf(1.05, g), n) - 1).astype(np.int32)
    return rng.integers(0, n, g).astype(np.int32)


def _variant_delta(kernel: str, before: dict) -> dict:
    from repro_torch.kernels import ops as kops
    after = kops.variant_launch_counts()[kernel]
    return {k: after[k] - before[k] for k in after}


def phase_sweep(seed: int) -> dict:
    import torch
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.agreement import check_bf16
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    gather_before = kops.variant_launch_counts()["block_gather"]
    errs = {"sls_sum_f32": 0.0, "sls_maxmin": 0.0, "gather": 0.0}
    bf16 = {}
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
                            _worst(bf16, check_bf16(got, want, what))
                            n_sls += 1
                            continue
                        if add == "add":
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
                for ids in ("uniform", "equal", "zipf"):
                    idxs = torch.from_numpy(_ids(rng, ids, n_blk // 2, g)
                                            ).to(dev)
                    for roff in (None, torch.from_numpy(rng.integers(
                            0, n_blk // 2, g).astype(np.int32)).to(dev)):
                        got = kops.block_gather(table, idxs,
                                                block_rows=block_rows,
                                                roff=roff)
                        want = ref.block_gather(table, idxs,
                                                block_rows=block_rows,
                                                roff=roff)
                        check_close(got, want, f"gather {dtype} E={emb} "
                                    f"R={block_rows} {ids} ids "
                                    f"roff={roff is not None}")
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
    variants = _variant_delta("block_gather", gather_before)
    require(variants["bulk"] > 0 and variants["rows"] > 0 and
            variants["group"] == variants["bulk"],
            f"the gather sweep must run both variants: {variants}")
    print(f"[3 sweep] sls {n_sls} cases: max abs err sum/f32 "
          f"{errs['sls_sum_f32']:.3g} (tol rtol=1e-5 atol=2e-4), max/min "
          f"{errs['sls_maxmin']:.3g} (exact), bf16 {_bf16_summary(bf16)}; "
          f"gather {n_gather} cases bit-exact (uniform, all-equal and Zipf "
          f"ids; variant launches {variants}); {n_unaligned} unaligned "
          f"tables (sls + gather) ok; empty launches ok")
    return errs


def phase_sweep_fusedmm(seed: int) -> None:
    """FusedMM against its plain version: identity/relu, f32/bf16, E = 5,
    8, 64, 100, 128, 520, 1024, through the wrapper and through each
    variant that takes the shape (the ring: whole 16-byte units up to 4 KB;
    the rows variant: every width here), empty segments, segments longer
    than the ring, an unaligned table, zero segments."""
    import torch
    from repro_torch.kernels import fusedmm as kfusedmm, ops as kops, ref
    from repro_torch.kernels.agreement import check_bf16
    from repro_torch.kernels.sls import FUSEDMM_RING_MAX_ROW_BYTES
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 1)
    err_f32, bf16 = 0.0, {}
    n = 0
    before = kops.variant_launch_counts()["fusedmm"]
    for dtype in (torch.float32, torch.bfloat16):
        for emb in (5, 8, 64, 100, 128, 520, 1024):
            rows = 400
            x = torch.from_numpy(rng.standard_normal((rows, emb)).astype(
                np.float32)).to(dev, dtype)
            row_bytes = emb * x.element_size()
            variants = ["wrapper", "rows"]
            if row_bytes % 16 == 0 and row_bytes <= FUSEDMM_RING_MAX_ROW_BYTES:
                variants.append("ring")
            for fn in ("identity", "relu"):
                # mean degree 7, or 40: more rows than the ring's stages
                ptrs, idxs = _csr(rng, rows, rows, 7 if fn == "identity"
                                  else 40, pad=5)
                args = (x, torch.from_numpy(ptrs).to(dev),
                        torch.from_numpy(idxs).to(dev))
                want = ref.fusedmm(*args, num_segments=rows, fn=fn)
                empty = torch.from_numpy(np.diff(ptrs) == 0).to(dev)
                for variant in variants:
                    if variant == "wrapper":
                        got = kops.fusedmm(*args, num_segments=rows, fn=fn)
                    else:
                        got = torch.empty_like(want)
                        kfusedmm.launch_variant(variant, *args, got, fn=fn)
                    what = f"fusedmm {dtype} E={emb} {fn} ({variant})"
                    if dtype == torch.float32:
                        err_f32 = max(err_f32, check_close(got, want, what,
                                                           **TOL_FMM_F32))
                    else:
                        _worst(bf16, check_bf16(got, want, what))
                    require(bool((got[empty] == 0).all()),
                            "fusedmm empty segments must be 0")
                    n += 1
    flat = torch.from_numpy(rng.standard_normal(300 * 64 + 1).astype(
        np.float32)).to(dev)
    x = flat[1:].view(300, 64)
    require(x.data_ptr() % 16 != 0, "unaligned view is aligned")
    ptrs, idxs = _csr(rng, 300, 300, 7)
    args = (x, torch.from_numpy(ptrs).to(dev), torch.from_numpy(idxs).to(dev))
    err_f32 = max(err_f32, check_close(
        kops.fusedmm(*args, num_segments=300),
        ref.fusedmm(*args, num_segments=300), "fusedmm unaligned",
        **TOL_FMM_F32))
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    require(kops.fusedmm(x, torch.zeros(1, dtype=torch.int32, device=dev), z,
                         num_segments=0).shape == (0, 64),
            "fusedmm with 0 segments")
    torch.cuda.synchronize()
    variants = _variant_delta("fusedmm", before)
    require(variants["ring"] > 0 and variants["rows"] > 0,
            f"the fusedmm sweep must run both variants: {variants}")
    print(f"[3 sweep fusedmm] {n} cases (wrapper, rows and ring) + 1 "
          f"unaligned table: max abs err "
          f"f32 {err_f32:.3g} (tol rtol=1e-4 atol=1e-3), bf16 "
          f"{_bf16_summary(bf16)}; variant launches {variants}; zero "
          f"segments ok")


def phase_sweep_flash(seed: int) -> None:
    """Flash attention against its plain version over the kernel's own KV
    tiles (``kv_tile``: 128 keys in bf16, 64 in f32): causal or not, GQA
    groups 1, 4, 16, (q/k, v) widths (64, 64), (80, 80) (the 128 kernel,
    padded), (128, 128) and (192, 128) (MLA), S 256, a ragged 200 and 200
    queries over 328 keys, f32 and bf16."""
    import torch
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.agreement import check_bf16
    from repro_torch.kernels.flash_attention import kv_tile
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    err_f32, bf16 = 0.0, {}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d, dv in FLASH_DIMS:
            for h, hkv in ((4, 4), (8, 2), (16, 1)):
                for sq, sk in ((256, 256), (200, 200), (200, 328)):
                    q = torch.randn((2, sq, h, d), generator=g,
                                    device=dev).to(dtype)
                    k = torch.randn((2, sk, hkv, d), generator=g,
                                    device=dev).to(dtype)
                    v = torch.randn((2, sk, hkv, dv), generator=g,
                                    device=dev).to(dtype)
                    for causal in (True, False):
                        got = kops.attention(q, k, v, causal=causal)
                        want = ref.attention(q, k, v, causal=causal,
                                             chunk=kv_tile(dtype))
                        what = (f"flash {dtype} D={d}/{dv} H={h}/{hkv} "
                                f"Sq={sq} Sk={sk} causal={causal}")
                        if dtype == torch.float32:
                            err_f32 = max(err_f32, check_close(
                                got, want, what, **TOL_ATTN_F32))
                        else:
                            _worst(bf16, check_bf16(got, want, what))
                        n += 1
    torch.cuda.synchronize()
    print(f"[3 sweep flash] {n} cases: max abs err f32 {err_f32:.3g} "
          f"(tol rtol=1e-5 atol=1e-5), bf16 {_bf16_summary(bf16)}")


def phase_stress_flash(seed: int) -> None:
    """The bf16 flash kernel against its plain version (over ``kv_tile``
    keys) in ``FLASH_STRESS_CASES`` causal cases of few-key rows: every case
    must pass ``check_bf16``.  Prints the worst readings over all cases and
    the elements off by more than 1.5 bf16 steps of their own size (a p
    rounded across a step)."""
    import torch
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.agreement import (BF16_ATOL, BF16_RTOL,
                                               bf16_agreement, check_bf16)
    from repro_torch.kernels.flash_attention import kv_tile
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    worst, fails, off = {}, [], 0
    for i in range(FLASH_STRESS_CASES):
        d, dv = FLASH_STRESS_DIMS[i % len(FLASH_STRESS_DIMS)]
        q, k, v = (torch.randn((2, 200, h, w), generator=g,
                               device=dev).bfloat16()
                   for h, w in ((16, d), (1, d), (1, dv)))
        got = kops.attention(q, k, v, causal=True)
        want = ref.attention(q, k, v, causal=True,
                             chunk=kv_tile(torch.bfloat16))
        _worst(worst, bf16_agreement(got, want))
        w = want.float().abs().clamp_min(1e-30)
        step = torch.exp2(torch.floor(torch.log2(w))) * 2 ** -7
        off += int(((got.float() - want.float()).abs() > 1.5 * step).sum())
        try:
            check_bf16(got, want, f"flash stress case {i} (D={d}/{dv})")
        except AssertionError as e:
            ratio = (got.float() - want.float()).abs() / (
                BF16_ATOL + BF16_RTOL * want.float().abs())
            row = int(ratio.amax(dim=(0, 2, 3)).argmax())
            fails.append(f"{e}; worst element in query row {row} "
                         f"({row + 1} keys)")
    print(f"[3 stress flash] {FLASH_STRESS_CASES} causal bf16 cases (2 x 200 "
          f"x 16/1 heads, (D, Dv) "
          f"{', '.join(map(str, FLASH_STRESS_DIMS))}): "
          f"{len(fails)} fail check_bf16; "
          f"{_bf16_summary(worst)}; {off} elements off by > 1.5 bf16 steps")
    require(not fails, "; ".join(fails[:3]))


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


def _device_time(fn) -> list:
    """Device time by kernel and copy of one call of ``fn`` under
    torch.profiler: [(name, microseconds)], largest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        fn()
        torch.cuda.synchronize()
    return sorted(((e.key, e.self_device_time_total)
                   for e in tp.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda kv: -kv[1])


def _busy(dev: list, wall_ms: float, top: int = 5) -> str:
    if not dev:
        return "device time not measured (the profiler saw no CUDA events)"
    busy_ms = sum(us for _, us in dev) / 1e3
    return (f"device busy {busy_ms:.4f} ms = {100 * busy_ms / wall_ms:.1f}% "
            f"of the {wall_ms:.3f} ms step (idle "
            f"{100 - 100 * busy_ms / wall_ms:.1f}%): " +
            ", ".join(f"{k[:40]} {us / 1e3:.4f} ms" for k, us in dev[:top]))


def _where_the_time_goes(ex, ins, step_ms: float, top: int = 5) -> str:
    """Two more steps, one under cProfile (the host functions with the most
    own time) and one under torch.profiler (device time by kernel and copy,
    and its share of the unprofiled ``step_ms``)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.runcall(ex.step, ins)
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:top]
    host = ", ".join(f"{fn[2]} {tt * 1e3:.2f} ms"
                     for fn, (_, _, tt, _, _) in rows)
    device = _busy(_device_time(lambda: ex.step(ins)), step_ms, top)
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
              "variant": "sls_kernel",
              "launches": counts["sls"], "max_abs_err": err, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
              "library_ms": library_ms, "held_against_plain": True}
    del ex, u, tables, steps, outs, args, kw, got, dev_in, gidx, seg
    free_cuda()
    return result


# ---------------------------------------------------------------------------
# Phase 5: DeepSeek-V2-Lite LM step lookups
# ---------------------------------------------------------------------------

def phase_deepseek(seed: int, n_steps: int, card: str) -> dict:
    import torch
    from repro_torch.configs.deepseek_v2_lite_16b import config
    from repro_torch.core.executor import executor_for
    from repro_torch.kernels import _build, gather as kgather, ops as kops, ref
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
    variants = kops.variant_launch_counts()["block_gather"]
    require(counts["block_gather"] == n_steps and
            variants == {"bulk": n_steps, "group": n_steps, "rows": 0},
            f"DeepSeek main path launched block_gather "
            f"{counts['block_gather']} times ({variants}), expected the bulk "
            f"variant and its grouping pass {n_steps} times each")
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
          f"{counts['block_gather']} (bulk {variants['bulk']}, grouping "
          f"pass {variants['group']}); compile {compile_s:.2f} s; step 1 "
          f"{times[0] * 1e3:.2f} ms, steps 2-{n_steps} mean "
          f"{np.mean(times[1:]) * 1e3:.3f} ms (submit alone "
          f"{np.mean(submit[1:]) * 1e3:.3f} ms); every op == plain per-op "
          f"gather (bit-exact)")
    print(f"[5 deepseek where] "
          f"{_where_the_time_goes(ex, steps[-1], np.mean(times[1:]) * 1e3)}")
    row_bytes = cfg.d_model * 4
    lib = _build.library()

    def fused_gather(step):
        """The fused unit's kernel at one step's ids, held bit-exact to the
        plain version, index_select and the rows variant: (idxs, roff, max
        abs error, the kernel's ms, index_select's ms, the rows variant's
        ms, distinct rows, the bytes that must move, the bound in ms)."""
        fused = u.plan.fused_index_inputs(step)
        idxs = torch.from_numpy(np.ascontiguousarray(fused["idxs"])).cuda()
        roff = torch.from_numpy(np.ascontiguousarray(fused["roff"])).cuda()
        got = kops.block_gather(u.table, idxs, roff=roff)
        err = check_close(got, ref.block_gather(u.table, idxs, roff=roff),
                          "fused DeepSeek gather unit")
        rows = idxs.long() + roff.long()
        check_close(torch.index_select(u.table, 0, rows), got[:, 0],
                    "torch.index_select vs kernel")
        # the rows variant (the kernel before the bulk one), launched as the
        # wrapper launches it, on the same inputs
        rows_out = torch.empty_like(got)

        def rows_variant():
            kgather.launch_variant("rows", u.table, idxs, rows_out, roff=roff)
        rows_variant()
        check_close(rows_out, got, "gather rows variant vs bulk")
        ms = time_ms(lambda: kops.block_gather(u.table, idxs, roff=roff), 50)
        library_ms = time_ms(lambda: torch.index_select(u.table, 0, rows), 50)
        rows_ms = time_ms(rows_variant, 50)
        uniq = _unique_rows(fused["idxs"], fused["roff"])
        nbytes = uniq * row_bytes + segs * 8 + segs * row_bytes
        return (idxs, roff, err, ms, library_ms, rows_ms, uniq, nbytes,
                nbytes / HBM_BYTES_PER_S * 1e3)

    idxs, roff, err, ms, library_ms, rows_ms, uniq, nbytes, bound_ms = \
        fused_gather(steps[-1])
    plain_ms = time_ms(lambda: ref.block_gather(u.table, idxs, roff=roff), 20)
    scratch = torch.empty(lib.ember_gather_scratch_bytes(segs),
                          dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    group_ms = time_ms(lambda: lib.ember_gather_group(
        idxs.data_ptr(), roff.data_ptr(), scratch.data_ptr(), segs, stream),
        50)
    src = torch.empty((segs, cfg.d_model), device="cuda")
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), 50)
    copy_bytes = 2 * src.numel() * 4
    del scratch, src, dst
    peak = torch.cuda.max_memory_allocated()
    print(f"[5 deepseek kernel] fused gather {segs} rows ({uniq} distinct): "
          f"kernel {ms:.4f} ms (bulk variant; its grouping pass alone "
          f"{group_ms:.4f} ms; the rows variant {rows_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms, torch.index_select {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s; "
          f"kernel at {nbytes / ms / 1e6:.0f} GB/s); bit-exact vs plain; "
          f"dst.copy_(src) of the output's {copy_bytes / 2e9:.3f} GB "
          f"{copy_ms:.4f} ms ({copy_bytes / copy_ms / 1e9:.3f} TB/s read + "
          f"written); peak device memory {peak / 2**30:.2f} GiB; {card}")
    # a realistic id stream: Zipf(1.05) token ids over the vocabulary, the
    # labels the same tokens shifted by one, the MoE dispatch a random
    # permutation of the capacity slots, each filled once
    zipf = np.arange(1, cfg.vocab_size + 1, dtype=np.float64) ** -1.05
    token_of_rank = rng.permutation(cfg.vocab_size)
    stream_ids = token_of_rank[rng.choice(cfg.vocab_size, batch * seq + 1,
                                          p=zipf / zipf.sum())]
    real = {"tok_embed": stream_ids[:-1],
            "label_gather": stream_ids[1:],
            "moe_dispatch": rng.permutation(
                ops["moe_dispatch"].num_embeddings)[
                    :ops["moe_dispatch"].num_segments]}
    real_step = {name: {"table": tables[name],
                        "idxs": real[name].astype(np.int32)}
                 for name, _ in prog.ops}
    _, _, _, z_ms, z_library_ms, z_rows_ms, z_uniq, z_bytes, z_bound_ms = \
        fused_gather(real_step)
    print(f"[5 deepseek zipf] the same unit on a realistic stream (Zipf(1.05) "
          f"token ids, labels shifted by one, MoE dispatch a permutation of "
          f"the capacity slots): {segs} rows ({z_uniq} distinct): kernel "
          f"{z_ms:.4f} ms (bulk variant; the rows variant {z_rows_ms:.4f} "
          f"ms), torch.index_select {z_library_ms:.4f} ms, bound "
          f"{z_bound_ms:.4f} ms ({z_bytes / 1e6:.1f} MB); bit-exact vs plain; "
          f"{card}")
    result = {"name": "block_gather", "route": "cuda",
              "source": "src/repro_torch/csrc/ember_kernels.cu",
              "replaces": "src/repro/kernels/gather.py:32",
              "variant": "gather_bulk_kernel",
              "launches": variants["bulk"],
              "group_launches": variants["group"], "max_abs_err": err,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": "bytes", "library_ms": library_ms,
              "group_ms": group_ms, "rows_variant_ms": rows_ms,
              "copy_ms": copy_ms,
              "zipf_ms": z_ms, "zipf_library_ms": z_library_ms,
              "zipf_rows_variant_ms": z_rows_ms,
              "zipf_bound_ms": z_bound_ms, "held_against_plain": True}
    del ex, u, tables, embed, capacity, steps, outs, idxs, roff, real_step
    free_cuda()
    return result


# ---------------------------------------------------------------------------
# Phase 6: GNN message passing (FusedMM) at ogbn-products scale
# ---------------------------------------------------------------------------

def _fusedmm_plain_in_chunks(x, ptrs, idxs, out=None, what: str = ""):
    """The plain version over every segment, CHUNK segments at a time (at
    full size its gathered neighbour rows alone would be 49.5 GB).  Holds
    ``out`` against it when given; returns the max abs error."""
    from repro_torch.kernels import ref
    n = ptrs.numel() - 1
    err = 0.0
    for lo in range(0, n, GNN_CHECK_SEGMENTS):
        hi = min(lo + GNN_CHECK_SEGMENTS, n)
        want = ref.fusedmm(x, ptrs[lo:hi + 1], idxs, num_segments=hi - lo,
                           first_segment=lo)
        if out is not None:
            err = max(err, check_close(out[lo:hi], want,
                                       f"{what} segments {lo}:{hi}",
                                       **TOL_GNN))
    return err


def _fusedmm_variants_ms(x, ptrs, idxs, iters: int) -> dict:
    """Both FusedMM variants on x, each launched as the wrapper launches it:
    the rows variant held to the ring (TOL_GNN, or check_bf16) in chunks of
    segments, then each timed (ms)."""
    import torch
    from repro_torch.kernels import fusedmm as kfusedmm
    from repro_torch.kernels.agreement import check_bf16
    n = ptrs.numel() - 1
    outs = {v: torch.empty((n, x.shape[1]), dtype=x.dtype, device=x.device)
            for v in ("ring", "rows")}
    for v, out in outs.items():
        kfusedmm.launch_variant(v, x, ptrs, idxs, out)
    for lo in range(0, n, GNN_CHECK_SEGMENTS):
        got = outs["rows"][lo:lo + GNN_CHECK_SEGMENTS]
        want = outs["ring"][lo:lo + GNN_CHECK_SEGMENTS]
        what = (f"fusedmm rows variant vs ring ({x.dtype}, E={x.shape[1]}, "
                f"segments from {lo})")
        if x.dtype == torch.bfloat16:
            check_bf16(got, want, what)
        else:
            check_close(got, want, what, **TOL_GNN)
    return {v: time_ms(lambda v=v, out=out: kfusedmm.launch_variant(
        v, x, ptrs, idxs, out), iters) for v, out in outs.items()}


def phase_gnn(seed: int, n_steps: int, card: str) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.core.executor import executor_for
    from repro_torch.core.ops import EmbeddingOp, EmbeddingProgram
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.sls import kernel_variant
    torch.cuda.reset_peak_memory_stats()
    n, e = OGBN_NODES, OGBN_FEATURES
    prog = EmbeddingProgram("ogbn-products-mp", (
        ("mp", EmbeddingOp("fusedmm", n, n, e,
                           avg_lookups=round(OGBN_DIRECTED_EDGES / n))),))
    t0 = time.perf_counter()
    ex = executor_for(prog, "O3")
    compile_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    ptrs = np.zeros(n + 1, np.int32)
    np.cumsum(rng.poisson(OGBN_DIRECTED_EDGES / n, n), out=ptrs[1:])
    nnz = int(ptrs[-1])
    idxs = rng.integers(0, n, nnz, dtype=np.int32)
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = [torch.randn((n, e), generator=g, device="cuda")
          for _ in range(n_steps)]          # fresh features every step
    steps = [{"mp": {"x": x, "ptrs": ptrs, "idxs": idxs}} for x in xs]
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    outs, times, submit, counts = _time_steps(ex, steps)
    variants = kops.variant_launch_counts()["fusedmm"]
    # at 400-byte rows the rows variant is the faster (the ring takes rows
    # from kernels.sls.FUSEDMM_RING_MIN_ROW_BYTES on; [6 gnn widths] below)
    variant = kernel_variant("fusedmm", e, 4, True)
    require(counts["fusedmm"] == n_steps and variant == "rows" and
            variants == {"ring": 0, "rows": n_steps},
            f"GNN main path launched fusedmm {counts['fusedmm']} times "
            f"({variants}), expected the rows variant {n_steps} times")
    require(ex.stats["table_rebinds"] == n_steps - 1,
            "fresh x every step must rebind the dense operand")
    dptrs = torch.from_numpy(ptrs).cuda()
    didxs = torch.from_numpy(idxs).cuda()
    err = 0.0
    for i, (x, out) in enumerate(zip(xs, outs)):
        err = max(err, _fusedmm_plain_in_chunks(x, dptrs, didxs, out["mp"],
                                                f"GNN step {i}"))
    step_ms = np.mean(times[1:]) * 1e3
    print(f"[6 gnn] ogbn-products sizes, synthetic graph (Poisson degrees, "
          f"mean {OGBN_DIRECTED_EDGES / n:.2f}, uniform neighbours): {n} "
          f"nodes, {nnz} CSR entries, {e} fp32 features; {n_steps} steps of "
          f"1 fusedmm unit, fresh x each step; fusedmm launches "
          f"{counts['fusedmm']} ({variant} variant {variants[variant]}); "
          f"compile {compile_s:.2f} s, data {data_s:.2f} "
          f"s; step 1 {times[0] * 1e3:.2f} ms, steps 2-{n_steps} mean "
          f"{step_ms:.3f} ms (submit alone {np.mean(submit[1:]) * 1e3:.3f} "
          f"ms; pinned staging {ex.pool.stats['bytes'] / 1e9:.2f} GB); every "
          f"step == plain version in chunks of {GNN_CHECK_SEGMENTS} segments "
          f"(max abs err {err:.3g}, tol rtol=1e-4 atol=1e-2)")
    print(f"[6 gnn where] {_where_the_time_goes(ex, steps[-1], step_ms)}")
    x = xs[-1]

    def kernel():
        return kops.fusedmm(x, dptrs, didxs, num_segments=n)
    ms = time_ms(kernel, 10)
    # both variants on the same inputs, and at other row widths of the same
    # graph: where the ring overtakes the rows variant
    both = _fusedmm_variants_ms(x, dptrs, didxs, 10)
    widths = {}
    for dtype, sweep in zip((torch.float32, torch.bfloat16),
                            GNN_SWEEP_WIDTHS):
        for width in sweep:
            xw = torch.randn((n, width), generator=g, device="cuda").to(dtype)
            widths[dtype, width] = _fusedmm_variants_ms(xw, dptrs, didxs, 5)
            del xw
    t0 = time.perf_counter()
    _fusedmm_plain_in_chunks(x, dptrs, didxs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    nbytes = n * e * 4 + nnz * 4 + (n + 1) * 4 + n * e * 4
    flops = 4 * e * nnz          # dot + axpy per neighbour row
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    # on this graph (uniform neighbours, L2 holds ~5 % of x) nearly every
    # neighbour row comes from HBM: its bytes, and the 32-byte sectors a row
    # at its alignment in x touches
    row = e * 4
    no_l2_ms = nnz * row / HBM_BYTES_PER_S * 1e3
    sectors = np.mean([(j * row % 32 + row + 31) // 32 for j in range(32)])
    sectors_ms = nnz * sectors * 32 / HBM_BYTES_PER_S * 1e3
    # yardsticks: the same scattered reads without the dot (not the same
    # function), and the rate a contiguous copy streams on this card
    lidx = didxs.long()
    offsets = dptrs[:-1].long()

    def same_reads():
        return F.embedding_bag(lidx, x, offsets, mode="sum")
    bag_ms = time_ms(same_reads, 5)
    del lidx, offsets
    dst = torch.empty_like(x)
    copy_ms = time_ms(lambda: dst.copy_(x), 20)
    copy_tbs = 2 * x.numel() * 4 / copy_ms / 1e9
    del dst
    peak = torch.cuda.max_memory_allocated()
    print(f"[6 gnn kernel] fusedmm {n} segments, {nnz} lookups of {row} B "
          f"rows: kernel {ms:.4f} ms ({variant} variant; rows "
          f"{both['rows']:.4f} ms, ring {both['ring']:.4f} ms), plain "
          f"{plain_ms:.1f} ms (in chunks, "
          f"host clock), library none (no single PyTorch call computes "
          f"FusedMM); bound {bound_ms:.4f} ms = max(bytes once "
          f"{nbytes / 1e9:.3f} GB / 3.35 TB/s = {bytes_ms:.4f} ms, "
          f"{flops / 1e9:.2f} GFLOP / 67 TFLOP/s fp32 = {flops_ms:.4f} ms); "
          f"on this graph every neighbour row from HBM "
          f"({nnz * row / 1e9:.1f} GB) would take {no_l2_ms:.2f} ms, "
          f"{sectors_ms:.2f} ms in the {sectors:.2f} 32-byte sectors a row "
          f"touches (kernel at {nnz * row / ms / 1e9:.3f} TB/s of row "
          f"bytes); F.embedding_bag(mode='sum') over the same ptrs/idxs and "
          f"x (the same scattered reads without the dot, not the same "
          f"function) {bag_ms:.4f} ms; dst.copy_(x) of {x.numel() * 4 / 1e9:.3f}"
          f" GB {copy_ms:.4f} ms ({copy_tbs:.3f} TB/s read + written); peak "
          f"device memory {peak / 2**30:.2f} GiB; {card}")
    print("[6 gnn widths] the same graph at other widths, ring vs rows "
          "variant (ms): " + ", ".join(
              f"{str(dt)[6:]} E={w} ({w * dt.itemsize} B) {t['ring']:.4f} vs "
              f"{t['rows']:.4f}" for (dt, w), t in widths.items()) +
          f"; {card}")
    result = {"name": "fusedmm", "route": "cuda",
              "source": "src/repro_torch/csrc/ember_fusedmm.cu",
              "replaces": "src/repro/kernels/fusedmm.py:41",
              "variant": "fusedmm_kernel",
              "launches": variants[variant], "max_abs_err": err, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
              "library_ms": None, "rows_variant_ms": both["rows"],
              "ring_variant_ms": both["ring"],
              "ring_vs_rows_ms_by_width": {
                  f"{str(dt)[6:]} E={w}": [t["ring"], t["rows"]]
                  for (dt, w), t in widths.items()},
              "hbm_rows_ms": no_l2_ms,
              "hbm_sectors_ms": sectors_ms, "same_reads_bag_ms": bag_ms,
              "copy_tb_per_s": copy_tbs, "held_against_plain": True}
    del ex, xs, steps, outs, x, dptrs, didxs
    free_cuda()
    return result


# ---------------------------------------------------------------------------
# Phase 7: chatglm3-6b prefill (flash attention in every layer)
# ---------------------------------------------------------------------------

class _OpSwap:
    """Route one of the model's entry points through ``fn`` while active:
    ``kernels.ops.<name>`` by default (which the model modules look up at
    each call: ``attention``, ``block_gather``), or ``<module>.<name>``
    (``models.moe.route``): a plain version for a whole-prefill comparison,
    a recorder of a layer's inputs, or a replay of recorded decisions."""

    def __init__(self, name: str, fn, module=None):
        self.name, self.fn, self.module = name, fn, module

    def __enter__(self):
        if self.module is None:
            from repro_torch.kernels import ops as kops
            self.module = kops
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.fn)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)
        return False


def phase_chatglm3(seed: int) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.agreement import bf16_agreement, check_bf16
    from repro_torch.kernels.flash_attention import kv_tile
    from repro_torch.models.lm import LM
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("chatglm3-6b")
    t0 = time.perf_counter()
    model = LM(cfg, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ))).cuda()

    model.prefill(tokens)          # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    times, last = [], None
    for _ in range(PREFILLS):
        t0 = time.perf_counter()
        last = model.prefill(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = kops.launch_counts()
    require(counts["flash_attention"] == PREFILLS * cfg.num_layers,
            f"chatglm3 prefill launched flash_attention "
            f"{counts['flash_attention']} times, expected "
            f"{PREFILLS * cfg.num_layers}")
    require(last.shape == (PREFILL_BATCH, 1, cfg.d_model) and
            bool(torch.isfinite(last).all()), "prefill output")
    prefill_ms = float(np.mean(times)) * 1e3
    dev = _device_time(lambda: model.prefill(tokens))
    attn_us = sum(us for k, us in dev if "flash" in k)

    def plain(q, k, v, **kw):
        """The plain version over the kernel's KV tiles."""
        return ref.attention(q, k, v, **{**kw, "chunk": kv_tile(q.dtype)})

    # one more prefill through the kernel, every layer's attention output
    # held against the plain version on that layer's own q, k, v
    per_layer, first = [], []

    def held(q, k, v, **kw):
        out = kops.flash_attention_cuda(q, k, v, **kw)
        per_layer.append(check_bf16(
            out, plain(q, k, v, **kw),
            f"flash kernel on layer {len(per_layer)}'s q, k, v"))
        if not first:
            first.append((q, k, v, kw))
        return out
    with _OpSwap("attention", held):
        model.prefill(tokens)
    require(len(per_layer) == cfg.num_layers, "one attention call per layer")
    layers = {}
    for a in per_layer:
        _worst(layers, a)
    err = layers["max_abs"]

    with _OpSwap("attention", plain):
        plain_last = model.prefill(tokens)
    diff = (last.float() - plain_last.float())
    rel_l2 = float(diff.norm() / plain_last.float().norm())
    require(rel_l2 <= PREFILL_REL_L2 and bool(torch.isfinite(diff).all()),
            f"prefill with the kernel vs plain attention: relative L2 "
            f"{rel_l2:.3g} > {PREFILL_REL_L2}")

    q, k, v, kw = first.pop()
    b, s, h, d = q.shape
    hkv = k.shape[2]

    def kernel():
        return kops.attention(q, k, v, causal=True)
    ms = time_ms(kernel, 10)
    plain_ms = time_ms(lambda: ref.attention(q, k, v, **kw), 2, warmup=1)
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib = bf16_agreement(library().transpose(1, 2), kernel())
    require(lib["rel_l2"] <= LIBRARY_REL_L2_BF16,
            f"scaled_dot_product_attention vs kernel: relative L2 "
            f"{lib['rel_l2']:.3g} > 2^-7")
    library_ms = time_ms(library, 10)
    flops = 2 * b * h * s * s * d        # causal QK^T and PV
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms = max(flops / BF16_TC_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_by = ("operations" if flops / BF16_TC_FLOPS >=
                nbytes / HBM_BYTES_PER_S else "bytes")
    del q, k, v, qt, kt, vt

    # one sequence of prefill_32k, the kernel alone
    g = torch.Generator(device="cuda").manual_seed(seed)
    ql = torch.randn((1, LONG_SEQ, h, d), generator=g,
                     device="cuda").bfloat16()
    kl = torch.randn((1, LONG_SEQ, hkv, d), generator=g,
                     device="cuda").bfloat16()
    vl = torch.randn((1, LONG_SEQ, hkv, d), generator=g,
                     device="cuda").bfloat16()
    long_ms = time_ms(lambda: kops.attention(ql, kl, vl, causal=True), 3,
                      warmup=1)
    qlt = ql.transpose(1, 2)
    klt = kl.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    vlt = vl.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    long_lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qlt, klt, vlt, is_causal=True), 3, warmup=1)
    long_bound_ms = 2 * h * LONG_SEQ ** 2 * d / BF16_TC_FLOPS * 1e3
    del ql, kl, vl, qlt, klt, vlt
    peak = torch.cuda.max_memory_allocated()
    print(f"[7 chatglm3 prefill] {cfg.name} {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} "
          f"KV, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16, {n_params} "
          f"params (random, seed {seed}; init {init_s:.2f} s); "
          f"{PREFILL_BATCH} x {PREFILL_SEQ} uniform token ids: prefill mean "
          f"{prefill_ms:.2f} ms over {PREFILLS} (host clock + synchronize); "
          f"flash_attention launches {counts['flash_attention']}; "
          f"{_busy(dev, prefill_ms)}; attention kernels "
          f"{attn_us / 1e3:.2f} ms of it; every layer's kernel output == "
          f"plain on its own q, k, v ({cfg.num_layers} layers: "
          f"{_bf16_summary(layers)}); last hidden state == prefill with "
          f"plain attention (relative L2 {rel_l2:.3g}, max abs "
          f"{float(diff.abs().max()):.3g}, tol relative L2 "
          f"{PREFILL_REL_L2}); peak device memory {peak / 2**30:.2f} GiB")
    print(f"[7 chatglm3 kernel] flash attention per layer (B={b}, S={s}, "
          f"H={h}, Hkv={hkv}, D={d}, causal, bf16): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, scaled_dot_product_attention (KV heads "
          f"expanded beforehand) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({flops / 1e12:.3f} TFLOP at 989 TFLOP/s; kernel at "
          f"{flops / ms / 1e9:.1f} TFLOP/s; vs the library: "
          f"{_bf16_summary(lib)}); prefill_32k sequence (B=1, "
          f"S={LONG_SEQ}): kernel {long_ms:.3f} ms, "
          f"scaled_dot_product_attention {long_lib_ms:.3f} ms, bound "
          f"{long_bound_ms:.3f} ms")
    result = {"name": "flash_attention", "route": "cuda",
              "source": "src/repro_torch/csrc/ember_flash_attention.cu",
              "replaces": "src/repro/kernels/flash_attention.py:65",
              "variant": "flash_wgmma_kernel",
              "launches": counts["flash_attention"], "max_abs_err": err,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": library_ms,
              "held_against_plain": True}
    del model, tokens, last, plain_last, diff, per_layer
    free_cuda()
    return result


def phase_stablelm_prefill(seed: int) -> dict:
    """stablelm-3b (head dim 80: the flash kernels' 128-wide instantiation
    on zero-padded columns) through ``LM.prefill`` over the chatglm3
    prefill's 4 x 4096 tokens: one prefill on the main path (a flash
    launch in every layer), more timed; layer 0's kernel output held
    against the plain version on its own q, k, v; the kernel's time at
    that layer's shapes beside its bound at the true width, the plain
    version and ``scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.agreement import bf16_agreement, check_bf16
    from repro_torch.kernels.flash_attention import kv_tile
    from repro_torch.models.lm import LM
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("stablelm-3b")
    t0 = time.perf_counter()
    model = LM(cfg, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed + 1)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ))).cuda()
    model.prefill(tokens)          # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()

    # the main path: one prefill, launches counted from 0
    kops.reset_launch_counts()
    times = []
    t0 = time.perf_counter()
    last = model.prefill(tokens)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
    launches = kops.launch_counts()["flash_attention"]
    require(launches == cfg.num_layers,
            f"stablelm-3b prefill launched flash_attention {launches} times, "
            f"expected {cfg.num_layers}")
    require(last.shape == (PREFILL_BATCH, 1, cfg.d_model) and
            bool(torch.isfinite(last).all()), "stablelm-3b prefill output")
    for _ in range(PREFILLS - 1):
        t0 = time.perf_counter()
        model.prefill(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prefill_ms = float(np.mean(times)) * 1e3
    dev = _device_time(lambda: model.prefill(tokens))
    attn_us = sum(us for k, us in dev if "flash" in k)

    # layer 0's q, k, v from one more prefill through the kernel
    first = []

    def record(q, k, v, **kw):
        if not first:
            first.append((q, k, v, kw))
        return kops.flash_attention_cuda(q, k, v, **kw)
    with _OpSwap("attention", record):
        again = model.prefill(tokens)
    require(torch.equal(again, last), "stablelm-3b prefill is not repeatable")
    q, k, v, kw = first.pop()
    b, s, h, d = q.shape
    hkv = k.shape[2]
    require(d == 80, f"stablelm-3b head dim {d}, expected 80")

    def kernel():
        return kops.attention(q, k, v, causal=True)

    def plain():
        return ref.attention(q, k, v, **{**kw, "chunk": kv_tile(q.dtype)})
    layer0 = check_bf16(kernel(), plain(),
                        "flash kernel on stablelm-3b layer 0's q, k, v")
    ms = time_ms(kernel, 10)
    plain_ms = time_ms(plain, 2, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # MHA: no expand

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib = bf16_agreement(library().transpose(1, 2), kernel())
    require(lib["rel_l2"] <= LIBRARY_REL_L2_BF16,
            f"scaled_dot_product_attention vs kernel at D = 80: relative L2 "
            f"{lib['rel_l2']:.3g} > 2^-7")
    library_ms = time_ms(library, 10)
    flops = 2 * b * h * s * s * d        # causal QK^T and PV, true width
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms = max(flops / BF16_TC_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"[7 stablelm-3b prefill] {cfg.name} {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads / "
          f"{cfg.num_kv_heads} KV, head dim {d}, rotary {cfg.rotary_pct}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16, {n_params} params "
          f"(random, seed {seed}; init {init_s:.2f} s); {PREFILL_BATCH} x "
          f"{PREFILL_SEQ} uniform token ids: prefill mean {prefill_ms:.2f} ms "
          f"over {PREFILLS} (host clock + synchronize); flash_attention "
          f"launches {launches} in the first; {_busy(dev, prefill_ms)}; "
          f"attention kernels {attn_us / 1e3:.2f} ms of it; peak device "
          f"memory {peak / 2**30:.2f} GiB")
    print(f"[7 stablelm-3b kernel] flash attention per layer (B={b}, S={s}, "
          f"H={h}, Hkv={hkv}, D={d} on the 128-wide kernel, causal, bf16): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({flops / 1e12:.3f} TFLOP at the true width at "
          f"989 TFLOP/s; kernel at {flops / ms / 1e9:.1f} TFLOP/s of true-"
          f"width work); layer 0 kernel == plain ({_bf16_summary(layer0)}); "
          f"vs the library: {_bf16_summary(lib)}")
    result = {"launches": launches, "d80_ms": ms, "d80_plain_ms": plain_ms,
              "d80_bound_ms": bound_ms, "d80_library_ms": library_ms,
              "d80_max_abs_err": layer0["max_abs"],
              "stablelm_prefill_ms": prefill_ms}
    del model, tokens, last, again, q, k, v, qt, kt, vt
    free_cuda()
    return result


# ---------------------------------------------------------------------------
# Phase 8: chatglm3-6b and stablelm-3b served through DecodeServer
# ---------------------------------------------------------------------------

def _percentiles(xs) -> str:
    a = np.asarray(xs, np.float64) * 1e3
    return (f"p50 {np.percentile(a, 50):.2f} ms, p99 "
            f"{np.percentile(a, 99):.2f} ms")


def _serve_drive(model, prompts, chunk: int,
                 new_tokens: int = SERVE_NEW_TOKENS) -> dict:
    """Serve ``prompts`` (``new_tokens`` each, no EOS) through a fresh
    DecodeServer on the card (its captured wave), one serving iteration at
    a time.  Returns the server, the requests, the wall seconds, each
    request's logits row of its last wave (``final``), and per iteration
    its wave kind, micro-steps and host seconds (the whole iteration: the
    wave, the pipeline feed and the argmax read back; and the server's
    wave alone, issuing the wave's work)."""
    import torch
    from repro_torch.runtime.server import DecodeServer, Request, WaveGraph
    srv = DecodeServer(model, batch_slots=SERVE_SLOTS,
                       max_len=SERVE_MAX_LEN, prefill_chunk=chunk,
                       pipeline=True)
    require(isinstance(srv._wave, WaveGraph),
            "a server on the card must run its captured wave")
    reqs = [Request(prompt=p.copy(), max_new_tokens=new_tokens)
            for p in prompts]
    index = {id(r): i for i, r in enumerate(reqs)}
    out = {"srv": srv, "reqs": reqs, "final": {}, "iters": []}
    wave = srv._wave
    issued = []

    def spy(tokens, lens, caches):
        t0 = time.perf_counter()
        logits, caches = wave(tokens, lens, caches)
        issued.append((int(lens.max()), time.perf_counter() - t0))
        for i, req in enumerate(srv.active):
            if req is not None and lens[i] > 0:
                out["final"][index[id(req)]] = logits[i]
        return logits, caches
    srv._wave = spy
    t0 = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    while srv.queue or any(r is not None for r in srv.active):
        pre = srv.serve_stats["prefill_waves"]
        t1 = time.perf_counter()
        srv.step()
        kind = ("prefill" if srv.serve_stats["prefill_waves"] > pre
                else "decode")
        micro, issue_s = issued[-1]
        out["iters"].append((kind, micro, time.perf_counter() - t1,
                             issue_s))
    srv.run_until_drained()          # drains the group, final stats
    torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t0
    srv._wave = wave
    return out


def _lockstep_drive(model, prompts, new_tokens: int, gather=None) -> dict:
    """Serve ``prompts`` through two servers stepped in turn: one replays
    its captured graphs, the other runs ``LM.wave_step`` and
    ``LM.reset_slots`` eagerly on its own caches.  After every serving
    iteration the two waves' logits and every cache leaf must be the same
    bits, and at the end every request's tokens.  ``gather``, if given,
    stands in for ``kernels.ops.block_gather`` once both servers are built
    (their graphs hold the kernel as served): every gather launched
    eagerly, in the eager wave and in both servers' pipeline members, runs
    through it.  Returns the servers, the waves, the micro-steps, the
    leaves compared and each server's host seconds inside its waves."""
    import torch
    from repro_torch.runtime.server import DecodeServer, Request
    servers = {n: DecodeServer(model, batch_slots=SERVE_SLOTS,
                               max_len=SERVE_MAX_LEN,
                               prefill_chunk=SERVE_CHUNK, pipeline=True)
               for n in ("graph", "eager")}
    servers["eager"]._wave = model.wave_step
    servers["eager"]._reset = model.reset_slots
    last, host, micro = {}, {"graph": 0.0, "eager": 0.0}, []
    for name, srv in servers.items():
        def spy(tokens, lens, caches, wave=srv._wave, name=name):
            t0 = time.perf_counter()
            logits, caches = wave(tokens, lens, caches)
            host[name] += time.perf_counter() - t0
            last[name] = logits
            if name == "graph":
                micro.append(int(lens.max()))
            return logits, caches
        srv._wave = spy
    reqs = {n: [Request(prompt=p.copy(), max_new_tokens=new_tokens)
                for p in prompts] for n in servers}
    for n, srv in servers.items():
        for r in reqs[n]:
            srv.submit(r)
    graph, eager = servers["graph"], servers["eager"]
    waves = leaves = 0
    with (_OpSwap("block_gather", gather) if gather is not None
          else contextlib.nullcontext()):
        while graph.queue or any(r is not None for r in graph.active):
            graph.step()
            eager.step()
            waves += 1
            require(torch.equal(last["graph"], last["eager"]),
                    f"wave {waves}: the graph's logits differ from the "
                    f"eager wave's")
            for layer, (cg, ce) in enumerate(zip(graph.caches,
                                                 eager.caches)):
                for k in cg:
                    require(torch.equal(cg[k], ce[k]),
                            f"after wave {waves}: cache leaf {k} of layer "
                            f"{layer} differs between graph and eager")
                    leaves += 1
    require(not eager.queue and all(r is None for r in eager.active) and
            eager.serve_stats["waves"] == waves,
            "the eager server's schedule differs from the graph server's")
    for i, (g, e) in enumerate(zip(reqs["graph"], reqs["eager"])):
        require(g.status == e.status == "ok" and g.out == e.out and
                len(g.out) == new_tokens,
                f"request {i}: graph drive emitted {g.out[:6]}... "
                f"({g.status}), eager {e.out[:6]}... ({e.status})")
    return {"servers": servers, "waves": waves, "micro_steps": sum(micro),
            "leaves": leaves, "host_s": host, "reqs": reqs["graph"]}


def _graph_device_ms(srv, iters: int = 20) -> dict:
    """Device ms of one replay of each captured micro-step (CUDA events;
    the masked form with every slot active), on a drained server's caches,
    which the replays overwrite."""
    import torch
    wave = srv._wave
    with torch.inference_mode():         # the buffers are inference tensors
        wave.active.fill_(True)
    return {"unmasked": time_ms(wave.graphs["micro-step"].replay, iters),
            "masked": time_ms(wave.graphs["masked micro-step"].replay,
                              iters)}


def _graph_issue_ms(srv, iters: int = 20) -> float:
    """Host ms to issue one replay of the captured micro-step onto an idle
    device (synchronised before each): the launch alone, without waiting
    for room in the device's queue, which a running drive's issue time
    includes."""
    import torch
    replay = srv._wave.graphs["micro-step"].replay
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total * 1e3 / iters


def _drive_metrics(main: dict, new_tokens: int) -> dict:
    reqs, wall, iters = main["reqs"], main["wall"], main["iters"]
    micro_steps = sum(m for _, m, _, _ in iters)
    return {
        "tokens_per_s": len(reqs) * new_tokens / wall,
        "ttft": [r.t_first - r.t_submit for r in reqs],
        "per_token": [b - a for r in reqs
                      for a, b in zip(r.token_times, r.token_times[1:])],
        "decode_ms": [dt * 1e3 for k, _, dt, _ in iters if k == "decode"],
        "prefill_ms": [dt * 1e3 for k, _, dt, _ in iters if k == "prefill"],
        "micro_steps": micro_steps,
        "issue_ms": sum(i for _, _, _, i in iters) * 1e3}


def _require_served(main: dict, new_tokens: int, counts: dict,
                    variants: dict) -> None:
    """(a) every request ok with its tokens; (f) the decode-embed gather
    once a wave: bulk variant + grouping pass."""
    srv, reqs = main["srv"], main["reqs"]
    waves = srv.serve_stats["waves"]
    require(all(r.status == "ok" and len(r.out) == new_tokens
                for r in reqs),
            f"served: not every request ended ok with {new_tokens} tokens: "
            f"{[(r.status, len(r.out)) for r in reqs]}")
    require(variants == {"bulk": waves, "group": waves, "rows": 0} and
            counts["block_gather"] == waves,
            f"served {waves} waves but block_gather launched "
            f"{counts['block_gather']} times ({variants})")
    gs = srv.compile_stats["pipeline_group"]
    require(gs["waves"] == waves, f"pipeline group saw {gs['waves']} waves "
            f"of {waves}")


def _profiled_drive(model, prompts, new_tokens: int) -> dict:
    """Device busy share over a drive: the same drive again (the same
    waves: with no deadline the schedule does not depend on time) under
    torch.profiler, device events only, summed from the raw events.
    Returns the device time by name (ns, largest first), the number of
    device operations and of each by name (replays of a captured graph
    included), the busy ms and the profiled drive's wall s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tp = profile(activities=[ProfilerActivity.CUDA])
    tp.start()
    wall = _serve_drive(model, prompts, SERVE_CHUNK, new_tokens)["wall"]
    tp.stop()
    by_name: dict = {}
    count: dict = {}
    for e in tp.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
            count[e.name()] = count.get(e.name(), 0) + 1
    return {"dev": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "launches": sum(count.values()), "count": count,
            "busy_ms": sum(by_name.values()) / 1e6, "wall": wall}


def phase_serving(seed: int, card: str) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import embedding_engine as ee
    from repro_torch.kernels import ops as kops
    from repro_torch.models.lm import LM
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("chatglm3-6b")
    t0 = time.perf_counter()
    model = LM(cfg, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    lo, hi = SERVE_PROMPT_LEN
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(lo, hi + 1, SERVE_REQUESTS)]
    # warm-up: cuBLAS handles, the allocator, the gather library
    _serve_drive(model, [p[:8] for p in prompts[:2]], SERVE_CHUNK)

    # the main path: the served drive, launches counted from 0
    kops.reset_launch_counts()
    main = _serve_drive(model, prompts, SERVE_CHUNK)
    counts = kops.launch_counts()
    variants = kops.variant_launch_counts()["block_gather"]
    srv, reqs, wall, final = (main["srv"], main["reqs"], main["wall"],
                              main["final"])
    st = srv.serve_stats
    waves = st["waves"]
    _require_served(main, SERVE_NEW_TOKENS, counts, variants)   # (a), (f)
    m = _drive_metrics(main, SERVE_NEW_TOKENS)
    micro_steps = m["micro_steps"]
    capture_s = _capture_seconds(model)

    # (b) chunked prefill == whole prompt: a drive at prefill_chunk=1
    chunk1 = _serve_drive(model, prompts, 1)
    reqs1, final1 = chunk1["reqs"], chunk1["final"]
    for i, (r, r1) in enumerate(zip(reqs, reqs1)):
        require(r.out == r1.out, f"request {i}: prefill_chunk=1 emitted "
                f"{r1.out[:6]}... vs {r.out[:6]}...")
        require(torch.equal(final[i], final1[i]),
                f"request {i}: last-wave logits differ between "
                f"prefill_chunk={SERVE_CHUNK} and 1")

    # (c) staggered admission == solo decode: the latest-admitted request
    late = max(range(SERVE_REQUESTS), key=lambda i: reqs[i].admitted_wave)
    solo = _serve_drive(model, [prompts[late]], SERVE_CHUNK)["reqs"]
    require(solo[0].out == reqs[late].out,
            f"request {late} (admitted at wave "
            f"{reqs[late].admitted_wave}) alone emitted {solo[0].out[:6]}... "
            f"vs {reqs[late].out[:6]}...")

    # (d) decode agrees with prefill: request 0 teacher-forced through the
    # decode path, position by position, against LM.forward (flash)
    seq = np.concatenate([prompts[0], np.asarray(reqs[0].out, np.int32)])
    n_prompt = len(prompts[0])
    caches = model.init_caches(1, SERVE_MAX_LEN)
    dec = []
    with torch.inference_mode():
        for t in range(len(seq)):
            lg, caches = model.decode_step(
                torch.tensor([[int(seq[t])]], device=model.device), caches)
            if t >= n_prompt - 1:
                dec.append(lg[0, 0])
        dec = torch.stack(dec)
        hidden = model(torch.from_numpy(seq[None]).long().to(model.device))
        fwd = ee.logits(hidden, model.embed)[0, n_prompt - 1:,
                                             :cfg.vocab_size]
    rel_l2 = float((dec - fwd).norm() / fwd.norm())
    require(rel_l2 <= PREFILL_REL_L2 and bool(torch.isfinite(dec).all()),
            f"decode vs prefill logits: relative L2 {rel_l2:.3g} > "
            f"{PREFILL_REL_L2}")
    top2 = fwd.topk(2, dim=-1).values
    rms = fwd.square().mean(-1).sqrt()
    clear = (top2[:, 0] - top2[:, 1]) > PREFILL_REL_L2 * rms
    same = dec.argmax(-1) == fwd.argmax(-1)
    require(bool(same[clear].all()),
            f"decode vs prefill: argmax differs at positions "
            f"{torch.nonzero(clear & ~same).flatten().tolist()} whose top-2 "
            f"margin exceeds {PREFILL_REL_L2} x the row's RMS")

    # (e) the group's outputs, kernel vs stock op vs embed[tokens]
    toks = np.asarray([r.out[-1] for r in reqs[:SERVE_SLOTS]], np.int32)
    name = srv.pipeline_group.names[0]
    wave = {name: {"tok_embed": {"table": model.embed, "idxs": toks},
                   "label_gather": {"table": model.embed, "idxs": toks}}}
    got = srv.pipeline_group.submit_wave(wave)[name].result()
    stock = model.embedding_pipeline(SERVE_SLOTS, 1, backend="torch")
    other = stock.submit_wave(wave)[name].result()
    want = model.embed[torch.from_numpy(toks).long().to(model.device)]
    for n in got:
        require(torch.equal(got[n], other[n]) and
                torch.equal(got[n][:, 0], want),
                f"decode-embed {n}: backend cuda vs torch vs embed[tokens]")

    # (g) the captured wave == the eager wave, bit for bit, wave by wave
    lock = _lockstep_drive(model, prompts, SERVE_NEW_TOKENS)
    for i, (r, r2) in enumerate(zip(reqs, lock["reqs"])):
        require(r.out == r2.out, f"request {i}: the lockstep drive emitted "
                f"{r2.out[:6]}... vs the main drive's {r.out[:6]}...")
    graph_dev = _graph_device_ms(srv)

    prof = _profiled_drive(model, prompts, SERVE_NEW_TOKENS)
    dev, launches, busy_ms, prof_wall = (prof["dev"], prof["launches"],
                                         prof["busy_ms"], prof["wall"])
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    step_bytes = n_params * 2          # every bf16 weight once a micro-step
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    c = EAGER_BASELINE
    ttft, per_token = m["ttft"], m["per_token"]
    lock_ms = {n: t * 1e3 / lock["micro_steps"]
               for n, t in lock["host_s"].items()}
    print(f"[8 chatglm3 serving] {cfg.name} {cfg.num_layers} layers, "
          f"{n_params} params, bf16 (random, seed {seed}; init "
          f"{init_s:.2f} s); DecodeServer(batch_slots={SERVE_SLOTS}, "
          f"max_len={SERVE_MAX_LEN}, prefill_chunk={SERVE_CHUNK}, "
          f"pipeline=True), captured wave (3 CUDA graphs built in "
          f"{capture_s:.2f} s with the server): {SERVE_REQUESTS} requests "
          f"(prompts {lo}-{hi} tokens, {sum(len(p) for p in prompts)} in "
          f"all), {SERVE_NEW_TOKENS} new tokens each, all ok; {waves} waves "
          f"({st['prefill_waves']} prefill, {st['decode_waves']} decode) in "
          f"{wall:.2f} s: {m['tokens_per_s']:.1f} generated tokens/s "
          f"(eager baseline {c['tokens_per_s']}); TTFT "
          f"{_percentiles(ttft)} (eager baseline p50 "
          f"{c['ttft_p50_s'] * 1e3:.0f} ms, p99 {c['ttft_p99_s'] * 1e3:.0f} "
          f"ms); per token {_percentiles(per_token)} (eager baseline p50 "
          f"{c['per_token_p50_ms']}, p99 {c['per_token_p99_ms']} ms); "
          f"block_gather launches {counts['block_gather']} (bulk "
          f"{variants['bulk']}, grouping pass {variants['group']}) = one "
          f"a wave; peak device memory {peak / 2**30:.2f} GiB; {card}")
    print(f"[8 serving where] {micro_steps} micro-steps in {waves} waves; "
          f"host ms issuing them (the captured wave: a copy, a mask and a "
          f"replay a micro-step) {m['issue_ms']:.1f} of the "
          f"{wall * 1e3:.1f} ms drive = {m['issue_ms'] / waves:.2f} ms a "
          f"wave, {m['issue_ms'] / micro_steps:.3f} ms a micro-step (eager "
          f"baseline {c['host_ms_micro_step']}); in the lockstep drive (same "
          f"call) graph {lock_ms['graph']:.3f} vs eager "
          f"{lock_ms['eager']:.2f} host ms a micro-step; device ms of one "
          f"captured micro-step "
          f"(CUDA events, 20 replays) unmasked "
          f"{graph_dev['unmasked']:.3f}, masked {graph_dev['masked']:.3f} "
          f"(eager baseline: {c['device_ms_micro_step']} ms of kernels); a "
          f"prefill wave's whole iteration {np.mean(m['prefill_ms']):.2f} "
          f"ms ({len(m['prefill_ms'])} waves); ms per decode wave (wave, "
          f"pipeline feed, argmax read back) mean "
          f"{np.mean(m['decode_ms']):.2f}, p50 "
          f"{np.percentile(m['decode_ms'], 50):.2f} (eager baseline "
          f"{c['ms_decode_wave']}), against {bound_ms:.2f} ms to read every "
          f"weight once at 3.35 TB/s; the drive under torch.profiler: " +
          ("device time not measured (the profiler saw no CUDA events)"
           if not dev else
           f"{launches} device operations = {launches / micro_steps:.0f} a "
           f"micro-step, device busy {busy_ms:.1f} ms = "
           f"{busy_ms / micro_steps:.2f} ms a micro-step = "
           f"{100 * busy_ms / (wall * 1e3):.1f}% of the unprofiled drive's "
           f"{wall * 1e3:.1f} ms (idle "
           f"{100 - 100 * busy_ms / (wall * 1e3):.1f}%; eager baseline "
           f"{c['busy_pct']}% busy; "
           f"{100 * busy_ms / (prof_wall * 1e3):.1f}% of the "
           f"{prof_wall * 1e3:.1f} ms it took under the profiler); top: " +
           ", ".join(f"{k[:40]} {ns / 1e6:.2f} ms" for k, ns in dev[:6])))
    print(f"[8 serving checks] prefill_chunk=1 drive: the same tokens, "
          f"bit-identical last-wave logits ({SERVE_REQUESTS} requests); "
          f"request {late} (admitted at wave {reqs[late].admitted_wave}) "
          f"served alone: the same {SERVE_NEW_TOKENS} tokens; request 0 "
          f"teacher-forced ({len(seq)} tokens): decode vs LM.forward logits "
          f"relative L2 {rel_l2:.3g} (tol {PREFILL_REL_L2}), argmax equal "
          f"at {int(same.sum())}/{len(same)} positions ({int(clear.sum())} "
          f"with a clear top-2 margin, all equal); decode-embed group "
          f"backend cuda == torch == embed[tokens] bit for bit; graph vs "
          f"eager wave in lockstep: {lock['waves']} waves, "
          f"{lock['micro_steps']} micro-steps, every wave's logits and "
          f"every cache leaf after every iteration ({lock['leaves']} "
          f"comparisons) the same bits, the same tokens as the main drive")
    result = {"launches": variants["bulk"],
              "group_launches": variants["group"], "waves": waves,
              "tokens_per_s": m["tokens_per_s"]}
    del model, main, srv, reqs, chunk1, reqs1, final, final1, solo, caches
    del dec, fwd, hidden, stock, got, other, want, prof, lock
    free_cuda()
    return result


def _capture_seconds(model) -> float:
    """Host seconds to build a server on the card: its caches and the
    capture of its three graphs (warm-up and the zeroing reset included)."""
    import torch
    from repro_torch.runtime.server import WaveGraph
    caches = model.init_caches(SERVE_SLOTS, SERVE_MAX_LEN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    WaveGraph(model, caches)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_serving_stablelm(seed: int, card: str) -> dict:
    """stablelm-3b (head dim 80, MHA, partial rotary) served through the
    captured wave: a shorter drive (one generation of 8 slots, 16 new
    tokens each), every request ok, the gather once a wave, and the drive
    in lockstep with the eager wave, bit for bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models.lm import LM
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("stablelm-3b")
    model = LM(cfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    lo, hi = SERVE_PROMPT_LEN
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(lo, hi + 1, STABLELM_REQUESTS)]
    _serve_drive(model, [p[:8] for p in prompts[:2]], SERVE_CHUNK,
                 STABLELM_NEW_TOKENS)              # warm-up

    kops.reset_launch_counts()
    main = _serve_drive(model, prompts, SERVE_CHUNK, STABLELM_NEW_TOKENS)
    counts = kops.launch_counts()
    variants = kops.variant_launch_counts()["block_gather"]
    _require_served(main, STABLELM_NEW_TOKENS, counts, variants)
    m = _drive_metrics(main, STABLELM_NEW_TOKENS)
    lock = _lockstep_drive(model, prompts, STABLELM_NEW_TOKENS)
    for i, (r, r2) in enumerate(zip(main["reqs"], lock["reqs"])):
        require(r.out == r2.out, f"stablelm-3b request {i}: the lockstep "
                f"drive emitted {r2.out[:6]}... vs {r.out[:6]}...")
    graph_dev = _graph_device_ms(main["srv"])
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    bound_ms = n_params * 2 / HBM_BYTES_PER_S * 1e3
    waves = main["srv"].serve_stats["waves"]
    print(f"[8 stablelm-3b serving] {cfg.name} {cfg.num_layers} layers, head "
          f"dim {cfg.hd}, {n_params} params, bf16 (random, seed {seed}); the "
          f"same server settings, captured wave: {STABLELM_REQUESTS} requests "
          f"(prompts {lo}-{hi} tokens), {STABLELM_NEW_TOKENS} new tokens "
          f"each, all ok; {waves} waves, {m['micro_steps']} micro-steps in "
          f"{main['wall']:.2f} s: {m['tokens_per_s']:.1f} generated "
          f"tokens/s; TTFT {_percentiles(m['ttft'])}; per token "
          f"{_percentiles(m['per_token'])}; host ms a micro-step "
          f"{m['issue_ms'] / m['micro_steps']:.3f} (lockstep: graph "
          f"{lock['host_s']['graph'] * 1e3 / lock['micro_steps']:.3f} vs "
          f"eager {lock['host_s']['eager'] * 1e3 / lock['micro_steps']:.2f}"
          f"); device ms of one captured micro-step unmasked "
          f"{graph_dev['unmasked']:.3f}, masked {graph_dev['masked']:.3f} "
          f"against {bound_ms:.2f} ms to read every weight once; ms per "
          f"decode wave mean {np.mean(m['decode_ms']):.2f}; block_gather "
          f"launches {counts['block_gather']} = one a wave; graph vs eager "
          f"in lockstep: {lock['waves']} waves, every wave's logits and "
          f"every cache leaf after every iteration ({lock['leaves']} "
          f"comparisons) the same bits, the same tokens; "
          f"peak device memory {peak / 2**30:.2f} GiB; {card}")
    result = {"launches": variants["bulk"],
              "group_launches": variants["group"], "waves": waves,
              "tokens_per_s": m["tokens_per_s"]}
    del model, main, lock
    free_cuda()
    return result


# ---------------------------------------------------------------------------
# Phase 9: DeepSeek-V2-Lite (MLA + MoE) prefilled and served
# ---------------------------------------------------------------------------

def _sdpa_backends(library) -> dict:
    """Each scaled_dot_product_attention backend that takes the call, timed
    alone (ms), or why it refuses it (a backend may refuse a value width
    other than the q/k width)."""
    import warnings
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION):
        try:
            with warnings.catch_warnings(), sdpa_kernel([be]):
                warnings.simplefilter("ignore")
                library()
                torch.cuda.synchronize()
                out[be.name] = time_ms(library, 10)
        except RuntimeError as e:
            out[be.name] = "refused: " + (str(e).strip().splitlines()
                                          or ["(no message)"])[0][:90]
    return out


def _deepseek_prefill(model, seed: int, card: str) -> dict:
    """``LM.prefill`` of DeepSeek-V2-Lite over 4 x 4096 tokens: one prefill
    on the main path (a flash launch at (192, 128) and an un-dispatch
    gather in every layer), more timed; the flash output held against the
    plain version on its own q, k, v and the un-dispatch
    gather against ``ref.block_gather`` bit for bit, in every layer; the
    last hidden state against a prefill with plain attention and the
    routing pinned to the kernel prefill's, within a fixed bound that a
    planted fault must exceed, and, with its own routing, how many routing
    decisions it takes differently; the flash kernel's time a layer beside
    its bound, the plain version and ``scaled_dot_product_attention``; the
    un-dispatch gather's (both variants) beside ``index_select`` and its
    bytes bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.agreement import bf16_agreement, check_bf16
    from repro_torch.kernels.flash_attention import kv_tile
    from repro_torch.kernels.gather import launch_variant
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.moe import capacity_of, route
    cfg = model.cfg
    n_layers = cfg.num_layers
    rng = np.random.default_rng(seed + 2)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ))).cuda()
    cap = capacity_of(cfg, PREFILL_BATCH * PREFILL_SEQ)
    torch.cuda.reset_peak_memory_stats()
    model.prefill(tokens)          # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()

    # the main path: one prefill, launches counted from 0
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    last = model.prefill(tokens)
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    counts = kops.launch_counts()
    variants = kops.variant_launch_counts()["block_gather"]
    require(counts["flash_attention"] == n_layers and
            counts["block_gather"] == n_layers and
            variants == {"bulk": n_layers, "group": n_layers, "rows": 0},
            f"DeepSeek-V2-Lite prefill launched flash_attention "
            f"{counts['flash_attention']} and block_gather "
            f"{counts['block_gather']} times ({variants}), expected "
            f"{n_layers} each (bulk variant)")
    require(last.shape == (PREFILL_BATCH, 1, cfg.d_model) and
            bool(torch.isfinite(last).all()), "DeepSeek prefill output")
    for _ in range(PREFILLS - 1):
        t0 = time.perf_counter()
        model.prefill(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prefill_ms = float(np.mean(times)) * 1e3
    dev = _device_time(lambda: model.prefill(tokens))
    attn_us = sum(us for k, us in dev if "flash" in k)
    gather_us = sum(us for k, us in dev if "gather_bulk" in k or
                    "group_" in k)

    # one more prefill through the kernels: every layer's flash output held
    # against the plain version on that layer's own q, k, v, every layer's
    # un-dispatch gather against the plain gather bit for bit, and every
    # layer's routing (top-k expert ids) recorded
    per_layer, first, gathers = [], {}, []
    routing = {"kernel": [], "plain": []}

    def plain(q, k, v, **kw):
        return ref.attention(q, k, v, **{**kw, "chunk": kv_tile(q.dtype)})

    def held(q, k, v, **kw):
        out = kops.flash_attention_cuda(q, k, v, **kw)
        per_layer.append(check_bf16(
            out, plain(q, k, v, **kw),
            f"flash kernel on DeepSeek layer {len(per_layer)}'s q, k, v"))
        first.setdefault("attention", (q, k, v, kw))
        return out

    def held_gather(table, idxs, **kw):
        out = kops.block_gather_cuda(table, idxs, **kw)
        gathers.append(check_close(
            out, ref.block_gather(table, idxs),
            f"un-dispatch gather on DeepSeek layer {len(gathers)}"))
        first.setdefault("gather", (table, idxs))
        return out

    def recorder(run):
        def record_route(x2d, router, k):
            probs, topw, tope = route(x2d, router, k)
            routing[run].append(tope)
            return probs, topw, tope
        return record_route

    def pinned_route(x2d, router, k):
        """The kernel prefill's top-k experts of this layer, weighted by
        this prefill's own probabilities (renormalised as ``route`` does)."""
        probs, _, _ = route(x2d, router, k)
        tope = routing["kernel"][pinned_route.layer]
        pinned_route.layer += 1
        topw = probs.gather(-1, tope)
        return probs, topw / topw.sum(-1, keepdim=True).clamp_min(1e-9), tope
    pinned_route.layer = 0

    with _OpSwap("attention", held), _OpSwap("block_gather", held_gather), \
            _OpSwap("route", recorder("kernel"), moe_mod):
        again = model.prefill(tokens)
    require(torch.equal(again, last), "DeepSeek prefill is not repeatable")
    require(len(per_layer) == len(gathers) == n_layers,
            "one flash and one un-dispatch gather a layer")
    layers = {}
    for a in per_layer:
        _worst(layers, a)
    # the last hidden state against a prefill with plain attention and the
    # routing pinned to the kernel prefill's (the held comparison); the
    # same against plain attention over half its KV chunk (a summation
    # order the kernel does not use: this model's own amplification of a
    # rounding step of attention); the kernel prefill with one layer's
    # attention faulted (what the bound must catch); and with plain
    # attention and its own routing (how far such a step moves the routing)
    def plain_half(q, k, v, **kw):
        return ref.attention(q, k, v,
                             **{**kw, "chunk": kv_tile(q.dtype) // 2})

    caught = {}

    def faulted(layer, fault, name):
        """The kernel in every layer; in ``layer`` on faulted inputs, its
        output then held as the per-layer check holds it (against the plain
        version on the true q, k, v), which must reject it."""
        def attn(q, k, v, **kw):
            attn.calls += 1
            if attn.calls - 1 != layer:
                return kops.flash_attention_cuda(q, k, v, **kw)
            out = kops.flash_attention_cuda(*fault(q, k, v), **kw)
            want = plain(q, k, v, **kw)
            try:
                check_bf16(out, want, name)
            except AssertionError:
                caught[name] = bf16_agreement(out, want)
            return out
        attn.calls = 0
        return attn

    def lost_values(q, k, v):
        v = v.clone()
        v[:, FAULT_KEYS[0]:FAULT_KEYS[1]] = 0
        return q, k, v
    mid = n_layers // 2
    # the end-to-end check must catch the first fault; the second it cannot
    # see (PERF.md), and only the per-layer check catches it
    faults = {"layer 0 at scale 128^-1/2 (the v width's, not the q/k "
              "width's)": (0, lambda q, k, v: (
                  q * (q.shape[-1] / v.shape[-1]) ** 0.5, k, v)),
              f"layer {mid} with the values of keys {FAULT_KEYS[0]}-"
              f"{FAULT_KEYS[1] - 1} lost (one KV tile's V load dropped)":
              (mid, lost_values)}
    runs = {"plain": plain, "plain_half": plain_half,
            **{name: faulted(layer, fault, name)
               for name, (layer, fault) in faults.items()}}
    pinned = {}
    for name, fn in runs.items():
        pinned_route.layer = 0
        with _OpSwap("attention", fn), \
                _OpSwap("route", pinned_route, moe_mod):
            pinned[name] = model.prefill(tokens)
        require(pinned_route.layer == n_layers,
                "routing pinned in every layer")
    with _OpSwap("attention", plain), \
            _OpSwap("route", recorder("plain"), moe_mod):
        free_last = model.prefill(tokens)

    def rel(x, y):
        return float((x.float() - y.float()).norm() / y.float().norm())
    plain_last = pinned.pop("plain")
    diff = last.float() - plain_last.float()
    rel_l2 = rel(last, plain_last)
    floor = rel(pinned.pop("plain_half"), plain_last)
    fault_rel = {name: rel(x, plain_last) for name, x in pinned.items()}
    free_rel_l2 = rel(last, free_last)
    bound = DEEPSEEK_PREFILL_REL_L2
    flips = [int((a != b).sum()) for a, b in zip(routing["kernel"],
                                                 routing["plain"])]
    last_rows = torch.arange(PREFILL_BATCH, device=last.device) * \
        PREFILL_SEQ + PREFILL_SEQ - 1
    last_flips = sum(int((a[last_rows] != b[last_rows]).sum())
                     for a, b in zip(routing["kernel"], routing["plain"]))
    expert_rms = float(first["gather"][0].float().square().mean().sqrt())
    print(f"[9 deepseek checks] every layer's flash output == plain on its "
          f"own q, k, v ({n_layers} layers: {_bf16_summary(layers)}); every "
          f"layer's un-dispatch gather == plain bit for bit; last hidden "
          f"state vs a prefill with plain attention and the routing pinned "
          f"to the kernel prefill's: relative L2 {rel_l2:.4g} (max abs "
          f"{float(diff.abs().max()):.3g}), against a tol of {bound}; the "
          f"same between plain attention over {kv_tile(torch.bfloat16)}- "
          f"and {kv_tile(torch.bfloat16) // 2}-key chunks: {floor:.4g}; "
          f"planted faults, routing pinned (the first required above the "
          f"tol; each required to fail its layer's check_bf16): " +
          "; ".join(f"{k}: {v:.4g} (that layer's output relative L2 "
                    f"{caught[k]['rel_l2']:.3g} from plain)"
                    if caught.get(k) else f"{k}: {v:.4g} (passed check_bf16)"
                    for k, v in fault_rel.items()) +
          f"; with plain attention and its own "
          f"routing: relative L2 {free_rel_l2:.3g}, {sum(flips)} of "
          f"{n_layers * routing['kernel'][0].numel()} routing decisions "
          f"differ ({last_flips} at the last positions; by layer {flips}); "
          f"layer 0's expert outputs (its un-dispatch table) have RMS "
          f"{expert_rms:.4g} for inputs of RMS 1")
    require(rel_l2 <= bound and bool(torch.isfinite(diff).all()),
            f"DeepSeek prefill with the kernel vs plain attention (routing "
            f"pinned): relative L2 {rel_l2:.4g} > {bound}")
    gross = next(iter(fault_rel))
    require(fault_rel[gross] > bound, f"DeepSeek prefill with {gross}: "
            f"relative L2 {fault_rel[gross]:.4g} <= {bound}, the end-to-end "
            f"check misses it")
    for name in fault_rel:
        require(caught.get(name) is not None, f"DeepSeek prefill with "
                f"{name}: that layer's output passed check_bf16")

    # layer 0: flash at (192, 128)
    q, k, v, kw = first.pop("attention")
    b, s, h, d = q.shape
    dv = v.shape[3]
    require((d, dv) == (cfg.hd + cfg.rope_head_dim, cfg.hd) == (192, 128),
            f"DeepSeek MLA widths (q/k {d}, v {dv}), expected (192, 128)")

    def kernel():
        return kops.attention(q, k, v, causal=True)
    ms = time_ms(kernel, 10)
    plain_ms = time_ms(lambda: plain(q, k, v, **kw), 2, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # MHA: no expand

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib = bf16_agreement(library().transpose(1, 2), kernel())
    require(lib["rel_l2"] <= LIBRARY_REL_L2_BF16,
            f"scaled_dot_product_attention vs kernel at (192, 128): relative "
            f"L2 {lib['rel_l2']:.3g} > 2^-7")
    library_ms = time_ms(library, 10)
    backends = _sdpa_backends(library)
    flops = b * h * s * s * (d + dv)     # causal QK^T and PV
    nbytes = (q.numel() + k.numel() + v.numel() + b * s * h * dv) * \
        q.element_size()
    bound_ms = max(flops / BF16_TC_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_by = ("operations" if flops / BF16_TC_FLOPS >=
                nbytes / HBM_BYTES_PER_S else "bytes")
    del q, k, v, qt, kt, vt

    # layer 0: the MoE un-dispatch gather
    table, idxs = first.pop("gather")
    got = kops.block_gather(table, idxs)
    g_err = max(gathers)
    check_close(got[:, 0], table.index_select(0, idxs.long()),
                "un-dispatch gather vs index_select")
    g_ms = time_ms(lambda: kops.block_gather(table, idxs), 50)
    # the variant kernel_variant does not pick here, on the same stream
    by_rows = torch.empty_like(got)
    launch_variant("rows", table, idxs, by_rows)
    check_close(by_rows, got, "un-dispatch gather, rows vs bulk variant")
    g_rows_ms = time_ms(lambda: launch_variant("rows", table, idxs, by_rows),
                        50)
    g_plain_ms = time_ms(lambda: ref.block_gather(table, idxs), 20)
    rows = idxs.long()
    g_library_ms = time_ms(lambda: table.index_select(0, rows), 50)
    row_bytes = table.shape[1] * table.element_size()
    uniq = int(torch.unique(rows).numel())
    g_bytes = uniq * row_bytes + idxs.numel() * 4 + idxs.numel() * row_bytes
    g_bound_ms = g_bytes / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"[9 deepseek prefill] {cfg.name} {n_layers} layers (mla + MoE: "
          f"{cfg.num_experts} routed experts top-{cfg.experts_per_tok} + "
          f"{cfg.num_shared_experts} shared), d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads, q/k {d} v {dv}, latent {cfg.kv_lora_rank}"
          f", bf16 (random, seed {seed}); {PREFILL_BATCH} x {PREFILL_SEQ} "
          f"uniform token ids, capacity {cap} per expert: prefill mean "
          f"{prefill_ms:.2f} ms over {PREFILLS} (host clock + synchronize); "
          f"flash_attention launches {counts['flash_attention']} and "
          f"un-dispatch block_gather launches {counts['block_gather']} "
          f"(bulk {variants['bulk']}, grouping pass {variants['group']}) in "
          f"the first; {_busy(dev, prefill_ms)}; flash kernels "
          f"{attn_us / 1e3:.2f} ms and un-dispatch gathers "
          f"{gather_us / 1e3:.2f} ms of it; peak device memory "
          f"{peak / 2**30:.2f} GiB; {card}")
    print(f"[9 deepseek kernel] flash attention per layer (B={b}, S={s}, "
          f"H={h}, MHA, q/k {d}, v {dv}, causal, bf16): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention "
          f"{library_ms:.4f} ms (by backend: " +
          ", ".join(f"{k} {v:.4f} ms" if isinstance(v, float) else
                    f"{k} {v}" for k, v in backends.items()) +
          f"), bound {bound_ms:.4f} ms ({flops / 1e12:.3f} TFLOP at 989 "
          f"TFLOP/s; kernel at {flops / ms / 1e9:.1f} TFLOP/s); vs the "
          f"library: {_bf16_summary(lib)}; {card}")
    print(f"[9 deepseek undispatch] layer 0's MoE un-dispatch out_buf[slot] "
          f"({idxs.numel()} rows of {row_bytes} B from a "
          f"{table.shape[0]}-row capacity buffer, {uniq} distinct): kernel "
          f"{g_ms:.4f} ms (bulk variant with its grouping pass; the rows "
          f"variant on the same stream {g_rows_ms:.4f} ms), plain "
          f"{g_plain_ms:.4f} ms, index_select {g_library_ms:.4f} ms, bound "
          f"{g_bound_ms:.4f} ms ({g_bytes / 1e6:.1f} MB at 3.35 TB/s); "
          f"bit-exact vs plain and index_select; {card}")
    result = {"flash_launches": counts["flash_attention"],
              "gather_launches": variants["bulk"],
              "gather_group_launches": variants["group"],
              "mla_ms": ms, "mla_plain_ms": plain_ms,
              "mla_bound_ms": bound_ms, "mla_bound_by": bound_by,
              "mla_library_ms": library_ms,
              "mla_library_backends": backends,
              "mla_max_abs_err": layers["max_abs"],
              "deepseek_prefill_ms": prefill_ms,
              "undispatch_ms": g_ms, "undispatch_rows_ms": g_rows_ms,
              "undispatch_plain_ms": g_plain_ms,
              "undispatch_library_ms": g_library_ms,
              "undispatch_bound_ms": g_bound_ms,
              "undispatch_max_abs_err": g_err}
    del tokens, last, again, pinned, plain_last, free_last, diff, routing
    del table
    del idxs, got, rows, by_rows
    free_cuda()
    return result


def _deepseek_serving(model, seed: int, card: str) -> dict:
    """DeepSeek-V2-Lite served through the captured wave with the stablelm-3b
    settings (8 requests, 16 new tokens): every request ok; every wave
    feeds both pipeline members (decode-embed and MoE un-dispatch) once;
    the un-dispatch member's output held against the stock-op backend and
    indexing; the drive in lockstep with the eager wave, bit for bit, with
    every gather launched eagerly there (one a layer in every eager
    micro-step, both members every wave) held against the plain gather bit
    for bit; the gathers the replayed micro-steps launch (one a layer)
    counted in the device trace.  The prefill_chunk=1 drive of phase 8 is
    not carried over: in an MoE model the tokens depend on the chunking, in
    the reference too (ROADMAP.md, reference caveat (c))."""
    import torch
    from repro_torch.kernels import ops as kops, ref
    cfg = model.cfg
    n_layers = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 3)
    lo, hi = SERVE_PROMPT_LEN
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(lo, hi + 1, STABLELM_REQUESTS)]
    _serve_drive(model, [p[:8] for p in prompts[:2]], SERVE_CHUNK,
                 STABLELM_NEW_TOKENS)              # warm-up

    kops.reset_launch_counts()
    main = _serve_drive(model, prompts, SERVE_CHUNK, STABLELM_NEW_TOKENS)
    counts = kops.launch_counts()
    variants = kops.variant_launch_counts()["block_gather"]
    srv, reqs = main["srv"], main["reqs"]
    waves = srv.serve_stats["waves"]
    m = _drive_metrics(main, STABLELM_NEW_TOKENS)
    require(all(r.status == "ok" and len(r.out) == STABLELM_NEW_TOKENS
                for r in reqs),
            f"DeepSeek served: not every request ended ok: "
            f"{[(r.status, len(r.out)) for r in reqs]}")
    names = srv.pipeline_group.names
    gs = srv.compile_stats["pipeline_group"]
    require(len(names) == 2 and
            gs["submitted"] == {n: waves for n in names},
            f"DeepSeek pipeline group {names} fed {gs['submitted']} in "
            f"{waves} waves, expected both members once a wave")
    # the wrapper counts what its Python launches: one gather a wave for
    # each member, and one a layer in each of the two micro-step bodies,
    # run eagerly by the capture's warm-up and recorded by the capture
    want = 2 * waves + 4 * n_layers
    require(counts["block_gather"] == want and
            variants == {"bulk": want, "group": want, "rows": 0},
            f"DeepSeek served {waves} waves: block_gather counted "
            f"{counts['block_gather']} launches ({variants}), expected "
            f"{want}")

    # (e) the un-dispatch member's output, kernel vs stock op vs indexing,
    # on a random table of the capacity buffer's shape and the server's
    # stream for the last token
    undisp = names[1]
    gen = torch.Generator(device=model.device).manual_seed(seed)
    table = torch.randn(tuple(srv._cap_buf.shape), generator=gen,
                        device=model.device).to(srv._cap_buf.dtype)
    tok0 = int(reqs[0].out[-1])
    idxs = ((np.arange(srv._undisp_segments, dtype=np.int64) * (tok0 + 1))
            % srv._undisp_rows).astype(np.int32)
    wave = {undisp: {"moe_undispatch": {"table": table, "idxs": idxs}}}
    got = srv.pipeline_group.submit_wave(wave)[undisp].result()
    stock = model.embedding_pipeline(SERVE_SLOTS, 1, backend="torch")
    other = stock.submit_wave(wave)[undisp].result()
    indexed = table[torch.from_numpy(idxs).long().to(model.device)]
    require(torch.equal(got["moe_undispatch"], other["moe_undispatch"]) and
            torch.equal(got["moe_undispatch"][:, 0], indexed),
            "MoE un-dispatch member: backend cuda vs torch vs "
            "table[idxs]")

    # (g) graph == eager in lockstep, every eagerly launched gather held
    held = []

    def held_gather(table, idxs, **kw):
        out = kops.block_gather_cuda(table, idxs, **kw)
        plain = ref.block_gather(table, idxs, **kw)
        bits = {2: torch.int16, 4: torch.int32}[out.element_size()]
        held.append((table.data_ptr(), int(table.shape[0]), idxs,
                     (out.view(bits) != plain.view(bits)).sum()))
        return out
    lock = _lockstep_drive(model, prompts, STABLELM_NEW_TOKENS,
                           gather=held_gather)
    for i, (r, r2) in enumerate(zip(reqs, lock["reqs"])):
        require(r.out == r2.out, f"DeepSeek request {i}: the lockstep drive "
                f"emitted {r2.out[:6]}... vs {r.out[:6]}...")
    torch.cuda.synchronize()
    members = {model.embed.data_ptr(): "decode-embed"}
    for s_ in lock["servers"].values():
        members[s_._cap_buf.data_ptr()] = "un-dispatch member"
    n_held, n_diff, in_model = {}, {}, []
    for ptr, rows, idxs_, ndiff in held:
        kind = members.get(ptr, "in-model un-dispatch")
        n_held[kind] = n_held.get(kind, 0) + 1
        n_diff[kind] = n_diff.get(kind, 0) + int(ndiff)
        if kind == "in-model un-dispatch":
            in_model.append((idxs_.numel(), rows,
                             int(torch.unique(idxs_).numel())))
    want_held = {"decode-embed": 2 * lock["waves"],
                 "un-dispatch member": 2 * lock["waves"],
                 "in-model un-dispatch": n_layers * lock["micro_steps"]}
    require(n_held == want_held and not any(n_diff.values()),
            f"DeepSeek lockstep drive: gathers held against the plain "
            f"gather {n_held}, elements differing {n_diff}; expected "
            f"{want_held} and none differing")
    slots = {(g, r) for g, r, _ in in_model}
    distinct = [u for _, _, u in in_model]
    del held, table, got, other, indexed, stock
    graph_dev = _graph_device_ms(srv)
    issue_ms = _graph_issue_ms(srv)
    prof = _profiled_drive(model, prompts, STABLELM_NEW_TOKENS)
    # the same drive again under the profiler: every gather that ran on the
    # device, the replayed micro-steps' one a layer included, and the
    # warm-up's (the capture launches nothing)
    in_graph = n_layers * m["micro_steps"]
    want_traced = 2 * waves + in_graph + 2 * n_layers
    traced = {k: sum(n for name, n in prof["count"].items() if k in name)
              for k in ("gather_bulk_kernel", "group_insert_kernel",
                        "gather_kernel")}
    require(traced == {"gather_bulk_kernel": want_traced,
                       "group_insert_kernel": want_traced,
                       "gather_kernel": 0},
            f"DeepSeek served {waves} waves, {m['micro_steps']} micro-steps: "
            f"the device trace holds {traced} gathers, expected "
            f"{want_traced} bulk gathers, each with its grouping pass")
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    bound_ms = w_bytes / HBM_BYTES_PER_S * 1e3
    wall = main["wall"]
    busy_ms = prof["busy_ms"]
    print(f"[9 deepseek serving] {cfg.name} {n_layers} layers, {n_params} "
          f"params ({w_bytes / 1e9:.2f} GB), bf16 (random, seed {seed}); "
          f"DecodeServer(batch_slots={SERVE_SLOTS}, max_len={SERVE_MAX_LEN}, "
          f"prefill_chunk={SERVE_CHUNK}, pipeline=True), captured wave: "
          f"{STABLELM_REQUESTS} requests (prompts {lo}-{hi} tokens, "
          f"{sum(len(p) for p in prompts)} in all), {STABLELM_NEW_TOKENS} new "
          f"tokens each, all ok; {waves} waves "
          f"({srv.serve_stats['prefill_waves']} prefill), "
          f"{m['micro_steps']} micro-steps in {wall:.2f} s: "
          f"{m['tokens_per_s']:.1f} generated tokens/s; TTFT "
          f"{_percentiles(m['ttft'])}; per token "
          f"{_percentiles(m['per_token'])}; pipeline members {names} fed "
          f"{gs['submitted']}; block_gather launches counted by the "
          f"wrapper {counts['block_gather']} = {waves} decode-embed + "
          f"{waves} un-dispatch member + {2 * n_layers} in the capture's "
          f"warm-up + {2 * n_layers} recorded by the two micro-step "
          f"captures; in the device trace of the same drive "
          f"{traced['gather_bulk_kernel']} bulk gathers (grouping passes "
          f"{traced['group_insert_kernel']}) = {2 * waves} for the members "
          f"+ {in_graph} in the replayed micro-steps ({n_layers} a "
          f"micro-step) + {2 * n_layers} in the warm-up; peak device memory "
          f"{peak / 2**30:.2f} GiB; {card}")
    print(f"[9 deepseek serving checks] un-dispatch member: backend cuda == "
          f"torch == table[idxs] bit for bit ({srv._undisp_segments} rows "
          f"of a random ({srv._undisp_rows}, {cfg.d_model}) table); in the "
          f"lockstep drive every gather launched eagerly == the plain gather "
          f"bit for bit: {n_held} (count by kind), the in-model "
          f"un-dispatch at (slots, capacity rows) {sorted(slots)} with "
          f"{min(distinct)}-{max(distinct)} distinct slots (mean "
          f"{np.mean(distinct):.1f}); graph vs eager in lockstep: "
          f"{lock['waves']} waves, {lock['micro_steps']} micro-steps, every "
          f"wave's logits and every cache leaf after every iteration "
          f"({lock['leaves']} comparisons) the same bits, the same tokens")
    print(f"[9 deepseek serving where] host ms a micro-step "
          f"{m['issue_ms'] / m['micro_steps']:.3f} in the drive (lockstep: "
          f"graph {lock['host_s']['graph'] * 1e3 / lock['micro_steps']:.3f}"
          f" vs eager "
          f"{lock['host_s']['eager'] * 1e3 / lock['micro_steps']:.2f}), "
          f"{issue_ms:.3f} to issue one replay onto an idle device; device ms of one captured micro-step (CUDA events, 20 "
          f"replays) unmasked {graph_dev['unmasked']:.3f}, masked "
          f"{graph_dev['masked']:.3f}, against {bound_ms:.2f} ms to read "
          f"every weight once at 3.35 TB/s (every expert of every layer: the "
          f"reference's all-expert products); ms per decode wave mean "
          f"{np.mean(m['decode_ms']):.2f}; the drive under torch.profiler: " +
          ("device time not measured (the profiler saw no CUDA events)"
           if not prof["dev"] else
           f"{prof['launches']} device operations = "
           f"{prof['launches'] / m['micro_steps']:.0f} a micro-step, device "
           f"busy {busy_ms:.1f} ms = {100 * busy_ms / (wall * 1e3):.1f}% of "
           f"the unprofiled drive's {wall * 1e3:.1f} ms (idle "
           f"{100 - 100 * busy_ms / (wall * 1e3):.1f}%) and "
           f"{100 * busy_ms / (prof['wall'] * 1e3):.1f}% of the "
           f"{prof['wall'] * 1e3:.1f} ms it took under the profiler; top: " +
           ", ".join(f"{k[:40]} {ns / 1e6:.2f} ms"
                     for k, ns in prof["dev"][:6])))
    result = {"gather_launches": variants["bulk"],
              "gather_group_launches": variants["group"],
              "traced_launches": traced["gather_bulk_kernel"],
              "traced_group_launches": traced["group_insert_kernel"],
              "waves": waves,
              "tokens_per_s": m["tokens_per_s"],
              "device_ms_micro_step": graph_dev["unmasked"],
              "issue_ms_micro_step": issue_ms,
              "bound_ms_micro_step": bound_ms}
    del main, srv, reqs, lock, prof
    free_cuda()
    return result


def phase_deepseek_lm(seed: int, card: str) -> dict:
    """DeepSeek-V2-Lite (27 layers, full width, bf16, random weights) built
    once on the card, prefilled (``_deepseek_prefill``) and served
    (``_deepseek_serving``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    cfg = get_config("deepseek-v2-lite-16b")
    t0 = time.perf_counter()
    model = LM(cfg, seed=seed)
    torch.cuda.synchronize()
    print(f"[9 deepseek build] {cfg.name}: "
          f"{sum(p.numel() for p in model.parameters())} params built on "
          f"the card in {time.perf_counter() - t0:.2f} s")
    prefill = _deepseek_prefill(model, seed, card)
    serving = _deepseek_serving(model, seed, card)
    del model
    free_cuda()
    return {"prefill": prefill, "serving": serving}


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
    if not (REPO / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}: "
              "run it from a checkout of the repo", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    name, card = phase_device()
    phase_build()
    phase_sweep(args.seed)
    phase_sweep_fusedmm(args.seed)
    phase_sweep_flash(args.seed)
    phase_stress_flash(args.seed)
    phase_small_program(args.seed)
    seconds = {"1-3": time.perf_counter() - t0}
    if args.sweep_only:
        return 0
    kernels = []
    for phase, run in (("4", lambda: phase_dlrm(args.seed, args.steps)),
                       ("5", lambda: phase_deepseek(args.seed, args.steps,
                                                    card)),
                       ("6", lambda: phase_gnn(args.seed, args.steps, card)),
                       ("7", lambda: phase_chatglm3(args.seed))):
        t0 = time.perf_counter()
        kernels.append(run())
        seconds[phase] = time.perf_counter() - t0
    later = {}
    for phase, run in (("7 stablelm", lambda: phase_stablelm_prefill(
                            args.seed)),
                       ("8", lambda: phase_serving(args.seed, card)),
                       ("8 stablelm", lambda: phase_serving_stablelm(
                           args.seed, card)),
                       ("9", lambda: phase_deepseek_lm(args.seed, card))):
        t0 = time.perf_counter()
        later[phase] = run()
        seconds[phase] = time.perf_counter() - t0
    flash = next(k for k in kernels if k["name"] == "flash_attention")
    prefill = later.pop("7 stablelm")
    flash["chatglm3_launches"] = flash["launches"]
    flash["stablelm_launches"] = prefill.pop("launches")
    flash["launches"] += flash["stablelm_launches"]
    flash.update(prefill)
    gather = next(k for k in kernels if k["name"] == "block_gather")
    gather["deepseek_launches"] = gather["launches"]
    for phase, key in (("8", "serving"), ("8 stablelm", "serving_stablelm")):
        gather[f"{key}_launches"] = later[phase]["launches"]
        gather[f"{key}_group_launches"] = later[phase]["group_launches"]
        gather["launches"] += later[phase]["launches"]
    ds_prefill = later["9"]["prefill"]
    ds_serving = later["9"]["serving"]
    flash["deepseek_launches"] = ds_prefill.pop("flash_launches")
    flash["launches"] += flash["deepseek_launches"]
    for key in [k for k in ds_prefill if k.startswith(("mla_", "deepseek_"))]:
        flash[key] = ds_prefill.pop(key)
    for key, run in (("deepseek_prefill", ds_prefill),
                     ("deepseek_serving", ds_serving)):
        gather[f"{key}_launches"] = run.pop("gather_launches")
        gather[f"{key}_group_launches"] = run.pop("gather_group_launches")
        gather["launches"] += gather[f"{key}_launches"]
    gather.update(ds_prefill)
    gather.update({f"deepseek_serving_{k}": v for k, v in ds_serving.items()})
    print("[time] wall seconds by phase: " +
          ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} never launched on the path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
