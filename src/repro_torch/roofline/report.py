"""The roofline table over the dry run's records (counterpart of
``repro/roofline/report.py``), from ``experiments/dryrun_torch/*.json``.

    PYTHONPATH=src python -m repro_torch.roofline.report [--mesh single]

Every figure is an analytic bound for one H100 rank of the production
mesh (:class:`.analysis.HW`), from counts of the dry run, not a time.  The
verdict takes the analytic production-path memory term
(:func:`.analysis.analytic_bytes_per_device`): the counted bytes are an
upper bound, unfused eager traffic and, in the cost pass, the dense
attention's scores.  A cell without a cost pass (the ``multipod`` mesh,
``--no-cost``) is estimated from :func:`.analysis.analytic_flops` and the
step's counted bytes, and marked ``(est)``.
"""
from __future__ import annotations

import argparse
import json
from collections import Counter
from pathlib import Path

from ..configs import get_config
from ..launch.steps import SHAPES
from .analysis import (HW, analytic_bytes_per_device, analytic_flops,
                       model_flops, roofline_terms)

DRYRUN = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

ADVICE = {
    "compute": "keep the tensor cores fed: larger wgmma tiles in fused "
               "GEMMs, skip the masked half of causal attention tiles",
    "memory": "cut HBM traffic: fuse producer→consumer chains into one "
              "kernel, keep attention tiles in shared memory (flash), bf16 "
              "activations end to end",
    "collective": "overlap NCCL collectives with compute over NVLink: "
                  "reduce-scatter instead of all-reduce, bf16 partials, "
                  "sequence-parallel norms",
}


def load_cells(mesh: str = "single") -> list:
    return [json.loads(f.read_text())
            for f in sorted(DRYRUN.glob(f"*__{mesh}.json"))]


def build_rows(mesh: str = "single") -> list:
    rows = []
    n = 512 if mesh == "multipod" else 256
    for rec in load_cells(mesh):
        arch, shape = rec["arch"], rec["shape"]
        row = {"arch": arch, "shape": shape, "status": rec["status"]}
        if rec["status"] == "skipped":
            row["note"] = rec["reason"][:60]
            rows.append(row)
            continue
        if rec["status"] != "ok":
            row["note"] = rec.get("error", "")[:60]
            rows.append(row)
            continue
        seq, batch, kind = SHAPES[shape]
        cfg = get_config(arch)
        mf = model_flops(cfg, seq, batch, kind)
        if "roofline" not in rec:
            # analytic fallback: no cost pass for this cell -- the FLOPs
            # from analytic_flops, the bytes and collectives of the step's
            # own count, clearly marked
            rec = dict(rec)
            rec["flops"] = analytic_flops(cfg, seq, batch, kind)
            rec["cost_counted"] = False
            rec["roofline"] = roofline_terms(
                flops=rec["flops"] / n,
                bytes_accessed=rec.get("bytes_step", 0.0),
                collective_bytes=rec.get("collective_bytes", 0.0),
                n_chips=1)
        r = rec["roofline"]
        counted = rec.get("flops", 0.0)
        n_data = n // 16
        ab = analytic_bytes_per_device(cfg, seq, batch, kind, n_data=n_data)
        mem_an = ab / HW().hbm_bw
        # the verdict takes the analytic production-path memory: the
        # counted bytes are an upper bound (both are reported)
        terms = {"compute": r["compute_s"], "memory": mem_an,
                 "collective": r["collective_s"]}
        dom = max(terms, key=terms.get)
        bound = max(terms.values())
        row.update({
            "memory_s_analytic": mem_an,
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"],
            "bottleneck": dom,
            "bound_s": bound,
            "roofline_frac": r["compute_s"] / bound if bound else 0.0,
            "model_flops": mf,
            "counted_flops": counted,
            "useful_ratio": mf / counted if counted else float("nan"),
            "cost_counted": rec.get("cost_counted", False),
            "advice": ADVICE[dom],
        })
        rows.append(row)
    return rows


def markdown(rows) -> str:
    out = ["| arch | shape | compute_s | memory_s (counted) | memory_s "
           "(analytic) | collective_s | bottleneck | roofline-frac | "
           "MODEL/counted | note |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if "bottleneck" not in r:
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                       f"{r['status']} | — | — | {r.get('note', '')} |")
            continue
        flag = "" if r["cost_counted"] else " (est)"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.2e} | "
            f"{r['memory_s']:.2e} | {r['memory_s_analytic']:.2e} | "
            f"{r['collective_s']:.2e} | "
            f"**{r['bottleneck']}** | {r['roofline_frac']:.2f} | "
            f"{r['useful_ratio']:.2f}{flag} | {r['advice'][:44]}… |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    rows = build_rows(args.mesh)
    print(markdown(rows))
    ok = [r for r in rows if "bottleneck" in r]
    print(f"\ncells: {dict(Counter(r['status'] for r in rows))}")
    if ok:
        c = Counter(r["bottleneck"] for r in ok)
        print(f"bottleneck distribution: {dict(c)}")
        worst = sorted(ok, key=lambda r: r["roofline_frac"])[:3]
        print("lowest roofline fractions:",
              [(r["arch"], r["shape"], round(r["roofline_frac"], 3))
               for r in worst])
        coll = sorted(ok, key=lambda r: -(r["collective_s"] /
                                          max(r["bound_s"], 1e-12)))[:3]
        print("most collective-bound:",
              [(r["arch"], r["shape"]) for r in coll])


if __name__ == "__main__":
    main()
