"""The multi-pod dry run (counterpart of ``repro/launch/dryrun.py``).

For every (architecture × input shape × mesh) cell: build one rank's step
on the meta device over the abstract production mesh (:mod:`.steps`,
:func:`.mesh.make_production_mesh`: (16, 16) ``single`` or (2, 16, 16)
``multipod``), run it under a :class:`repro_torch.roofline.analysis
.StepCounter` -- shapes propagate, nothing is allocated, no kernel
launches, as the reference compiles without running -- and record what it
dispatched into ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``:
``flops_step`` / ``bytes_step`` (where the reference records
``flops_scanned`` / ``bytes_scanned``), ``collective_bytes``, ``memory``
(argument, output and peak temporary bytes of the rank).  On the
``single`` mesh a cost pass follows (``remat="none"``, ``cost_mode``: the
attention materialised so its FLOPs are counted) and gives
``flops_per_device``, ``bytes_per_device``, ``coll_bytes_per_device`` and
the ``roofline`` terms against the H100's constants.

A cell the port cannot build is recorded ``status: "error"`` with the
exception's text, as the reference records a failure: xLSTM's block kinds,
not yet split over a mesh (ROADMAP.md, Queue 1 item 6d-2 b), a training
cell whose flash backward has no kernel at its head widths (zamba2's
(112, 112): ROADMAP.md, K1), a hidden width, expert count or vocab that
does not split evenly over the model axis.  Every attention kind splits
(any head count, the head plan), zamba2's mamba layers by SSM head with
their out-projection's all-reduce counted, and an MoE model's training
cell counts the expert-parallel backward: the all-to-alls run again on
the cotangents, and again under remat's recompute.  Nothing here replicates, pads or shrinks a config to make a
cell run.

Usage (on the CPU; nothing is allocated):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from ..configs import get_config, list_archs
from ..core.shard_plan import axes_of
from ..roofline.analysis import (StepCounter, collective_bytes_from_stats,
                                 roofline_terms)
from .mesh import make_production_mesh
from .steps import SHAPES, build_bundle, shape_applicable

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def count_bundle(bundle, mesh) -> dict:
    """Run ``bundle``'s step under a :class:`StepCounter` and return its
    counts: FLOPs, bytes, memory and the collectives' result bytes (every
    axis of ``mesh`` the step used, counted from 0)."""
    before = {id(ax): ax.stats["result_bytes"] for ax in axes_of(mesh)}
    # the model's weights are arguments of every step, as the reference's
    # params are, whether or not the bundle passes them
    counter = StepCounter((bundle.args, list(bundle.lm.parameters())))
    with counter:
        out = bundle.fn(*bundle.args)
    counter.outputs(out)
    rec = counter.record()
    rec["collective_bytes"] = collective_bytes_from_stats(
        {"result_bytes": ax.stats["result_bytes"] - before.get(id(ax), 0)}
        for ax in axes_of(mesh))
    return rec


def run_cell(arch: str, shape: str, mesh_kind: str, remat: str = "dots",
             skip_existing: bool = True, do_cost: bool = True,
             variant: str = "", overrides: dict = None) -> dict:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    suffix = f"__{variant}" if variant else ""
    out_path = OUT_DIR / f"{arch}__{shape}__{mesh_kind}{suffix}.json"
    if skip_existing and out_path.exists():
        prev = json.loads(out_path.read_text())
        # re-run when a cost pass is requested but missing from the record
        if not (do_cost and mesh_kind == "single"
                and prev.get("status") == "ok"
                and "roofline" not in prev):
            return prev

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "remat": remat,
           "variant": variant, "overrides": overrides or {}}
    skip = shape_applicable(cfg, shape)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
        step = count_bundle(build_bundle(cfg, mesh, shape, remat=remat),
                            mesh)
        rec["count_s"] = round(time.time() - t0, 1)
        rec["collective_bytes"] = step["collective_bytes"]
        rec["memory"] = step["memory"]
        rec["flops_step"] = step["flops"]
        rec["mm_flops_step"] = step["mm_flops"]
        rec["bytes_step"] = step["bytes"]
        rec["kernel_bytes"] = step["kernel_bytes"]
        # --- cost pass (single-pod only): the attention materialised so
        # its FLOPs are counted; per-device (one rank's) figures
        if mesh_kind == "single" and do_cost:
            t2 = time.time()
            cost = count_bundle(build_bundle(cfg, mesh, shape, remat="none",
                                             cost_mode=True), mesh)
            n = mesh.size()
            rec["flops_per_device"] = cost["flops"]
            rec["flops_by_op"] = cost["flops_by_op"]
            rec["bytes_per_device"] = cost["bytes"]
            rec["coll_bytes_per_device"] = cost["collective_bytes"]
            rec["cost_counted"] = True
            rec["cost_pass_s"] = round(time.time() - t2, 1)
            rec["flops"] = rec["flops_per_device"] * n
            rec["roofline"] = roofline_terms(
                flops=rec["flops_per_device"],
                bytes_accessed=rec["bytes_per_device"],
                collective_bytes=rec["coll_bytes_per_device"],
                n_chips=1)  # all quantities are per-device already
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    rec["total_s"] = round(time.time() - t0, 1)
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multipod"])
    ap.add_argument("--remat", default="dots",
                    choices=["none", "dots", "full"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-cost", action="store_true",
                    help="skip the cost pass")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multipod"] if args.all else [args.mesh]
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                rec = run_cell(arch, shape, mesh_kind, remat=args.remat,
                               skip_existing=not args.force,
                               do_cost=not args.no_cost)
                status = rec["status"]
                extra = (f"flops={rec.get('flops', 0):.3e} "
                         f"coll={rec.get('collective_bytes', 0):.3e}B "
                         f"t={rec.get('total_s', '?')}s"
                         if status == "ok" else
                         rec.get("reason", rec.get("error", ""))[:90])
                print(f"[{status:7s}] {arch:24s} {shape:12s} {mesh_kind:8s} "
                      f"{extra}", flush=True)


if __name__ == "__main__":
    main()
