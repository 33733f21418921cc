#!/usr/bin/env python3
"""Time the compile of DLRM-DCNv2's sparse arch (the 26-table program of
``chip_smoke.py``'s phase 4) by the port's ``compile_program``, on one
shard and on two, with the compile cache off.

    python3 scripts/dlrm_compile_time.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` to time (the
checkout's by default): run it on two checkouts to compare their compile
paths on one machine.  The compile runs on the host only (no device); at
full width it holds several GB of host memory.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    from repro_torch.core.cost_model import FusionBudget
    from repro_torch.core.pipeline import compile_program
    sys.path.insert(1, str(REPO))
    import chip_smoke                  # the program's constants only
    prog = chip_smoke.dlrm_program()
    for shards in (1, 2):
        secs = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            compile_program(prog, "O3", budget=FusionBudget(shards=shards),
                            use_cache=False)
            secs.append(time.perf_counter() - t0)
        print(f"[dlrm compile] {args.src}: {len(prog.ops)} tables, "
              f"{shards} shard(s): " +
              ", ".join(f"{s:.3f}" for s in secs) + " s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
