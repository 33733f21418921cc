"""Serving launcher (counterpart of ``repro/launch/serve.py``): batched
decode through :class:`~repro_torch.runtime.server.DecodeServer`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-lite-16b --pipeline
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-moe-235b-a22b --reduced --device cpu

The model is built on the CUDA card, with random weights from ``--seed``,
unless ``--device cpu`` is given; without a card the default raises.
``--reduced`` takes the architecture's small config (the only one of
qwen3-moe-235b-a22b that fits one card); an MoE model's pipeline feeds its
un-dispatch member too.
Fault-tolerance knobs as in the reference: ``--index-policy`` hardens the
prompts and the mirrored offset streams, ``--ttft-slo`` /
``--capacity-rps`` turn on SLO-aware shedding, ``--wave-deadline`` arms
the wave watchdog, and ``--chaos-site`` / ``--chaos-at`` inject a seeded
fault schedule (:mod:`repro_torch.runtime.faults`).

``--disagg`` (with ``--replicas``, ``--rpc-timeout-s``,
``--degrade-policy``) and ``--artifact-dir`` are not ported yet
(ROADMAP.md, Queue 1 item 8) and raise.
"""
from __future__ import annotations

import argparse
import collections

import numpy as np

from ..configs import get_config, get_reduced
from ..models.lm import LM
from ..runtime.faults import FaultInjector, FaultSpec
from ..runtime.server import DecodeServer, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions on the CPU; the "
                         "default is the CUDA card")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the prompts")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--pipeline", action="store_true",
                    help="cross-program pipelining: feed each wave's "
                         "access streams through the PipelineGroup")
    ap.add_argument("--index-policy", default="strict",
                    choices=("strict", "clamp", "drop"),
                    help="offset-stream hardening: strict fails the "
                         "request typed, clamp/drop repair and count")
    ap.add_argument("--ttft-slo", type=float, default=None, metavar="S",
                    help="server-wide TTFT budget (seconds); lapsed "
                         "requests expire, hopeless ones shed")
    ap.add_argument("--capacity-rps", default=None,
                    type=lambda s: s if s == "auto" else float(s),
                    help="calibrated service capacity (requests/s) for "
                         "submit-time predicted-wait shedding, or 'auto' "
                         "to self-calibrate from the measured wave-time "
                         "EWMA after a warmup wave count")
    ap.add_argument("--wave-deadline", type=float, default=None,
                    metavar="S", help="wave watchdog deadline (seconds)")
    ap.add_argument("--wave-retries", type=int, default=1)
    ap.add_argument("--disagg", action="store_true",
                    help="the disaggregated embedding tier (not ported "
                         "yet: raises)")
    ap.add_argument("--replicas", type=int, default=2,
                    help="embedding-service replicas behind --disagg")
    ap.add_argument("--rpc-timeout-s", type=float, default=30.0,
                    help="per-call RPC deadline of the service client")
    ap.add_argument("--artifact-dir", default=None,
                    help="AOT serving artifact directory (not ported yet: "
                         "raises)")
    ap.add_argument("--degrade-policy", default="fail",
                    choices=("fail", "stale"),
                    help="cold-lookup resolution while every replica is "
                         "dark (with --disagg)")
    ap.add_argument("--chaos-site", default=None,
                    choices=("marshal", "transfer", "dispatch", "result",
                             "wave"),
                    help="inject an InjectedFailure at this site")
    ap.add_argument("--chaos-at", type=int, nargs="*", default=[1],
                    help="1-based call ordinals of the site to fire at")
    ap.add_argument("--chaos-seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    faults = None
    if args.chaos_site is not None:
        faults = FaultInjector(
            [FaultSpec(args.chaos_site, at=tuple(args.chaos_at))],
            seed=args.chaos_seed)
    kw = {}
    if args.disagg:
        kw = {"service": "disagg", "degrade_policy": args.degrade_policy}
    # the knobs not ported yet raise in DecodeServer before it reads the
    # model: build none for them
    lm = None if (args.disagg or args.artifact_dir) else \
        LM(cfg, device=args.device, seed=args.seed)
    srv = DecodeServer(lm, batch_slots=args.slots,
                       max_len=args.max_len,
                       prefill_chunk=args.prefill_chunk,
                       pipeline=args.pipeline,
                       index_policy=args.index_policy,
                       capacity_rps=args.capacity_rps,
                       ttft_slo_s=args.ttft_slo,
                       wave_deadline_s=args.wave_deadline,
                       wave_retries=args.wave_retries,
                       faults=faults, artifact_dir=args.artifact_dir, **kw)
    return _drive(srv, lm, cfg, args, faults)


def _drive(srv, lm, cfg, args, faults):
    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, 8).astype(
        np.int32), max_new_tokens=16) for _ in range(args.requests)]
    for r in reqs:
        srv.submit(r)
    steps = srv.run_until_drained()
    statuses = collections.Counter(r.status for r in reqs)
    print(f"served {len(reqs)} requests in {steps} serving iterations on "
          f"{lm.device}; all done={all(r.done for r in reqs)}; "
          f"statuses={dict(statuses)}")
    print("serve_stats:", srv.serve_stats)
    if faults is not None:
        print("chaos:", faults.stats())
    if srv.pipeline_group is not None:
        print("pipeline_group:",
              srv.compile_stats.get("pipeline_group", {}))
    return reqs


if __name__ == "__main__":
    main()
