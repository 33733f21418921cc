"""Training launcher (counterpart of ``repro/launch/train.py``): the
supervised, checkpointed train loop of :mod:`repro_torch.runtime.trainer`
on the synthetic token stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \\
        --reduced --steps 50 --device cpu --ckpt-dir build/train_cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch h2o-danube-1.8b --seq 8192 --global-batch 1 --steps 6 \\
        --ckpt-dir build/train
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b \\
        --seq 2048 --global-batch 1 --steps 4 --ckpt-dir build/xlstm

The model is built on the CUDA card, with random weights from ``--seed``,
unless ``--device cpu`` is given (the plain versions; for tests); without
a card the default raises.  The reference's flags, and the same
checkpoint cadence (every ``steps // 4`` steps); ``--ckpt-dir`` has no
default (the reference's is a fixed path under /tmp), since a run resumes
from whatever checkpoint it finds there.

``--model-parallel M`` above 1 trains over a ``("data", "model")`` mesh
(the ``dense`` and ``dense_local`` kinds): ``--ranks N`` processes (M by
default; N a multiple of M) are started on this host by
:func:`repro_torch.launch.mesh.run_ranks` in one ``--backend`` group
(gloo by default; several gloo ranks share one card), each building
``make_host_mesh(M)`` -- the multi-controller stand-in for the
reference's device discovery -- and its slices of the model, and training
under the supervisor with sharded checkpoints.  Rank 0 prints the
``done:`` line::

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch h2o-danube-1.8b --reduced --model-parallel 2 --ranks 4 \
        --steps 8 --seq 16 --global-batch 4 --device cpu --ckpt-dir build/mp
"""
from __future__ import annotations

import argparse

from ..configs import get_config, get_reduced
from ..data.pipeline import DataConfig, SyntheticTokens
from ..models.lm import LM, ShardCtx
from ..runtime.trainer import Trainer, TrainerConfig, run_supervised


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes to start with --model-parallel above "
                         "1 (default: the model-parallel width)")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="the ranks' process group backend")
    ap.add_argument("--ckpt-dir", required=True,
                    help="checkpoint directory; a run resumes from the "
                         "latest checkpoint in it")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions on the CPU; the "
                         "default is the CUDA card")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random initial weights")
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        from .mesh import run_ranks
        world = args.ranks or args.model_parallel
        if world % args.model_parallel:
            ap.error(f"--ranks {world} is not a multiple of "
                     f"--model-parallel {args.model_parallel}")
        out = run_ranks(_rank_main, world, (vars(args),),
                        backend=args.backend)[0]
    else:
        out = _train(args)
    print(f"done: step={out['final_step']} restarts={out['restarts']} "
          f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")
    return out


def _train(args, shard=None) -> dict:
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.global_batch, modality=cfg.modality,
        d_model=cfg.d_model, enc_seq=args.seq))
    tcfg = TrainerConfig(total_steps=args.steps,
                         ckpt_every=max(args.steps // 4, 1),
                         ckpt_dir=args.ckpt_dir,
                         grad_compression=args.compress,
                         step_deadline_s=args.deadline_s)
    return run_supervised(lambda: Trainer(
        LM(cfg, device=args.device, seed=args.seed, shard=shard), data,
        tcfg))


def _rank_main(rank: int, world: int, args: dict) -> dict:
    """One rank of ``--model-parallel``: its mesh and its slices of the
    model, trained; the losses and counters as plain numbers."""
    from .mesh import data_axes_of, make_host_mesh
    args = argparse.Namespace(**args)
    if args.device is None and args.backend == "nccl":
        import torch                   # NCCL takes one card a rank
        args.device = f"cuda:{rank % max(torch.cuda.device_count(), 1)}"
    mesh = make_host_mesh(args.model_parallel, device=args.device)
    out = _train(args, ShardCtx(mesh, data_axes=data_axes_of(mesh)))
    return {"final_step": out["final_step"], "restarts": out["restarts"],
            "losses": [float(x) for x in out["losses"]]}


if __name__ == "__main__":
    main()
