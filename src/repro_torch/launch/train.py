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
from whatever checkpoint it finds there.  ``--model-parallel``
above 1 (a mesh) is not ported yet (ROADMAP.md, Queue 1 item 6c) and
raises.
"""
from __future__ import annotations

import argparse

from ..configs import get_config, get_reduced
from ..data.pipeline import DataConfig, SyntheticTokens
from ..models.lm import LM
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
        raise NotImplementedError(
            "--model-parallel > 1 (a mesh) is not ported yet (ROADMAP.md, "
            "Queue 1 item 6c)")

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

    out = run_supervised(lambda: Trainer(
        LM(cfg, device=args.device, seed=args.seed), data, tcfg))
    print(f"done: step={out['final_step']} restarts={out['restarts']} "
          f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")
    return out


if __name__ == "__main__":
    main()
