"""Forward == decode of zamba2-7b, read layer by layer in fp32.

zamba2-7b (81 layers: five ``mamba`` layers, then a ``shared_attn`` one)
is built from a seed in fp32 at full width and depth on the card
(``--layers`` cuts the depth, ``--reduced`` takes the reduced config,
``--device cpu`` runs on the CPU, ``--weights PATH`` loads the reference's
weights that ``scripts/zamba2_fwd_decode_reference.py --save-weights``
pickled, so the two scripts read the same model).  For each prompt length of ``--lens``,
a batch of ``--batch`` prompts drawn from the seed runs two ways: the
chunked forward (``LM.forward``, the SSD scan in chunks of
``pick_chunk(S, 256)``) and token by token (``LM.decode_step`` from
zeroed caches, the recurrent state stepped once a token).  After every
layer the hidden states of the two paths at the last prompt token are
compared (relative L2 over the batch), and so are the last-token logits.
A port fault shows as a jump at one layer kind; rounding carried by a
chaotic stack grows with depth instead.

Prints one line per prompt length (the curve at every sixth layer, the
largest step from one layer to the next and the layer kind it happened
at, the logits' reading) beside the card's name and power limit, and
writes every layer's reading as JSON to ``--out`` (by default
``build/zamba2_fwd_decode.json``).

Usage:
    python scripts/zamba2_fwd_decode_layers.py [--lens 128 192 256 320]
    python scripts/zamba2_fwd_decode_layers.py --device cpu --reduced
    python scripts/zamba2_fwd_decode_layers.py --device cpu --layers 6 \
        --lens 192 320 --batch 1 --weights build/zamba2_ref.pkl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi (CPU run)"


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def read(model, tokens: torch.Tensor) -> dict:
    """The relative L2 of the forward's against the decode's hidden state
    after each layer at the last token of ``tokens`` (B, S), and of the
    last-token logits."""
    from repro_torch.core import embedding_engine as ee
    blocks = model.blocks
    fwd: list = []
    hooks = [blk.register_forward_hook(
        lambda mod, args, out: fwd.append(out[0][:, -1].detach().clone()))
        for blk in blocks]
    try:
        with torch.inference_mode():
            hidden = model(tokens)
            fwd_logits = ee.logits(hidden[:, -1:], model.embed)
    finally:
        for h in hooks:
            h.remove()
    dec: list = []
    originals = [blk.decode for blk in blocks]

    def keep(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            dec.append(out[:, -1].detach().clone())
            return out
        return wrapped
    for blk in blocks:
        blk.decode = keep(blk.decode)
    try:
        b, s = tokens.shape
        caches = model.init_caches(b, s + 1)
        for t in range(s):
            dec.clear()
            logits, _ = model.decode_step(tokens[:, t:t + 1], caches)
    finally:
        for blk, fn in zip(blocks, originals):
            blk.decode = fn
    v = model.cfg.vocab_size
    return {"layers": [_rel(d, f) for d, f in zip(dec, fwd)],
            "logits": _rel(logits[..., :v], fwd_logits[..., :v])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lens", type=int, nargs="+",
                    default=[128, 160, 192, 256, 288, 320])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--out", default=str(REPO / "build" /
                                         "zamba2_fwd_decode.json"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("zamba2_fwd_decode_layers: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models.lm import LM, layer_kinds
    cfg = (get_reduced if args.reduced else get_config)("zamba2-7b")
    cfg = dataclasses.replace(cfg, dtype="float32",
                              num_layers=args.layers or cfg.num_layers)
    card = _card()
    t0 = time.perf_counter()
    model = LM(cfg, device=args.device, seed=args.seed)
    if args.weights:
        import pickle
        from repro_torch.convert import lm_params_from_reference
        with open(args.weights, "rb") as f:
            tree = pickle.load(f)
        model.load_state_dict(lm_params_from_reference(tree, cfg,
                                                       args.device))
        del tree
    kinds = layer_kinds(cfg)
    rng = np.random.default_rng(args.seed + 15)
    report = {"config": cfg.name, "layers": len(kinds), "kinds": kinds,
              "card": card, "seed": args.seed, "batch": args.batch,
              "by_len": {}}
    for n in args.lens:
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (args.batch, n)).astype(np.int64)).to(
                args.device)
        t1 = time.perf_counter()
        got = read(model, toks)
        curve = np.asarray(got["layers"])
        ratio = curve[1:] / np.maximum(curve[:-1], 1e-30)
        jump = int(np.argmax(ratio)) + 1
        report["by_len"][n] = dict(got, jump_layer=jump,
                                   jump_kind=kinds[jump],
                                   jump_ratio=float(ratio[jump - 1]),
                                   seconds=time.perf_counter() - t1)
        marks = ", ".join(f"{i} {curve[i]:.3g}"
                          for i in range(0, len(curve), 6))
        by_kind = {k: float(np.median([r for r, kk in zip(ratio, kinds[1:])
                                       if kk == k])) for k in set(kinds[1:])}
        print(f"[zamba2 fwd==decode S={n}] {cfg.name} fp32, "
              f"{len(kinds)} layers, batch {args.batch}: relative L2 after "
              f"layer (index value) {marks}; last layer {curve[-1]:.4g}; "
              f"logits {got['logits']:.4g}; largest step x"
              f"{ratio[jump - 1]:.3g} into layer {jump} ({kinds[jump]}); "
              f"median step by kind {by_kind}; {card}", flush=True)
    report["seconds"] = time.perf_counter() - t0
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"[zamba2 fwd==decode] {report['seconds']:.1f} s; {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
