"""Forward == decode of the JAX reference's zamba2-7b, read layer by layer
in fp32 on the CPU: the reference's side of
``scripts/zamba2_fwd_decode_layers.py``.

The reference's zamba2-7b (``repro.configs.get_config``) is built at full
width in fp32 from ``jax.random.PRNGKey(--seed)`` with its first
``--layers`` layers (five ``mamba`` layers, then a ``shared_attn`` one).
For each prompt length of ``--lens``, ``--batch`` prompts drawn as the
port's script draws them run two ways, one layer at a time through the
reference's own ``block_apply`` (the chunked forward) and ``block_decode``
(token by token from fresh caches).  After every layer the two paths'
hidden states at the last prompt token are compared (relative L2 over the
batch), and so are the last-token logits.

``--save-weights PATH`` pickles the parameters (numpy arrays in the
reference's tree) for the port's script (``--weights PATH``), so both read
the same weights.  Writes the readings as JSON to ``--out``.  Imports only
JAX and the reference package (``repro``); CPU only.

Usage:
    python scripts/zamba2_fwd_decode_reference.py --layers 6 \\
        --lens 192 320 --batch 1 --save-weights build/zamba2_ref.pkl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lens", type=int, nargs="+", default=[192, 320])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--save-weights", default=None)
    ap.add_argument("--out", default=str(REPO / "build" /
                                         "zamba2_fwd_decode_reference.json"))
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import embedding_engine as ee
    from repro.models.common import rms_norm
    from repro.models.lm import LM, block_apply, block_decode, \
        init_block_cache
    cfg = dataclasses.replace(get_config("zamba2-7b"), dtype="float32",
                              num_layers=args.layers)
    t0 = time.perf_counter()
    lm = LM(cfg)
    params = lm.init(jax.random.PRNGKey(args.seed))
    if args.save_weights:
        path = Path(args.save_weights)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, params), f, protocol=4)
    pattern = cfg.block_pattern
    kinds = [pattern[i % len(pattern)] for i in range(cfg.n_super *
                                                      len(pattern))]
    kinds += list(cfg.remainder_pattern)
    layer_params = [
        jax.tree.map(lambda a, n=i // len(pattern): a[n],
                     params["scan"][i % len(pattern)])
        if i < cfg.n_super * len(pattern)
        else params["rest"][i - cfg.n_super * len(pattern)]
        for i in range(len(kinds))]
    shared = params.get("shared")
    # the weights are arguments, not constants folded into the programs
    fwd = {k: jax.jit(lambda p, sp, x, pos, k=k: block_apply(
        k, p, x, cfg, lm._ctx({"shared": sp}, pos))[0]) for k in set(kinds)}
    dec = {k: jax.jit(lambda p, sp, x, c, k=k: block_decode(
        k, p, x, cfg, c, lm._ctx({"shared": sp}, None))) for k in set(kinds)}

    @jax.jit
    def head(x, norm, embed):
        return ee.logits(rms_norm(x, norm, cfg.norm_eps),
                         embed)[..., :cfg.vocab_size]

    rng = np.random.default_rng(args.seed + 15)
    report = {"config": cfg.name, "layers": len(kinds), "kinds": kinds,
              "seed": args.seed, "batch": args.batch, "by_len": {}}
    for n in args.lens:
        toks = jnp.asarray(rng.integers(0, cfg.vocab_size,
                                        (args.batch, n)).astype(np.int32))
        t1 = time.perf_counter()
        pos = jnp.broadcast_to(jnp.arange(n, dtype=jnp.float32)[None],
                               (args.batch, n))
        x = ee.lookup(params["embed"], toks, strategy="take")
        f_last = []
        for kind, p in zip(kinds, layer_params):
            x = fwd[kind](p, shared, x, pos)
            f_last.append(np.asarray(x[:, -1]))
        f_logits = np.asarray(head(x[:, -1:], params["final_norm"],
                                   params["embed"]))
        caches = [init_block_cache(k, cfg, args.batch, n + 1, jnp.float32)
                  for k in kinds]
        for t in range(n):
            x = ee.lookup(params["embed"], toks[:, t:t + 1], strategy="take")
            d_last = []
            for i, (kind, p) in enumerate(zip(kinds, layer_params)):
                x, caches[i] = dec[kind](p, shared, x, caches[i])
                d_last.append(x[:, -1])
        d_logits = np.asarray(head(x, params["final_norm"], params["embed"]))
        curve = [_rel(d, f) for d, f in zip(d_last, f_last)]
        report["by_len"][n] = {"layers": curve,
                               "logits": _rel(d_logits, f_logits),
                               "seconds": time.perf_counter() - t1}
        print(f"[zamba2 reference fwd==decode S={n}] {cfg.name} fp32, "
              f"{len(kinds)} layers ({', '.join(kinds)}), batch "
              f"{args.batch}, CPU: relative L2 after each layer "
              + ", ".join(f"{v:.4g}" for v in curve)
              + f"; logits {report['by_len'][n]['logits']:.4g}", flush=True)
    report["seconds"] = time.perf_counter() - t0
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"[zamba2 reference fwd==decode] {report['seconds']:.1f} s; {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
