"""What the head plan costs at the production mesh, from the dry run's
one-rank steps (counts on the meta device, no time).

For every attention architecture on the (16, 16) mesh: rank 0's query
and KV heads, the KV cache a rank holds at ``decode_32k`` (the dry run's
decode bundle: 128 slots over the data axis, 32,768 positions), how many
model ranks hold the same KV heads (copies), the KV bytes the model axis
holds against one copy of every head, the ``wk`` / ``wv`` weight bytes a
rank holds, and how many model ranks hold no query head (idle in every
attention).  An MLA model's latent cache is whole on every rank.

    PYTHONPATH=src python scripts/head_plan_costs.py
"""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import head_plan
from repro_torch.launch.steps import SHAPES, build_decode_bundle

ARCHS = ("chatglm3-6b", "deepseek-v2-lite-16b", "gemma3-4b",
         "h2o-danube-1.8b", "llava-next-34b", "qwen3-moe-235b-a22b",
         "stablelm-3b", "whisper-large-v3")


def costs(arch: str) -> dict:
    cfg = get_config(arch)
    mesh = make_production_mesh()
    n = mesh.shape[mesh.mesh_dim_names.index("model")]
    seq, batch, _ = SHAPES["decode_32k"]
    bundle = build_decode_bundle(cfg, mesh, seq, batch)
    caches = bundle.args[1]
    cache_bytes = sum(t.numel() * t.element_size() for layer in caches
                      for k, t in layer.items() if k != "len")
    weights = sum(p.numel() * p.element_size()
                  for name, p in bundle.lm.named_parameters()
                  if name.endswith(("attn.wk", "attn.wv")))
    plans = [head_plan(cfg, n, r) for r in range(n)]
    group = max(len(p.group) for p in plans)
    held = sum(len(p.group) > 0 for p in plans)
    return {"arch": arch, "q": plans[0].q[1] - plans[0].q[0],
            "kv": plans[0].kv[1] - plans[0].kv[0], "cache": cache_bytes,
            "copies": group, "axis_over_one": group if "mla" not in
            cfg.block_pattern else n, "wkv": weights,
            "idle": n - held}


def main() -> None:
    print("| arch | rank 0 q / KV heads | KV cache a rank at decode_32k "
          "(GiB) | ranks holding a KV head | axis KV bytes / one copy | "
          "wk+wv a rank (MB) | idle attention ranks of 16 |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for arch in ARCHS:
        c = costs(arch)
        print(f"| {c['arch']} | {c['q']} / {c['kv']} | "
              f"{c['cache'] / 2**30:.3f} | {c['copies']} | "
              f"{c['axis_over_one']} | {c['wkv'] / 1e6:.1f} | {c['idle']} |")


if __name__ == "__main__":
    main()
