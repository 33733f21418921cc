"""The dry run on the CPU: one rank's step built on the meta device over an
abstract mesh (``core.shard_plan.DryMesh``, ``launch.mesh
.make_production_mesh``), counted by ``roofline.analysis.StepCounter``
(``launch.dryrun``), and the table over its records (``roofline.report``).

Held: the meshes' shapes and a rank's place; the collectives' result
bytes a dry step counts equal, rank for rank, those four gloo ranks count
running the same training step (``launch.mesh.run_ranks``; a dense and an
MoE config, whose backward's all-to-alls are counted), and 0 on a 1 x 1
mesh; the counter's FLOPs, bytes and memory on steps whose counts
are known; the kernel wrappers on meta (no launch, their bytes reported);
``remat`` lowering the counted peak while "dots" recomputes no product;
``run_cell``'s records (an ``ok`` cell with FLOPs and roofline terms, an
``error`` cell naming ROADMAP item 6d) and the report over them; and the
``decode_32k`` cell of all ten full-width configs on the (16, 16) mesh,
whose split PERF.md states.  Exact counts throughout (integers)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core.shard_plan import DryMesh, axes_of, model_axis
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import (data_axes_of, make_production_mesh,
                                     run_ranks)
from repro_torch.models.lm import LM, ShardCtx
from repro_torch.roofline import analysis, report

SEQ, BATCH = 16, 4
#: reduced chatglm3 at a head width the flash kernel takes (64): on meta
#: tensors the kernel's wrappers refuse what they refuse on the card
DENSE = dict(d_model=256, num_heads=4, num_kv_heads=2)


def _dense():
    return dataclasses.replace(get_reduced("chatglm3-6b"), **DENSE)


def test_production_meshes_are_the_references():
    single = make_production_mesh()
    assert (single.mesh_dim_names, single.shape) == (("data", "model"),
                                                      (16, 16))
    multi = make_production_mesh(multi_pod=True)
    assert (multi.mesh_dim_names, multi.shape) == (("pod", "data", "model"),
                                                    (2, 16, 16))
    assert data_axes_of(multi) == ("pod", "data")
    assert multi.size() == 512 and multi.device_type == "meta"
    assert multi.rank == 0
    last = DryMesh(dict(zip(multi.mesh_dim_names, multi.shape)), 511)
    assert [last.get_local_rank(a) for a in last.mesh_dim_names] == \
        [1, 15, 15]
    assert last.get_local_rank(("pod", "data")) == 31
    with pytest.raises(ValueError, match="rank 512"):
        DryMesh({"pod": 2, "data": 16, "model": 16}, 512)


def _coll(mesh) -> tuple:
    axes = axes_of(mesh)
    return (sum(ax.stats["result_bytes"] for ax in axes),
            sum(ax.stats["collectives"] for ax in axes))


def _host_batch(cfg) -> dict:
    rng = np.random.default_rng(0)
    return {k: rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
            .astype(np.int32) for k in ("tokens", "labels")}


def _live_step(cfg, mesh, data_axes=("data",), remat="none"):
    """One step of the Trainer's ``TrainStep`` with ZeRO-1 (the dry
    bundle's specs): the loss, the updated parameters, the step and the
    collectives' result bytes and count it made."""
    from repro_torch.launch.sharding import train_specs
    from repro_torch.runtime.trainer import TrainStep
    c0 = _coll(mesh) if mesh is not None else (0, 0)
    lm = LM(cfg, device="cpu", seed=0,
            shard=ShardCtx(mesh=mesh, data_axes=data_axes, remat=remat))
    specs = None if mesh is None else \
        train_specs(cfg, mesh, BATCH, SEQ, data_axes)
    step = TrainStep(lm, BATCH, SEQ, in_shardings=specs)
    state = step.init_state()
    loss = step(state, step.local_batch(_host_batch(cfg)))
    c1 = _coll(mesh) if mesh is not None else (0, 0)
    params = {k: p.detach().clone() for k, p in state["params"].items()}
    return loss.detach(), params, step, (c1[0] - c0[0], c1[1] - c0[1])


def _moe():
    """Reduced qwen3-moe at a head width the flash kernel takes."""
    return dataclasses.replace(get_reduced("qwen3-moe-235b-a22b"), **DENSE)


class _AllToAlls:
    """``Collectives.all_to_all`` counted (a dry mesh's too: its
    collectives inherit it)."""

    def __init__(self):
        from repro_torch.core.shard_plan import Collectives
        self.cls, self.fn, self.n = Collectives, Collectives.all_to_all, 0

    def __enter__(self):
        def counted(coll, x):
            self.n += 1
            return self.fn(coll, x)
        self.cls.all_to_all = counted
        return self

    def __exit__(self, *exc):
        self.cls.all_to_all = self.fn


def _live_rank(rank: int, world: int) -> dict:
    """The four live ranks: on {data 2, model 2} one step of the dense and
    of the MoE config under each remat (the collectives and the MoE's
    all-to-alls counted, the bits of "none" kept); on {pod 2, data 2,
    model 1} one step with the batch and ZeRO-1 split over pod and data
    jointly, beside the same step on one process."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_host_mesh
    cfg = _dense()
    out = {}
    mesh = make_host_mesh(2, device="cpu")
    for key, c in (("", cfg), ("moe ", _moe())):
        base = None
        for remat in ("none", "dots", "full"):
            with _AllToAlls() as a2a:
                loss, params, _, coll = _live_step(c, mesh, remat=remat)
            base = base or (loss, params)
            out[key + remat] = {
                "coll": coll, "finite": bool(torch.isfinite(loss)),
                "all_to_all": a2a.n,
                "bit_equal": torch.equal(loss, base[0]) and all(
                    torch.equal(p, base[1][k]) for k, p in params.items())}
    joint = DeviceMesh("cpu", torch.arange(4).reshape(2, 2, 1),
                       mesh_dim_names=("pod", "data", "model"))
    loss, params, step, coll = _live_step(cfg, joint, ("pod", "data"))
    one_loss, one_params, _, _ = _live_step(cfg, None)
    out["joint"] = {
        "coll": coll, "data": (step._data.axis, step._data.size,
                               step._data.rank),
        "block": step._block, "zero1": len(step.shards.zero1),
        "loss": (float(loss), float(one_loss)),
        "err": max(float((p - one_params[k]).abs().max())
                   for k, p in params.items())}
    return out


@pytest.fixture(scope="module")
def live4():
    return run_ranks(_live_rank, 4, timeout_s=300)


def _dry_train(cfg, sizes: dict, rank: int = 0, remat: str = "none"):
    mesh = DryMesh(sizes, rank)
    rec = dryrun.count_bundle(
        steps.build_train_bundle(cfg, mesh, SEQ, BATCH, remat=remat), mesh)
    rec["collectives"] = sum(ax.stats["collectives"] for ax in axes_of(mesh))
    return rec, mesh


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_dry_collective_bytes_equal_four_gloo_ranks(live4, remat):
    """A reduced dense training step (the Trainer's, ZeRO-1) on a {data 2,
    model 2} mesh: the result bytes and the number of collectives the dry
    run counts for each rank equal what the four live ranks count, under
    each remat.  "dots" keeps the row-parallel products' reduced outputs,
    so it makes the collectives of "none"; "full" runs them again; both
    leave the step's bits as "none" makes them."""
    cfg = _dense()
    for rank, got in enumerate(live4):
        dry, _ = _dry_train(cfg, {"data": 2, "model": 2}, rank, remat)
        mine = got[remat]
        assert mine["finite"] and mine["bit_equal"], rank
        assert dry["collective_bytes"] == mine["coll"][0] > 0, rank
        assert dry["collectives"] == mine["coll"][1], rank
        if remat == "dots":
            assert mine["coll"] == got["none"]["coll"], rank
        if remat == "full":
            assert mine["coll"][0] > got["none"]["coll"][0], rank


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_a_moe_train_step_counts_the_backwards_all_to_alls(live4, remat):
    """A reduced MoE training step on a {data 2, model 2} mesh (the
    seq-split expert path): the dry run counts what the four live ranks
    make, its all-to-alls included -- two a layer forward, their two
    transposes in the backward, and under remat the forward's two again
    in the recompute; every remat leaves the step's bits as "none"
    makes them."""
    cfg = _moe()
    per_layer = 4 if remat == "none" else 6
    for rank, got in enumerate(live4):
        mine = got[f"moe {remat}"]
        assert mine["finite"] and mine["bit_equal"], rank
        with _AllToAlls() as a2a:
            dry, _ = _dry_train(cfg, {"data": 2, "model": 2}, rank, remat)
        assert a2a.n == mine["all_to_all"] == per_layer * cfg.num_layers
        assert dry["collective_bytes"] == mine["coll"][0] > 0, rank
        assert dry["collectives"] == mine["coll"][1], rank


def test_a_one_by_one_mesh_makes_no_collective():
    dry, mesh = _dry_train(_dense(), {"data": 1, "model": 1})
    assert dry["collective_bytes"] == 0 and dry["mm_flops"] > 0
    assert axes_of(mesh) == []


def test_two_data_axes_mean_the_gradients_jointly(live4):
    """On a (pod, data, model) mesh the batch, the gradient mean and the
    ZeRO-1 rows split over pod and data at once (one axis of 4): four
    gloo ranks take the step one process takes on the whole batch, and
    make the collectives the dry run counts for each of them."""
    cfg = _dense()
    sizes = {"pod": 2, "data": 2, "model": 1}
    for rank, got in enumerate(live4):
        mine = got["joint"]
        assert mine["data"] == (("pod", "data"), 4, rank)
        assert mine["block"] == (rank, rank + 1) and mine["zero1"] > 0
        np.testing.assert_allclose(*mine["loss"], rtol=2e-5, atol=2e-5)
        assert mine["err"] < 2e-5, (rank, mine["err"])
        dry, mesh = _dry_train(cfg, sizes, rank)
        assert dry["collective_bytes"] == mine["coll"][0] > 0, rank
        assert dry["collectives"] == mine["coll"][1], rank
    dry, mesh = _dry_train(cfg, {"pod": 2, "data": 2, "model": 2}, rank=5)
    joint = [ax for ax in axes_of(mesh) if ax.axis == ("pod", "data")]
    assert len(joint) == 1 and joint[0].size == 4 and joint[0].rank == 2
    assert joint[0].stats["collectives"] > 0


def test_collective_results_count_as_the_references_convention():
    mesh = DryMesh({"data": 1, "model": 4})
    ax = model_axis(mesh, "model", "meta")
    x = torch.empty((3, 5), dtype=torch.bfloat16, device="meta")
    ax.sum(x)                                    # the payload
    ax.gather(x, 0)                              # the gathered result
    ax.scatter(torch.empty((8, 5), device="meta"), 0)
    assert ax.stats["result_bytes"] == 3 * 5 * 2 + 12 * 5 * 2 + 2 * 5 * 4
    assert ax.stats["collectives"] == 3


def test_the_counter_counts_a_known_step():
    a = torch.empty((64, 32), device="meta", requires_grad=True)
    b = torch.empty((32, 16), device="meta", requires_grad=True)
    counter = analysis.StepCounter((a, b))
    with counter:
        out = (a @ b).sum()
        out.backward()
    counter.outputs(out)
    rec = counter.record()
    assert rec["flops_by_op"] == {"aten.mm": 3 * 2 * 64 * 32 * 16}
    assert rec["mm_flops"] == rec["flops"]
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == (64 * 32 + 32 * 16) * 4
    assert mem["output_size_in_bytes"] == 4
    # the peak: both gradients beside the loss and its seed (the product,
    # 64 x 16, was freed once the sum had read it)
    assert mem["temp_size_in_bytes"] == (64 * 32 + 32 * 16) * 4 + 2 * 4
    # the product read and written, its sum, the backward's reads
    assert rec["bytes"] > (64 * 32 + 32 * 16 + 64 * 16) * 4
    bf = torch.empty((4, 8, 16), dtype=torch.bfloat16, device="meta")
    with analysis.StepCounter() as c2:
        torch.bmm(bf, bf.transpose(1, 2), out_dtype=torch.float32)
    assert c2.flops_by_op == {"aten.bmm": 2 * 4 * 8 * 8 * 16}


def test_kernel_wrappers_on_meta_launch_nothing_and_report_bytes():
    from repro_torch.kernels import ops as kops
    kops.reset_launch_counts()
    q = torch.empty((2, 256, 4, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 256, 2, 64), dtype=torch.bfloat16, device="meta")
    table = torch.empty((100, 64), dtype=torch.bfloat16, device="meta")
    idxs = torch.empty(50, dtype=torch.int32, device="meta")
    with analysis.StepCounter() as counter:
        out = kops.attention(q, k, k, causal=True)
        rows = kops.block_gather(table, idxs)
    assert out.shape == q.shape and out.device.type == "meta"
    assert rows.shape == (50, 1, 64)
    assert kops.launch_counts() == dict.fromkeys(kops.launch_counts(), 0)
    assert counter.kernel_bytes == {
        "flash_attention": (2 * q.numel() + 2 * k.numel()) * 2,
        "block_gather": 2 * 50 * 64 * 2 + 50 * 4}
    assert counter.flops == 0          # no counter sees inside a kernel
    with pytest.raises(ValueError, match="head dims"):
        kops.attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                       k[..., :48].contiguous())


def test_remat_lowers_the_counted_peak():
    cfg = dataclasses.replace(get_reduced("h2o-danube-1.8b"), num_layers=4,
                              d_model=320, num_heads=4, num_kv_heads=2)
    recs = {}
    for remat in ("none", "dots", "full"):
        mesh = DryMesh({"data": 1, "model": 1})
        recs[remat] = dryrun.count_bundle(steps.build_train_bundle(
            cfg, mesh, 512, 8, remat=remat), mesh)
    temp = {r: recs[r]["memory"]["temp_size_in_bytes"] for r in recs}
    assert temp["full"] < temp["dots"] < temp["none"], temp
    mm = {r: recs[r]["mm_flops"] for r in recs}
    assert mm["dots"] == mm["none"] < mm["full"], mm
    assert recs["dots"]["kernel_bytes"]["flash_attention"] == \
        2 * recs["none"]["kernel_bytes"]["flash_attention"]


def test_a_dry_mesh_builds_on_meta_only():
    mesh = DryMesh({"data": 1, "model": 2})
    with pytest.raises(ValueError, match="mesh's device"):
        LM(get_reduced("chatglm3-6b"), device="cpu",
           shard=ShardCtx(mesh=mesh))
    lm = LM(get_reduced("chatglm3-6b"), device="meta",
            shard=ShardCtx(mesh=mesh))
    assert lm.tp.size == 2 and lm.blocks[0].attn["wq"].shape[1] == 32


@pytest.fixture
def out_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    monkeypatch.setattr(report, "DRYRUN", tmp_path)
    return tmp_path


def test_run_cell_records_and_the_report(out_dir, monkeypatch):
    """Reduced configs over a {data 2, model 2} mesh standing in for the
    production one: chatglm3's training cell is ``ok`` with FLOPs, memory
    and roofline terms; xlstm's names ROADMAP item 6d-2 b (its kinds are
    the last that do not split over a mesh).  The report renders both."""
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: DryMesh({"data": 2,
                                                         "model": 2}))
    small = dataclasses.asdict(_dense())
    ok = dryrun.run_cell("chatglm3-6b", "train_4k", "single",
                         overrides=small)
    assert ok["status"] == "ok", ok.get("traceback")
    assert ok["flops"] > 0 and ok["flops_per_device"] * 4 == ok["flops"]
    assert ok["flops_step"] > 0 and ok["collective_bytes"] > 0
    assert ok["flops_by_op"]["aten.bmm"] > 0       # the dense attention
    assert set(ok["roofline"]) >= {"compute_s", "memory_s", "collective_s",
                                   "bottleneck", "step_lower_bound_s"}
    assert ok["memory"]["argument_size_in_bytes"] > 0
    xlstm = dataclasses.asdict(get_reduced("xlstm-1.3b"))
    err = dryrun.run_cell("xlstm-1.3b", "prefill_32k", "single",
                          overrides=xlstm)
    assert err["status"] == "error" and "item 6d-2 b" in err["error"]
    assert json.loads((out_dir / "xlstm-1.3b__prefill_32k__single.json")
                      .read_text())["status"] == "error"
    rows = report.build_rows("single")
    assert [r["status"] for r in rows] == ["ok", "error"]
    assert rows[0]["bottleneck"] in report.ADVICE and rows[0]["cost_counted"]
    md = report.markdown(rows)
    assert "| chatglm3-6b | train_4k |" in md
    assert "| xlstm-1.3b | prefill_32k | — |" in md
    # a cell without a cost pass is estimated and marked
    dryrun.run_cell("chatglm3-6b", "train_4k", "multipod", overrides=small)
    (est,) = report.build_rows("multipod")
    assert not est["cost_counted"] and "(est)" in report.markdown([est])


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "deepseek-v2-lite-16b"])
def test_run_cell_records_an_moe_training_cell_ok(out_dir, monkeypatch,
                                                  arch):
    """The MoE kinds' training cell (expert-parallel training) on a
    {data 2, model 2} mesh standing in for the production one is ``ok``:
    FLOPs, memory and the collectives, the backward's all-to-alls among
    them."""
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: DryMesh({"data": 2,
                                                         "model": 2}))
    over = dict(DENSE, num_heads=2, head_dim=128, kv_lora_rank=32,
                rope_head_dim=64) if arch == "deepseek-v2-lite-16b" \
        else DENSE
    small = dataclasses.asdict(dataclasses.replace(get_reduced(arch),
                                                   **over))
    with _AllToAlls() as a2a:
        rec = dryrun.run_cell(arch, "train_4k", "single", overrides=small,
                              do_cost=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["flops_step"] > 0 and rec["collective_bytes"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    # remat "dots": each layer's two all-to-alls, their transposes and
    # the recompute's two
    assert a2a.n == 6 * get_reduced(arch).num_layers


#: the decode_32k cell of every full-width config on the (16, 16) mesh:
#: ok for the seven attention families (the head plan splits any head
#: count over a model axis of 16) and zamba2 (mamba by SSM head); xLSTM's
#: kinds still name item 6d-2 b (PERF.md states the sweep's split)
DECODE_OK = {"stablelm-3b", "chatglm3-6b", "gemma3-4b", "h2o-danube-1.8b",
             "llava-next-34b", "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b",
             "whisper-large-v3", "zamba2-7b"}


@pytest.mark.parametrize("arch", list_archs())
def test_decode_32k_of_every_full_config(out_dir, arch):
    rec = dryrun.run_cell(arch, "decode_32k", "single")
    if arch in DECODE_OK:
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["memory"]["argument_size_in_bytes"] > 0
        assert rec["roofline"]["bottleneck"] == "memory"
    else:
        assert rec["status"] == "error" and "item 6d" in rec["error"], rec
        cfg = get_config(arch)
        assert cfg.name in rec["error"]
