"""The port stands alone: it imports no JAX and nothing of the JAX package
(the compiler, the executor, the LM and one served request run with both
unimportable), and its entry points do not fall back to the CPU when no
card is there."""
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro\b)",
                       re.M)


def test_port_runs_with_jax_and_repro_unimportable():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        from repro_torch.convert import program_inputs_to_torch
        from repro_torch.core.executor import executor_for
        from repro_torch.core.ops import (EmbeddingOp, EmbeddingProgram,
                                          make_program_inputs,
                                          program_reference)
        prog = EmbeddingProgram("two", (
            ("a", EmbeddingOp("sls", 4, 10, 8, avg_lookups=2)),
            ("b", EmbeddingOp("sls", 3, 12, 8, avg_lookups=3)),
        ))
        host = make_program_inputs(prog, seed=1)
        ex = executor_for(prog, "O3", device="cpu")
        assert len(ex.compiled.units) == 1 and ex.compiled.units[0].fused
        got = ex.step(program_inputs_to_torch(host, "cpu"))
        for n, want in program_reference(prog, host).items():
            np.testing.assert_allclose(got[n].numpy(), want, rtol=1e-5,
                                       atol=1e-5)
        import torch
        from repro_torch.configs import get_reduced
        from repro_torch.models.lm import LM
        from repro_torch.core.ops import make_program_inputs as mk
        lm = LM(get_reduced("chatglm3-6b"), device="cpu", seed=3)
        last = lm.prefill(torch.randint(0, 256, (2, 12)))
        assert last.shape == (2, 1, 64) and bool(torch.isfinite(last).all())
        mp = EmbeddingProgram("mp", (("m", EmbeddingOp("fusedmm", 6, 6, 8,
                                                       avg_lookups=2)),))
        host = mk(mp, seed=2)
        got = executor_for(mp, "O3", device="cpu").step(
            program_inputs_to_torch(host, "cpu"))
        np.testing.assert_allclose(got["m"].numpy(),
                                   program_reference(mp, host)["m"],
                                   rtol=1e-4, atol=1e-4)
        from repro_torch.launch import serve  # noqa: F401
        from repro_torch.runtime.server import DecodeServer, Request
        srv = DecodeServer(lm, batch_slots=2, max_len=32, prefill_chunk=4,
                           pipeline=True)
        req = Request(prompt=np.arange(5, dtype=np.int32), max_new_tokens=3)
        srv.submit(req)
        srv.run_until_drained()
        assert req.status == "ok" and len(req.out) == 3
        waves = srv.compile_stats["pipeline_group"]["waves"]
        assert waves == srv.serve_stats["waves"] == 4
        moe = LM(get_reduced("deepseek-v2-lite-16b"), device="cpu", seed=3)
        hidden, aux = moe(torch.randint(0, 256, (2, 12)), with_aux=True)
        assert hidden.shape == (2, 12, 64) and float(aux) > 0
        srv = DecodeServer(moe, batch_slots=2, max_len=32, prefill_chunk=4,
                           pipeline=True)
        req = Request(prompt=np.arange(5, dtype=np.int32), max_new_tokens=3)
        srv.submit(req)
        srv.run_until_drained()
        assert req.status == "ok" and len(req.out) == 3
        assert len(srv.pipeline_group.names) == 2
        # the dense_local kind and the vision-stub front end
        from repro_torch.configs import gemma3_4b, h2o_danube_1_8b, \
            llava_next_34b
        assert llava_next_34b.VISION_TOKENS == 576
        for arch in ("gemma3-4b", "h2o-danube-1.8b"):
            local = LM(get_reduced(arch), device="cpu", seed=3)
            assert type(local.blocks[0]).__name__ == "LocalBlock"
            srv = DecodeServer(local, batch_slots=2, max_len=32,
                               prefill_chunk=4, pipeline=True)
            req = Request(prompt=np.arange(11, dtype=np.int32),
                          max_new_tokens=3)
            srv.submit(req)
            srv.run_until_drained()
            assert req.status == "ok" and len(req.out) == 3
        vlm = LM(get_reduced("llava-next-34b"), device="cpu", seed=3)
        last = vlm.prefill(torch.randint(0, 256, (2, 12)),
                           torch.randn(2, 4, 64))
        assert last.shape == (2, 1, 64) and bool(torch.isfinite(last).all())
        # training: the loss's backward, AdamW, a checkpoint and a restart
        import tempfile
        from repro_torch.data.pipeline import DataConfig, SyntheticTokens
        from repro_torch.runtime.trainer import (Trainer, TrainerConfig,
                                                 run_supervised)
        cfg = get_reduced("deepseek-v2-lite-16b")
        data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=8, global_batch=2))
        with tempfile.TemporaryDirectory() as d:
            out = run_supervised(lambda: Trainer(
                LM(cfg, device="cpu", seed=3), data, TrainerConfig(
                    total_steps=4, ckpt_every=2, ckpt_dir=d)),
                failure_schedule={3})
        assert out["restarts"] == 1 and len(out["losses"]) == 2
        assert all(np.isfinite(out["losses"]))
        # whisper: the encoder, decode with its context, a training step
        wcfg = get_reduced("whisper-large-v3")
        whisper = LM(wcfg, device="cpu", seed=3)
        enc = torch.randn(2, 12, 64)
        last = whisper.prefill(torch.randint(0, 256, (2, 12)), None, enc)
        assert last.shape == (2, 1, 64) and bool(torch.isfinite(last).all())
        caches = whisper.init_caches(2, 16)
        logits, _ = whisper.wave_step(np.ones((2, 3), np.int32),
                                      np.array([3, 2]), caches,
                                      batch_ctx={"enc_out":
                                                 whisper._encode(enc)})
        assert logits.shape == (2, 1, 256) and caches[0]["len"].tolist() == \
            [3, 2]
        try:
            DecodeServer(whisper, batch_slots=2, max_len=16)
            raise AssertionError("the server took an encoder-decoder model")
        except NotImplementedError:
            pass
        wdata = SyntheticTokens(DataConfig(
            vocab_size=wcfg.vocab_size, seq_len=8, global_batch=2,
            modality=wcfg.modality, d_model=wcfg.d_model))
        with tempfile.TemporaryDirectory() as d:
            out = Trainer(whisper, wdata, TrainerConfig(
                total_steps=2, ckpt_every=1, ckpt_dir=d)).run()
        assert all(np.isfinite(out["losses"]))
        # zamba2: the mamba and shared_attn kinds, a prefill, a served
        # wave, two trainer steps
        zcfg = get_reduced("zamba2-7b")
        zamba = LM(zcfg, device="cpu", seed=3)
        assert [type(b).__name__ for b in zamba.blocks[:3]] == \
            ["MambaBlock", "MambaBlock", "SharedAttnBlock"]
        last = zamba.prefill(torch.randint(0, 256, (2, 16)))
        assert last.shape == (2, 1, 64) and bool(torch.isfinite(last).all())
        srv = DecodeServer(zamba, batch_slots=2, max_len=32, prefill_chunk=4,
                           pipeline=True)
        req = Request(prompt=np.arange(6, dtype=np.int32), max_new_tokens=2)
        srv.submit(req)
        srv.run_until_drained()
        assert req.status == "ok" and len(req.out) == 2
        zdata = SyntheticTokens(DataConfig(vocab_size=zcfg.vocab_size,
                                           seq_len=16, global_batch=2))
        with tempfile.TemporaryDirectory() as d:
            out = Trainer(zamba, zdata, TrainerConfig(
                total_steps=2, ckpt_every=1, ckpt_dir=d)).run()
        assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
        # xlstm: the mlstm and slstm kinds, a prefill, a served wave, two
        # trainer steps
        xcfg = get_reduced("xlstm-1.3b")
        xl = LM(xcfg, device="cpu", seed=3)
        assert [type(b).__name__ for b in xl.blocks] == \
            ["MlstmBlock"] * 3 + ["SlstmBlock"]
        last = xl.prefill(torch.randint(0, 256, (2, 16)))
        assert last.shape == (2, 1, 64) and bool(torch.isfinite(last).all())
        srv = DecodeServer(xl, batch_slots=2, max_len=32, prefill_chunk=4,
                           pipeline=True)
        req = Request(prompt=np.arange(6, dtype=np.int32), max_new_tokens=2)
        srv.submit(req)
        srv.run_until_drained()
        assert req.status == "ok" and len(req.out) == 2
        xdata = SyntheticTokens(DataConfig(vocab_size=xcfg.vocab_size,
                                           seq_len=16, global_batch=2))
        with tempfile.TemporaryDirectory() as d:
            out = Trainer(xl, xdata, TrainerConfig(
                total_steps=2, ckpt_every=1, ckpt_dir=d)).run()
        assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
                       if sys.modules[m] is not None)
        print("STANDALONE-OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(REPO), timeout=300,
                       env={"PYTHONPATH": str(REPO / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert "STANDALONE-OK" in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]


def test_no_port_source_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    assert {f"{n}.py" for n in ("gemma3_4b", "h2o_danube_1_8b",
                                 "llava_next_34b", "whisper_large_v3",
                                 "zamba2_7b", "ssm", "linear_scan",
                                 "xlstm_1_3b", "xlstm",
                                 "trainer", "ckpt",
                                 "adamw", "compress", "schedule",
                                 "pipeline", "train", "rpc",
                                 "embedding_service", "artifact")} <= \
        {f.name for f in files}
    offenders = [str(f.relative_to(REPO)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from repro_torch.convert import program_inputs_to_torch
    from repro_torch.core.executor import executor_for
    from repro_torch.core.ops import (EmbeddingOp, EmbeddingProgram,
                                      make_program_inputs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = EmbeddingProgram("p", (("a", EmbeddingOp("sls", 2, 5, 4)),))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        executor_for(prog)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        program_inputs_to_torch(make_program_inputs(prog))
    assert executor_for(prog, device="cpu").device == torch.device("cpu")
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve
    from repro_torch.models.lm import LM
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(get_reduced("chatglm3-6b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "chatglm3-6b", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "chatglm3-6b", "--reduced", "--disagg",
                    "--artifact-dir", str(tmp_path / "artifact")])
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "h2o-danube-1.8b", "--reduced", "--ckpt-dir",
                    str(tmp_path)])


def test_sharded_modules_stand_alone():
    """``core.shard_plan`` and ``launch.mesh`` import and run (a one-rank
    gloo group, its mesh and the executor over it) with JAX and the JAX
    package unimportable."""
    code = textwrap.dedent("""
        import os, sys, tempfile
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        import torch
        import torch.distributed as dist
        from repro_torch.convert import program_inputs_to_torch
        from repro_torch.core import shard_plan as sp
        from repro_torch.core.executor import executor_for
        from repro_torch.core.ops import (EmbeddingOp, EmbeddingProgram,
                                          make_program_inputs,
                                          program_reference)
        from repro_torch.launch.mesh import make_host_mesh, model_shard_count
        with tempfile.TemporaryDirectory() as d:
            dist.init_process_group("gloo", init_method="file://" +
                                    os.path.join(d, "store"), rank=0,
                                    world_size=1)
            mesh = make_host_mesh(1, device="cpu")
            assert model_shard_count(mesh) == 1
            coll = sp.Collectives(mesh.get_group("model"), "cpu",
                                  {"collectives": 0, "staged_bytes": 0,
                                   "collective_ms": 0.0})
            x = torch.arange(6.0).reshape(3, 2)
            assert torch.equal(coll.all_to_all(x[:1]), x[:1])
            assert torch.equal(coll.all_reduce(x, "max"), x)
            assert not coll.staged and coll.stats["collectives"] == 2
            prog = EmbeddingProgram("two", (
                ("a", EmbeddingOp("sls", 4, 10, 8, avg_lookups=2)),
                ("b", EmbeddingOp("sls", 3, 12, 8, avg_lookups=3)),
            ))
            host = make_program_inputs(prog, seed=1)
            ex = executor_for(prog, "O3", device="cpu", mesh=mesh)
            got = ex.step(program_inputs_to_torch(host, "cpu"))
            for n, want in program_reference(prog, host).items():
                np.testing.assert_allclose(got[n].numpy(), want, rtol=1e-5,
                                           atol=1e-5)
            dist.destroy_process_group()
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
                       if sys.modules[m] is not None)
        print("SHARDED-STANDALONE-OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(REPO), timeout=300,
                       env={"PYTHONPATH": str(REPO / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert "SHARDED-STANDALONE-OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]


def test_make_host_mesh_does_not_fall_back_to_the_cpu(monkeypatch):
    from repro_torch.launch.mesh import make_host_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh(2, device="cuda")


_TP_RANK_MODULE = '''
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import torch


def rank_main(rank, world):
    from repro_torch.configs import get_reduced
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM, ShardCtx
    from repro_torch.models.moe import moe_ffn_ep_plain
    from repro_torch.runtime.server import DecodeServer, Request
    mesh = make_host_mesh(world, device="cpu")
    out = {}
    for arch in ("chatglm3-6b", "qwen3-moe-235b-a22b"):
        lm = LM(get_reduced(arch), device="cpu", seed=3,
                shard=ShardCtx(mesh))
        assert sharding.param_specs(lm)["embed"] == ("model", None)
        last = lm.prefill(torch.arange(8).reshape(1, 8))
        srv = DecodeServer(lm, batch_slots=2, max_len=16, prefill_chunk=4)
        req = Request(prompt=np.arange(5, dtype=np.int32), max_new_tokens=3)
        srv.submit(req)
        srv.run_until_drained()
        assert req.status == "ok"
        assert srv.compile_stats["executor"]["shards"] == 2
        out[arch] = (last.numpy().copy(), list(req.out))
    assert callable(moe_ffn_ep_plain)
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
                   if sys.modules[m] is not None)
    return out
'''


def test_tensor_parallel_modules_stand_alone(tmp_path):
    """``launch.sharding``, the sharded LM, expert parallelism and the
    server over a sharded model import and run on two gloo ranks with JAX
    and the JAX package unimportable (in the ranks and their parent)."""
    (tmp_path / "tp_guard_rank.py").write_text(_TP_RANK_MODULE)
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        import tp_guard_rank
        from repro_torch.launch.mesh import run_ranks
        if __name__ == "__main__":
            r0, r1 = run_ranks(tp_guard_rank.rank_main, 2, timeout_s=240)
            for arch in r0:
                np.testing.assert_array_equal(r0[arch][0], r1[arch][0])
                assert r0[arch][1] == r1[arch][1]
                assert np.isfinite(r0[arch][0]).all()
            print("TP-STANDALONE-OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(REPO), timeout=300,
                       env={"PYTHONPATH": f"{REPO / 'src'}:{tmp_path}",
                            "PATH": "/usr/bin:/bin"})
    assert "TP-STANDALONE-OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]


_MP_RANK_MODULE = '''
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None


def rank_main(rank, world, ckpt):
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch import train  # noqa: F401
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import train_specs
    from repro_torch.models.lm import LM, ShardCtx
    from repro_torch.runtime.trainer import (Trainer, TrainerConfig,
                                             run_supervised)
    cfg = get_reduced("h2o-danube-1.8b")
    mesh = make_host_mesh(2, device="cpu")
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                      global_batch=4))
    out = run_supervised(lambda: Trainer(
        LM(cfg, device="cpu", seed=1, shard=ShardCtx(mesh)), data,
        TrainerConfig(total_steps=4, ckpt_every=2, ckpt_dir=ckpt),
        in_shardings=train_specs(cfg, mesh, 4, 8)),
        failure_schedule={3})
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
                   if sys.modules[m] is not None)
    return out["restarts"], [float(x) for x in out["losses"]]
'''


def test_model_parallel_training_stands_alone(tmp_path):
    """The loss over a mesh, the sharded trainer (its ``in_shardings`` from
    ``launch.sharding.train_specs``), sharded checkpoints and the
    supervised restart run on two gloo ranks of a ``(1, 2)`` mesh with JAX
    and the JAX package unimportable, in the ranks and their parent."""
    (tmp_path / "mp_guard_rank.py").write_text(_MP_RANK_MODULE)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        import mp_guard_rank
        from repro_torch.launch.mesh import run_ranks
        if __name__ == "__main__":
            r0, r1 = run_ranks(mp_guard_rank.rank_main, 2,
                               ({str(tmp_path / 'ckpt')!r},), timeout_s=240)
            assert r0 == r1 and r0[0] == 1 and np.isfinite(r0[1]).all()
            print("MP-STANDALONE-OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(REPO), timeout=300,
                       env={"PYTHONPATH": f"{REPO / 'src'}:{tmp_path}",
                            "PATH": "/usr/bin:/bin"})
    assert "MP-STANDALONE-OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]


def test_disaggregated_tier_stands_alone(tmp_path):
    """The RPC tier, the replica pool, the disaggregated executor, the
    serving artifact and a disagg server run with JAX and the JAX package
    unimportable, and each spawned replica's ping shows neither imported
    in its own process."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        import torch
        from repro_torch.convert import program_inputs_to_torch
        from repro_torch.core.executor import (clear_executor_cache,
                                               executor_for)
        from repro_torch.core.ops import (EmbeddingOp, EmbeddingProgram,
                                          make_program_inputs)
        from repro_torch.core.pipeline import clear_compile_cache
        from repro_torch.runtime.embedding_service import ServicePool
        prog = EmbeddingProgram("g", (
            ("a", EmbeddingOp("sls", 4, 10, 8, avg_lookups=2)),
            ("b", EmbeddingOp("gather", 3, 12, 8))))
        ins = program_inputs_to_torch(make_program_inputs(prog, seed=1),
                                      "cpu")
        want = executor_for(prog, device="cpu").step(ins)
        with ServicePool(2, device="cpu", backoff_s=0.01) as pool:
            ex = executor_for(prog, device="cpu", service="disagg",
                              service_pool=pool)
            for _ in range(2):
                got = ex.step(ins)
                assert all(torch.equal(got[n], want[n]) for n in want)
            for r in pool.replicas:
                ping = r.hb.call("ping")[0]
                assert ping["foreign_modules"] == [], ping
                assert ping["device"] == "cpu" and ping["steps"] == 1
        adir = {str(tmp_path / 'artifact')!r}
        sources = []
        for _ in range(2):
            clear_executor_cache(); clear_compile_cache()
            ex = executor_for(prog, device="cpu", artifact_dir=adir)
            got = ex.step(ins)
            assert all(torch.equal(got[n], want[n]) for n in want)
            sources.append(ex.compile_source)
        assert sources == ["fresh", "artifact"], sources
        from repro_torch.launch import serve
        reqs = serve.main(["--arch", "stablelm-3b", "--reduced", "--device",
                           "cpu", "--requests", "2", "--max-len", "24",
                           "--pipeline", "--disagg", "--replicas", "1"])
        assert all(r.status == "ok" for r in reqs)
        assert sys.modules["jax"] is None and sys.modules["repro"] is None
        print("DISAGG-STANDALONE-OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(REPO), timeout=300,
                       env={"PYTHONPATH": str(REPO / "src"),
                            "PATH": "/usr/bin:/bin",
                            "TMPDIR": str(tmp_path)})
    assert "DISAGG-STANDALONE-OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]


def test_dry_run_and_roofline_stand_alone(tmp_path):
    """``launch.steps``, ``launch.dryrun``, ``roofline.analysis`` and
    ``roofline.report`` import, and one dry cell (stablelm-3b's decode_32k
    on the (16, 16) mesh, with its cost pass) runs and renders, with JAX
    and the JAX package unimportable."""
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        from repro_torch.launch import dryrun, steps
        from repro_torch.roofline import analysis, report
        dryrun.OUT_DIR = report.DRYRUN = Path({str(tmp_path)!r})
        rec = dryrun.run_cell("stablelm-3b", "decode_32k", "single")
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["roofline"]["step_lower_bound_s"] > 0
        assert steps.SHAPES["decode_32k"] == (32768, 128, "decode")
        assert analysis.HW().peak_flops == 989e12
        rows = report.build_rows("single")
        assert "| stablelm-3b | decode_32k |" in report.markdown(rows)
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
                       if sys.modules[m] is not None)
        assert sys.modules["jax"] is None and sys.modules["repro"] is None
        print("DRYRUN-STANDALONE-OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(REPO), timeout=300,
                       env={"PYTHONPATH": str(REPO / "src"),
                            "PATH": "/usr/bin:/bin",
                            "TMPDIR": str(tmp_path)})
    assert "DRYRUN-STANDALONE-OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]


_HEADS_RANK_MODULE = '''
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None


def rank_main(rank, world, ckpt):
    import dataclasses
    import torch
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM, ShardCtx
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    mesh = make_host_mesh(world, device="cpu")
    shard = ShardCtx(mesh)
    toks = torch.randint(0, 256, (2, 8), generator=torch.Generator()
                         .manual_seed(1))
    out = {}
    cfg = dataclasses.replace(get_reduced("chatglm3-6b"), num_heads=6,
                              num_kv_heads=2, head_dim=8)
    lm = LM(cfg, device="cpu", seed=3, shard=shard)
    data = SyntheticTokens(DataConfig(vocab_size=256, seq_len=8,
                                      global_batch=2))
    res = Trainer(lm, data, TrainerConfig(total_steps=2, ckpt_every=1,
                                          ckpt_dir=ckpt)).run()
    wk = res["state"]["params"]["blocks.0.attn.wk"]
    out["glm"] = (res["losses"], tuple(wk.shape), float(wk.sum()))
    ds = LM(get_reduced("deepseek-v2-lite-16b"), device="cpu", seed=3,
            shard=shard)
    caches = ds.init_caches(2, 12)
    lg, _ = ds.decode_step(toks[:, :1], caches)
    out["mla"] = (float(ds.prefill(toks).float().sum()), float(lg.sum()))
    wh = LM(get_reduced("whisper-large-v3"), device="cpu", seed=3,
            shard=shard)
    enc = torch.randn((2, 8, 64), generator=torch.Generator().manual_seed(2))
    out["xdec"] = float(wh.loss(toks, toks, None, enc))
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
                   if sys.modules[m] is not None)
    return out
'''


def test_attention_kinds_over_any_model_axis_stand_alone(tmp_path):
    """The head plan's paths -- 6 query heads over 2 KV heads on four
    ranks (KV copies, query heads that do not divide the axis) trained
    two steps with sharded checkpoints, DeepSeek-V2-Lite's MLA prefill and
    decode, whisper's encoder-decoder loss -- run on four gloo ranks with
    JAX and the JAX package unimportable, in the ranks and their parent;
    a KV copy is the same bits on every rank of its group."""
    (tmp_path / "heads_guard_rank.py").write_text(_HEADS_RANK_MODULE)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import math
        import heads_guard_rank
        from repro_torch.launch.mesh import run_ranks
        if __name__ == "__main__":
            res = run_ranks(heads_guard_rank.rank_main, 4,
                            ({str(tmp_path / 'ckpt')!r},), timeout_s=240)
            assert len({{str(r["glm"][0]) for r in res}}) == 1
            assert res[0]["glm"][2] == res[1]["glm"][2]    # a KV copy
            assert res[2]["glm"][2] == res[3]["glm"][2]
            assert res[0]["glm"][1] == (64, 8)
            assert len({{r["mla"] for r in res}}) == 1
            assert len({{r["xdec"] for r in res}}) == 1
            assert all(math.isfinite(x) for r in res
                       for x in (r["xdec"],) + r["mla"])
            print("HEADS-STANDALONE-OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(REPO), timeout=300,
                       env={"PYTHONPATH": f"{REPO / 'src'}:{tmp_path}",
                            "PATH": "/usr/bin:/bin",
                            "TMPDIR": str(tmp_path)})
    assert "HEADS-STANDALONE-OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]
