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
    offenders = [str(f.relative_to(REPO)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_entry_points_raise_without_a_card(monkeypatch):
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
