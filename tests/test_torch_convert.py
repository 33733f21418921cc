"""Carrying the reference's state across: program inputs keep their table
aliasing, and the DeepSeek-V2-Lite config and step program equal the
reference's field by field."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import deepseek_v2_lite_16b as jcfg
from repro.core import ops as jops
from repro.models.lm import LM
from repro_torch.configs import deepseek_v2_lite_16b as tcfg
from repro_torch.convert import (embed_tables_from_params,
                                 program_inputs_to_torch)
from repro_torch.models import moe as tmoe
from repro.models import moe as jmoe
from repro_torch.models.lm import embedding_program


def test_shared_tables_stay_one_tensor():
    prog = LM(jcfg.reduced()).embedding_program(2, 4)
    host = jops.make_program_inputs(prog, seed=3)
    assert host["tok_embed"]["table"] is host["label_gather"]["table"]
    ins = program_inputs_to_torch(host, "cpu")
    assert ins["tok_embed"]["table"] is ins["label_gather"]["table"]
    assert ins["moe_dispatch"]["table"] is not ins["tok_embed"]["table"]
    for name in host:
        t = ins[name]["table"]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), host[name]["table"])
        # the tensor is a copy, never a view of the caller's array
        assert not np.shares_memory(t.numpy(), host[name]["table"])
        assert isinstance(ins[name]["idxs"], np.ndarray)
        np.testing.assert_array_equal(ins[name]["idxs"], host[name]["idxs"])


def test_embed_tables_from_params_mirror_the_reference():
    embed = torch.zeros(8, 4)
    got = embed_tables_from_params({"embed": embed})
    want = LM(jcfg.reduced()).embedding_table_inputs({"embed": embed})
    assert got.keys() == want.keys()
    assert all(got[n]["table"] is embed for n in got)


@pytest.mark.parametrize("which", ["config", "reduced"])
def test_deepseek_config_equals_the_reference(which):
    got, want = getattr(tcfg, which)(), getattr(jcfg, which)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.padded_vocab == want.padded_vocab
    assert got.torch_dtype == getattr(torch, want.dtype)


@pytest.mark.parametrize("which,batch,seq", [("config", 8, 2048),
                                             ("reduced", 2, 8)])
def test_deepseek_step_program_equals_the_reference(which, batch, seq):
    got = embedding_program(getattr(tcfg, which)(), batch, seq)
    want = LM(getattr(jcfg, which)()).embedding_program(batch, seq)
    assert got.name == want.name
    assert got.shared_tables == want.shared_tables
    assert [n for n, _ in got.ops] == [n for n, _ in want.ops]
    for (_, g), (_, w) in zip(got.ops, want.ops):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


def test_undispatch_program_equals_the_reference():
    got = tmoe.undispatch_program(tcfg.config(), 16384)
    want = jmoe.undispatch_program(jcfg.config(), 16384)
    assert got.name == want.name
    assert [(n, dataclasses.asdict(o)) for n, o in got.ops] == \
        [(n, dataclasses.asdict(o)) for n, o in want.ops]
