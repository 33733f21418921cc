"""Training data pipeline.

Deterministic, restartable synthetic token stream: the batch at step ``k``
is a pure function of (seed, k), so a restarted/elastically-rescaled job
resumes mid-epoch with zero state beyond the step counter (the checkpoint
stores only ``step``).  Sharded hosts draw disjoint slices of the global
batch by host index — the standard per-host data-loading contract.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    modality: str = "text"
    d_model: int = 0           # for stub frontends
    enc_seq: int = 0


class SyntheticTokens:
    """Markov-ish synthetic text: zipf unigram with local repetition, so the
    loss actually decreases during the e2e example runs."""

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1):
        assert cfg.global_batch % host_count == 0
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** -1.1
        self._p = p / p.sum()

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, self.host_index))
        b, s = self.local_batch, cfg.seq_len
        base = rng.choice(cfg.vocab_size, size=(b, s + 1), p=self._p)
        # local repetition: with p=0.3 copy the previous token (learnable)
        rep = rng.random((b, s + 1)) < 0.3
        for t in range(1, s + 1):
            base[:, t] = np.where(rep[:, t], base[:, t - 1], base[:, t])
        out = {"tokens": base[:, :-1].astype(np.int32),
               "labels": base[:, 1:].astype(np.int32)}
        if cfg.modality == "audio-stub":
            out["enc_embeds"] = rng.standard_normal(
                (b, cfg.enc_seq or s, cfg.d_model)).astype(np.float32)
        elif cfg.modality == "vision-stub":
            out["frontend_embeds"] = rng.standard_normal(
                (b, min(576, s), cfg.d_model)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
