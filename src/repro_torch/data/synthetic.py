"""Synthetic LM data (no datasets ship offline), numpy only.

A copy of the reference package's LM pipeline: token t+1 is drawn from a
random projection table of (t, t-1) with 5% noise, a learnable next-token
task. The stream is deterministic in (seed, step), so the same seed gives
the same batches here as in the reference, and a restarted job resumes
identical batches.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def _lm_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int,
              table: np.ndarray) -> dict:
    x = np.empty((batch, seq), np.int32)
    x[:, 0] = rng.integers(0, vocab, batch)
    x[:, 1] = rng.integers(0, vocab, batch)
    noise = rng.random((batch, seq)) < 0.05
    rand = rng.integers(0, vocab, (batch, seq))
    for t in range(2, seq):
        nxt = table[x[:, t - 1], x[:, t - 2] % table.shape[1]]
        x[:, t] = np.where(noise[:, t], rand[:, t], nxt)
    return {"tokens": x[:, :-1].copy(), "labels": x[:, 1:].copy()}


def lm_batches(batch: int, seq: int, vocab: int, seed: int = 0,
               start_step: int = 0) -> Iterator[dict]:
    """Deterministic, resumable stream of {"tokens","labels"} ([B, seq])."""
    table_rng = np.random.default_rng(seed)
    table = table_rng.integers(0, vocab, (vocab, min(vocab, 64))).astype(np.int32)
    step = start_step
    while True:
        rng = np.random.default_rng((seed + 1) * 1_000_003 + step)
        yield _lm_batch(rng, batch, seq + 1, vocab, table)
        step += 1
