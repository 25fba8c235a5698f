"""Synthetic data (no datasets ship offline), numpy only.

Copies of the reference package's pipelines, so that the same seed gives
bitwise the same batches here as there:

- LM: token t+1 is drawn from a random projection table of (t, t-1) with
  5% noise, a learnable next-token task. The stream is deterministic in
  (seed, step), so a restarted job resumes identical batches.
- Vision transfer (`TransferTask`): 10 classes of coloured blobs in a
  "pretrain" domain and rings of rotated, recoloured blobs in the "target"
  domain, images NHWC fp32; a batch is a pure function of
  (seed, step, domain).
"""
from __future__ import annotations

from dataclasses import dataclass
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


# ---------------------------------------------------------------------------
# vision transfer
# ---------------------------------------------------------------------------

@dataclass
class TransferTask:
    num_classes: int = 10
    img: int = 32
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # class prototypes: blob centers + colors, pretrain vs target domain
        self.centers_a = rng.uniform(0.25, 0.75, (self.num_classes, 2))
        self.colors_a = rng.uniform(-1, 1, (self.num_classes, 3))
        rot = np.array([[0, -1], [1, 0]])
        self.centers_b = 0.5 + (self.centers_a - 0.5) @ rot.T
        self.colors_b = np.roll(self.colors_a, 1, axis=1) * 0.9

    def batch(self, n: int, step: int, domain: str = "target") -> dict:
        """{"images": [n, img, img, 3] fp32, "labels": [n] int32}."""
        rng = np.random.default_rng(self.seed * 7 + step * 13 +
                                    (0 if domain == "target" else 1))
        labels = rng.integers(0, self.num_classes, n)
        centers = self.centers_b if domain == "target" else self.centers_a
        colors = self.colors_b if domain == "target" else self.colors_a
        yy, xx = np.mgrid[0:self.img, 0:self.img] / self.img
        imgs = np.empty((n, self.img, self.img, 3), np.float32)
        for i, c in enumerate(labels):
            cy, cx = centers[c] + rng.normal(0, 0.05, 2)
            sigma = 0.12 + rng.normal(0, 0.02)
            r2 = (yy - cy) ** 2 + (xx - cx) ** 2
            if domain == "target":
                # rings instead of filled blobs: low-level feature detectors
                # must adapt, not just the classifier (real transfer)
                shape = np.exp(-((np.sqrt(r2) - 2 * sigma) ** 2) /
                               max(sigma * sigma / 2, 1e-3))
            else:
                shape = np.exp(-(r2 / max(2 * sigma * sigma, 1e-3)))
            img = shape[..., None] * colors[c]
            img = img + rng.normal(0, 0.15, img.shape)
            imgs[i] = img
        return {"images": imgs, "labels": labels.astype(np.int32)}


def transfer_image_batches(batch: int, img: int = 32, seed: int = 0,
                           domain: str = "target",
                           start_step: int = 0) -> Iterator[dict]:
    task = TransferTask(img=img, seed=seed)
    step = start_step
    while True:
        yield task.batch(batch, step, domain)
        step += 1
