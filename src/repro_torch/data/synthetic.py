"""Synthetic token streams for LM training (port of
``repro/data/synthetic.py``: the same numpy generator, so the tokens equal
the reference's bit for bit).

A Zipf-distributed Markov-ish token source with enough structure for the
loss to visibly drop within a few hundred steps: token t+1 is drawn from a
mixture of a global Zipf prior and a deterministic successor of token t;
models must learn the bigram table to win.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch import default_device


@dataclasses.dataclass
class TokenStreamConfig:
    vocab: int
    seq_len: int
    batch: int
    bigram_weight: float = 0.65   # how predictable the stream is
    zipf_a: float = 1.2
    seed: int = 0


class TokenStream:
    """Deterministic synthetic corpus; ``batch_at(step)`` is pure in (step)
    and puts its int32 tokens on ``device`` (CUDA unless named)."""

    def __init__(self, cfg: TokenStreamConfig, device=None):
        self.cfg = cfg
        self.device = default_device(device)
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.prior = (ranks ** -cfg.zipf_a)
        self.prior /= self.prior.sum()
        # a fixed random permutation as the "grammar" (bigram successor table)
        self.successor = rng.permutation(v).astype(np.int32)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s, v = cfg.batch, cfg.seq_len, cfg.vocab
        out = np.empty((b, s), np.int32)
        cur = rng.choice(v, size=b, p=self.prior)
        out[:, 0] = cur
        noise = rng.random((b, s))
        fresh = rng.choice(v, size=(b, s), p=self.prior)
        for t in range(1, s):
            follow = noise[:, t] < cfg.bigram_weight
            cur = np.where(follow, self.successor[cur], fresh[:, t])
            out[:, t] = cur
        return {"tokens": torch.from_numpy(out).to(self.device)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def bigram_entropy(cfg: TokenStreamConfig) -> float:
    """Achievable NLL floor (nats/token) for a model that learns the bigram."""
    w = cfg.bigram_weight
    prior = TokenStream(cfg, device="cpu").prior
    h_prior = -float(np.sum(prior * np.log(prior)))
    # mixture: w on successor, (1-w) from prior
    h = -(w * np.log(w + (1 - w) * prior.mean()))   # rough bound
    return float(min(h + (1 - w) * h_prior, h_prior))
