"""The one generator of the benchmark's traffic: a mix's JSON file holds
its parameters, and every batch of a run comes from ``(seed, batch
index)``.

Tokens: a Zipf-distributed stream with a bigram structure (a copy of the
arithmetic of the port's ``data/synthetic.py``): each row starts from the
Zipf prior, and token t+1 is the fixed successor of token t with
probability ``bigram_weight``, else a fresh draw from the prior.  Frames
(the encoder-decoder family's stubbed audio front end): standard normal
frame embeddings ``[rows, frames, d_model]``, drawn on the device in one
call for the whole pool.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

FRAMES_TAG = 1 << 41            # the frames' generator: seed + FRAMES_TAG


class ZipfStream:
    def __init__(self, vocab: int, seq: int, rows: int, zipf_a: float,
                 bigram_weight: float, seed: int):
        self.vocab, self.seq, self.rows = vocab, seq, rows
        self.bigram_weight, self.seed = bigram_weight, seed
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self.prior = ranks ** -zipf_a
        self.prior /= self.prior.sum()
        rng = np.random.default_rng(seed)
        self.successor = rng.permutation(vocab).astype(np.int32)

    def batch_at(self, index: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, index))
        b, s, v = self.rows, self.seq, self.vocab
        out = np.empty((b, s), np.int32)
        cur = rng.choice(v, size=b, p=self.prior)
        out[:, 0] = cur
        noise = rng.random((b, s))
        fresh = rng.choice(v, size=(b, s), p=self.prior)
        for t in range(1, s):
            follow = noise[:, t] < self.bigram_weight
            cur = np.where(follow, self.successor[cur], fresh[:, t])
            out[:, t] = cur
        return out


def make_batches(traffic: dict, cfg: dict, seed: int, device,
                 count: int) -> List[Dict[str, torch.Tensor]]:
    """Batches 0 .. count-1 of a run: ``{"tokens": int32 [rows, seq]}``,
    with ``"frames"`` for the encoder-decoder family."""
    st = traffic["stream"]
    stream = ZipfStream(cfg["vocab"], traffic["seq"], traffic["rows"],
                        st["zipf_a"], st["bigram_weight"], seed)
    out = [{"tokens": torch.from_numpy(stream.batch_at(i)).to(device)}
           for i in range(count)]
    if cfg["family"] == "encdec":
        if traffic["frames"] != cfg["n_frames"]:
            raise ValueError(f"traffic frames {traffic['frames']} != the "
                             f"config's n_frames {cfg['n_frames']}")
        gen = torch.Generator(device=device).manual_seed(seed + FRAMES_TAG)
        frames = torch.randn((count, traffic["rows"], cfg["n_frames"],
                              cfg["d_model"]), generator=gen, device=device)
        for b, f in zip(out, frames):
            b["frames"] = f
    return out


def positions(traffic: dict, cfg: dict) -> int:
    """Input positions a step consumes: tokens, and frames where the model
    has an encoder."""
    per_row = traffic["seq"] + (cfg["n_frames"] if cfg["family"] == "encdec"
                                else 0)
    return traffic["rows"] * per_row
