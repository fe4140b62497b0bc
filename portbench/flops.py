"""The benchmark's count of a training step's model FLOPs.

Every matrix product of the forward pass costs 2 FLOPs a multiply-add, the
backward pass twice that, so a weight matrix of ``n`` elements applied at
``P`` positions costs ``6 n P``; attention's two products (scores and the
weighted values) cost ``12 H hd`` a (query, key) pair.  Counted:
the projections, the MLP and the output head at every position they act
on (encoder weights and the cross-attention's key and value projections at
the frames, the rest at the tokens; the front end at the frames); a causal
attention's pairs at or below the diagonal, a non-causal one's all.  Left
out: the embedding lookup (a gather), norms and activations (elementwise),
and what rematerialisation recomputes.
"""
from __future__ import annotations


def _hd(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def step_flops(cfg: dict, rows: int, seq: int, frames: int = 0) -> float:
    d, ff, v = cfg["d_model"], cfg["d_ff"], cfg["vocab"]
    hq = cfg["n_heads"] * _hd(cfg)
    hk = cfg["n_kv"] * _hd(cfg)
    mlp = (3 if cfg["activation"] == "silu" else 2) * d * ff
    self_attn = 2 * d * hq + 2 * d * hk
    encdec = cfg["family"] == "encdec"
    n_dec, n_enc = cfg["n_layers"], cfg.get("enc_layers", 0) if encdec else 0
    on_tokens = n_dec * (self_attn + mlp + (2 * d * hq if encdec else 0)) \
        + d * v
    on_frames = (n_enc * (self_attn + mlp) + n_dec * 2 * d * hk + d * d
                 if encdec else 0)
    tokens, fr = rows * seq, rows * frames
    linear = 6.0 * (on_tokens * tokens + on_frames * fr)
    pairs = n_dec * rows * seq * (seq + 1) / 2
    if encdec:
        pairs += n_dec * rows * seq * frames + n_enc * rows * frames * frames
    return linear + 12.0 * hq * pairs
