"""Shared neural-net layers: norms, RoPE, chunked attention, MLPs (port of
``repro/models/layers.py``).

Everything is functional on tensors: ``init_*(gen, ...) -> {name: tensor}``
draws from an explicit ``torch.Generator`` on its device, and
``*_apply(p, x, ...)`` takes the layer's flat params dict.  Attention is
q-chunked (a loop over query blocks against the full K/V with masking), as
the reference's scan is, so a long prefill never materialises an S x S
score matrix.  Every ``init_*`` takes ``lead``, the leading stack shape of
the reference's stacked ``[L, ...]`` leaves, and draws the whole stack at
once.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

_INVALID_POS = 2**31 // 2 - 1       # int32 max // 2: an empty cache slot


def _init(gen: torch.Generator, shape: Sequence[int], scale=None,
          dtype=torch.float32, lead: Sequence[int] = ()) -> torch.Tensor:
    """``normal * scale`` over ``lead + shape`` (scale 1/sqrt(shape[0]))."""
    scale = shape[0] ** -0.5 if scale is None else scale
    x = torch.randn(tuple(lead) + tuple(shape), generator=gen,
                    device=gen.device).mul_(scale)
    return x.to(dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)`` (torch's ``softplus``
    returns x above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps=1e-6) -> torch.Tensor:
    # the mean of x's own-dtype squares, accumulated in f32
    var = torch.mean(torch.square(x), dim=-1, keepdim=True,
                     dtype=torch.float32)
    return ((x * torch.rsqrt(var + eps).to(x.dtype))
            * (1.0 + gamma.to(x.dtype)))


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta=10000.0) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S].  Halves concatenated, not
    interleaved."""
    half = x.shape[-1] // 2
    expo = -torch.arange(0, half, dtype=torch.float32,
                         device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), expo)
    ang = positions[..., None].to(torch.float32) * freq    # [..., S, half]
    ang = ang[..., None, :]                                # [..., S, 1, half]
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA, causal, optional sliding window), q-chunked
# ---------------------------------------------------------------------------

def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
          causal: bool) -> torch.Tensor:
    """[B, Sq, Sk] mask from q_pos [B, Sq], k_pos [B, Sk]: causal, and
    |q - k| < window when window > 0."""
    if causal:
        m = q_pos[:, :, None] >= k_pos[:, None, :]
    else:
        # still exclude invalid (sentinel-position) cache slots
        m = (k_pos[:, None, :] < _INVALID_POS).expand(
            q_pos.shape[0], q_pos.shape[1], k_pos.shape[1])
    if window > 0:
        m = m & ((q_pos[:, :, None] - k_pos[:, None, :]) < window)
    return m


def attention(q, k, v, q_pos, k_pos, *, window: int = 0, q_chunk: int = 512,
              causal: bool = True, softmax_dtype=torch.float32):
    """q: [B, Sq, H, D]; k, v: [B, Sk, KV, D]; grouped-query attention.

    Loops over query chunks of ``q_chunk`` when Sq is a multiple of it (and
    longer); each chunk attends to the full K/V with a position mask.
    """
    b, sq, h, d = q.shape
    kv = k.shape[2]
    assert h % kv == 0
    rep = h // kv
    scale = d ** -0.5
    if q_pos.dim() == 1:
        q_pos = q_pos.expand(b, sq)
    if k_pos.dim() == 1:
        k_pos = k_pos.expand(b, k_pos.shape[0])
    if sq <= q_chunk or sq % q_chunk != 0:
        return _attn_block(q, k, v, q_pos, k_pos, rep, scale, window, causal,
                           softmax_dtype)
    outs = [_attn_block(q[:, i:i + q_chunk], k, v, q_pos[:, i:i + q_chunk],
                        k_pos, rep, scale, window, causal, softmax_dtype)
            for i in range(0, sq, q_chunk)]
    return torch.cat(outs, dim=1)


def _attn_block(q, k, v, q_pos, k_pos, rep, scale, window, causal,
                softmax_dtype):
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, rep, d)
    # grouped attention without materialising repeated K/V
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg, k).to(softmax_dtype) * scale
    mask = _mask(q_pos, k_pos, window, causal)
    scores = torch.where(mask[:, None, None], scores,
                         torch.finfo(softmax_dtype).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v)
    return out.reshape(b, sq, h, d)


def init_attn(gen, d_model, n_heads, n_kv, head_dim, dtype=torch.float32,
              lead=()) -> Params:
    kw = dict(dtype=dtype, lead=lead)
    return {
        "wq": _init(gen, (d_model, n_heads * head_dim), **kw),
        "wk": _init(gen, (d_model, n_kv * head_dim), **kw),
        "wv": _init(gen, (d_model, n_kv * head_dim), **kw),
        "wo": _init(gen, (n_heads * head_dim, d_model), **kw),
    }


def init_attn_cache(b, cache_len, n_kv, head_dim, dtype=torch.bfloat16,
                    lead=(), device=None) -> Params:
    """Ring-buffer KV cache. ``pos`` holds the absolute position stored in
    each slot (sentinel = empty); sliding-window archs use cache_len=window."""
    lead = tuple(lead)
    return {
        "k": torch.zeros(lead + (b, cache_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros(lead + (b, cache_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "pos": torch.full(lead + (cache_len,), _INVALID_POS,
                          dtype=torch.int32, device=device),
    }


def attn_apply(p: Params, x, positions, *, n_heads, n_kv, head_dim, window=0,
               causal=True, rope_theta=10000.0, q_chunk=512,
               softmax_dtype=torch.float32, cache: Optional[Params] = None,
               pos: Optional[int] = None, cross_kv=None):
    """Self- or cross-attention.  Returns (y, cache).

    cache: optional ring-buffer cache (decode), updated in place: the new
    k/v go to slot ``pos % cache_len`` and attention runs against the whole
    cache using the absolute positions stored per slot.
    cross_kv: optional precomputed (k, v, k_pos) for encoder-decoder
    cross-attention.
    """
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, n_heads, head_dim)
    if cross_kv is not None:
        ck, cv, k_pos = cross_kv
        out = attention(q, ck, cv, positions, k_pos, window=0, causal=False,
                        q_chunk=q_chunk, softmax_dtype=softmax_dtype)
        return out.reshape(b, s, -1) @ p["wo"], None

    k = (x @ p["wk"]).reshape(b, s, n_kv, head_dim)
    v = (x @ p["wv"]).reshape(b, s, n_kv, head_dim)
    if rope_theta:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    if cache is not None:
        slot = pos % cache["k"].shape[1]
        cache["k"][:, slot:slot + s] = k.to(cache["k"].dtype)
        cache["v"][:, slot:slot + s] = v.to(cache["v"].dtype)
        cache["pos"][slot] = pos
        out = attention(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                        positions, cache["pos"], window=window,
                        q_chunk=q_chunk, softmax_dtype=softmax_dtype)
        return out.reshape(b, s, -1) @ p["wo"], cache
    out = attention(q, k, v, positions, positions, window=window,
                    causal=causal, q_chunk=q_chunk,
                    softmax_dtype=softmax_dtype)
    return out.reshape(b, s, -1) @ p["wo"], None


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model, d_ff, activation, dtype=torch.float32,
             lead=()) -> Params:
    p = {"w_up": _init(gen, (d_model, d_ff), dtype=dtype, lead=lead),
         "w_down": _init(gen, (d_ff, d_model), dtype=dtype, lead=lead)}
    if activation == "silu":                  # gated (SwiGLU)
        p["w_gate"] = _init(gen, (d_model, d_ff), dtype=dtype, lead=lead)
    return p


def activate(h: torch.Tensor, activation: str) -> torch.Tensor:
    """The MLP nonlinearity on ``x @ w_up`` (silu's gate is apart)."""
    if activation == "relu2":                 # squared ReLU (nemotron)
        return torch.square(torch.relu(h))
    if activation == "gelu":
        return gelu(h)
    raise ValueError(activation)


def mlp_apply(p: Params, x, activation: str):
    if activation == "silu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = activate(x @ p["w_up"], activation)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Chunked cross-entropy (never materialises [B, S, V])
# ---------------------------------------------------------------------------

def chunked_xent(x, w_out, labels, *, chunk=512):
    """x: [B, S, d], w_out: [d, V], labels: [B, S] (-1 = ignore) -> mean NLL.

    Loops over sequence chunks, summing in chunk order as the reference's
    scan does, so peak logits memory is [B, chunk, V].
    """
    b, s, d = x.shape
    if s <= chunk:
        n_tok, nll = _xent_block(x, w_out, labels)
        return nll / torch.clamp(n_tok, min=1.0)
    if s % chunk:                       # pad with ignored labels
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        s += pad
    tot_tok = torch.zeros((), dtype=torch.float32, device=x.device)
    tot_nll = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        n_tok, nll = _xent_block(x[:, i:i + chunk], w_out,
                                 labels[:, i:i + chunk])
        tot_tok, tot_nll = tot_tok + n_tok, tot_nll + nll
    return tot_nll / torch.clamp(tot_tok, min=1.0)


def _xent_block(x, w_out, labels):
    logits = (x @ w_out).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    valid = (labels >= 0).to(torch.float32)
    return torch.sum(valid), torch.sum((logz - gold) * valid)
