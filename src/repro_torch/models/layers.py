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

def rows_local(fn, rows, whole=(), **kw):
    """``fn(*rows, *whole, **kw)`` on plain tensors, each rank on its own
    block of rows.  Where a tensor of ``rows`` is a DTensor, every tensor of
    ``rows`` is placed with dim 0 split over the mesh dims where the first
    DTensor of them splits it (replicated over the others), every tensor of
    ``whole`` replicated (a plain tensor is taken as replicated), and the
    output comes back as a DTensor so placed.  For ops independent across
    rows (a batch, MoE groups) that DTensor shards badly: its index_put and
    index_add rules, and its planning of a padded sequence, fail on some
    versions."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    lead = next((a for a in rows if isinstance(a, DTensor)), None)
    if lead is None:
        return fn(*rows, *whole, **kw)
    mesh = lead.device_mesh
    want = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in lead.placements]
    rep = [Replicate()] * mesh.ndim

    def local(a, placements):
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, rep, run_check=False)
        if tuple(a.placements) != tuple(placements):
            a = a.redistribute(mesh, placements)
        return a.to_local()

    out = fn(*[local(a, want) for a in rows],
             *[local(a, rep) for a in whole], **kw)
    return DTensor.from_local(out, mesh, want, run_check=False)


def embed(table: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """The rows ``table[tok]``; on a DTensor table, through
    ``F.embedding``, whose sharding rules (a feature-sharded table, sharded
    token rows) DTensor has, where its indexing's backward (an index_put)
    has none on some versions."""
    from torch.distributed.tensor import DTensor
    if isinstance(table, DTensor):
        return F.embedding(tok, table)
    return table[tok]


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
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _sharded_attn_block(q, k, v, q_pos, k_pos, rep, scale,
                                   window, causal, softmax_dtype)
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


def _sharded_attn_block(q, k, v, q_pos, k_pos, rep, scale, window, causal,
                        softmax_dtype):
    """``_attn_block`` on DTensors, each rank on its own batch rows and
    query heads: attention is independent across both.  On each mesh dim
    the batch (dim 0) stays split where q, k and v all split it; q's head
    split (dim 2) stays, and k and v keep theirs there too where they split
    their heads the same way, else they are gathered on that dim (their
    heads need not divide it where the query heads do); every other dim
    is replicated.  The block then runs on the local tensors, each rank's
    query heads against the KV heads their groups read (``_local_kv``).
    DTensor's own einsum would flatten a sharded head dim into the batch,
    which some versions refuse."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    want_q, want_kv, grad_kv = [], [], []
    for pq, pk, pv in zip(q.placements, k.placements, v.placements):
        same = pq == pk == pv
        if pq == Shard(2):
            wq, wkv = pq, pq if same else Replicate()
        elif pq == Shard(0) and same:
            wq = wkv = pq
        else:
            wq = wkv = Replicate()
        want_q.append(wq)
        want_kv.append(wkv)
        # K/V gathered under split query heads: each rank's gradient of
        # them is its own heads' share
        grad_kv.append(Partial() if wq != wkv else wkv)
    q = q if tuple(q.placements) == tuple(want_q) else \
        q.redistribute(mesh, want_q)
    k, v = (t if tuple(t.placements) == tuple(want_kv)
            else t.redistribute(mesh, want_kv) for t in (k, v))
    ql = q.to_local()
    rows = ql.shape[0]
    h0 = _head_offset(mesh, want_q, q.shape[2])
    k0 = _head_offset(mesh, want_kv, k.shape[2])
    kl, rep_l = _local_kv(k.to_local(grad_placements=grad_kv), k0, h0,
                          ql.shape[2], rep)
    vl, _ = _local_kv(v.to_local(grad_placements=grad_kv), k0, h0,
                      ql.shape[2], rep)

    def local_pos(p):
        p = p.full_tensor() if isinstance(p, DTensor) else p
        return p[:rows]                 # every row holds the same positions

    out = _attn_block(ql, kl, vl, local_pos(q_pos), local_pos(k_pos), rep_l,
                      scale, window, causal, softmax_dtype)
    return DTensor.from_local(out, mesh, want_q, run_check=False)


def _head_offset(mesh, placements, heads: int) -> int:
    """The first head of this rank's block of a dim of ``heads`` split
    evenly (``Shard(2)``) over the mesh dims in order."""
    from torch.distributed.tensor import Shard
    first, size = 0, heads
    for i, p in enumerate(placements):
        if p == Shard(2):
            size //= mesh.size(i)
            first += mesh.get_local_rank(i) * size
    return first


def _local_kv(kl, k0: int, h0: int, n: int, rep: int):
    """The KV heads that query heads ``h0 .. h0 + n - 1`` read (head h
    reads KV head h // rep), from this rank's block ``kl`` [B, S, kv, D]
    whose first head is ``k0``, and the group size they run at: a slice
    where the query heads make whole groups or share one KV head, else
    one KV head a query head."""
    lo, hi = h0 // rep, (h0 + n - 1) // rep
    assert 0 <= lo - k0 and hi - k0 < kl.shape[2], (h0, n, rep, k0)
    if (h0 % rep == 0 and n % rep == 0) or lo == hi:
        return kl[:, :, lo - k0:hi + 1 - k0], n // (hi + 1 - lo)
    idx = (h0 + torch.arange(n, device=kl.device)) // rep - k0
    return kl.index_select(2, idx), 1


def split_heads(y, b: int, s: int, n: int, head_dim: int):
    """``y`` [B, S, n * head_dim] as [B, S, n, head_dim].  On a DTensor
    whose last dim is split over mesh dims that ``n`` does not divide,
    those mesh dims are gathered first: DTensor refuses to unflatten a dim
    it cannot split evenly, where the reference's partitioner pads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(y, DTensor):
        mesh, last = y.device_mesh, y.dim() - 1
        on_last = [i for i, p in enumerate(y.placements)
                   if isinstance(p, Shard) and p.dim == last]
        ways = 1
        for i in on_last:
            ways *= mesh.size(i)
        if on_last and n % ways:
            y = y.redistribute(mesh, [Replicate() if i in on_last else p
                                      for i, p in enumerate(y.placements)])
    return y.reshape(b, s, n, head_dim)


class _MergeHeads(torch.autograd.Function):
    """[B, S, n, hd] -> [B, S, n * hd] on a DTensor, whose backward splits
    the gradient with ``split_heads`` (a plain view's backward would
    unflatten a dim that the next product left unevenly sharded)."""

    @staticmethod
    def forward(x):
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dims = tuple(inputs[0].shape)

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, *ctx.dims)


def merge_heads(x):
    """[B, S, n, hd] -> [B, S, n * hd] (``_MergeHeads`` on a DTensor)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return _MergeHeads.apply(x)
    return x.reshape(*x.shape[:-2], -1)


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
    q = split_heads(x @ p["wq"], b, s, n_heads, head_dim)
    if cross_kv is not None:
        ck, cv, k_pos = cross_kv
        out = attention(q, ck, cv, positions, k_pos, window=0, causal=False,
                        q_chunk=q_chunk, softmax_dtype=softmax_dtype)
        return merge_heads(out) @ p["wo"], None

    k = split_heads(x @ p["wk"], b, s, n_kv, head_dim)
    v = split_heads(x @ p["wv"], b, s, n_kv, head_dim)
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
        return merge_heads(out) @ p["wo"], cache
    out = attention(q, k, v, positions, positions, window=window,
                    causal=causal, q_chunk=q_chunk,
                    softmax_dtype=softmax_dtype)
    return merge_heads(out) @ p["wo"], None


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
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    # gold stays [B, S, 1] up to the sum: a DTensor gather over a
    # vocabulary-sharded dim cannot be indexed down before its reduction
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])
    valid = (labels >= 0).to(torch.float32)[..., None]
    return torch.sum(valid), torch.sum((logz - gold) * valid)
