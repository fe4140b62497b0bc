"""Shared neural-net layers: norms, RoPE, chunked attention, MLPs (port of
``repro/models/layers.py``).

Everything is functional on tensors: ``init_*(gen, ...) -> {name: tensor}``
draws from an explicit ``torch.Generator`` on its device, and
``*_apply(p, x, ...)`` takes the layer's flat params dict.  Attention is
q-chunked (a loop over query blocks against the full K/V with masking), as
the reference's scan is, so a long prefill never materialises an S x S
score matrix; on the card, without a cache, it takes the fused kernel
(``kernels/attention.py``), which writes no scores at all.  Every ``init_*`` takes ``lead``, the leading stack shape of
the reference's stacked ``[L, ...]`` leaves, and draws the whole stack at
once.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import attention as FA
from repro_torch.obs import spans

Params = Dict[str, torch.Tensor]


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
    # theta rounded to f32 on the host and passed as the power's scalar
    # base: the same bits as a 0-d device tensor, whose creation is a
    # blocking host-to-device copy (it held the host to the card's pace at
    # every call)
    base = float(torch.tensor(theta, dtype=torch.float32))
    freq = torch.pow(base, expo)
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


def fused_route(q, k, v, *, lanes=None, softmax_dtype=torch.float32,
                fusable: bool = False) -> bool:
    """``attention`` takes the hand-written kernel
    (``kernels/attention.py::flash_attention``): q, k and v are bf16 CUDA
    tensors, not DTensors, no lane group splits the head dim, the softmax
    is in f32, the head dim is 64 or 128, and the caller vouches that every
    query row keeps a key (``fusable``: no cache).  Everything else (the
    CPU, decode's ring cache, the sharded heads) runs ``_attn_block``."""
    from torch.distributed.tensor import DTensor
    return (fusable and lanes is None and softmax_dtype == torch.float32
            and q.shape[-1] in FA.CONFIGS
            and all(t.device.type == "cuda" and t.dtype == torch.bfloat16
                    and not isinstance(t, DTensor) for t in (q, k, v)))


def attention(q, k, v, q_pos, k_pos, *, window: int = 0, q_chunk: int = 512,
              causal: bool = True, softmax_dtype=torch.float32, lanes=None,
              fusable: bool = False):
    """q: [B, Sq, H, D]; k, v: [B, Sk, KV, D]; grouped-query attention.

    Loops over query chunks of ``q_chunk`` when Sq is a multiple of it (and
    longer); each chunk attends to the full K/V with a position mask.
    ``lanes``: the process group over which D is split (each rank holds its
    own lanes of q, k and v): the score products are summed over it and
    the output gathered, so the result holds every lane; the scale is the
    whole head dim's.  On ``fused_route`` (``fusable``: the caller passed
    no cache) the fused kernel takes the whole query length at once: the
    chunks existed only to bound the scores' memory, which it never
    writes.
    """
    b, sq, h, d = q.shape
    kv = k.shape[2]
    assert h % kv == 0
    rep = h // kv
    scale = (d * (1 if lanes is None else lanes.size())) ** -0.5
    if fused_route(q, k, v, lanes=lanes, softmax_dtype=softmax_dtype,
                   fusable=fusable):
        spans.count(attn_fused=1)
        return FA.flash_attention(q, k, v, q_pos, k_pos, scale=scale,
                                  window=window, causal=causal)
    if q_pos.dim() == 1:
        q_pos = q_pos.expand(b, sq)
    if k_pos.dim() == 1:
        k_pos = k_pos.expand(b, k_pos.shape[0])
    if sq <= q_chunk or sq % q_chunk != 0:
        return _attn_block(q, k, v, q_pos, k_pos, rep, scale, window, causal,
                           softmax_dtype, lanes)
    outs = [_attn_block(q[:, i:i + q_chunk], k, v, q_pos[:, i:i + q_chunk],
                        k_pos, rep, scale, window, causal, softmax_dtype,
                        lanes)
            for i in range(0, sq, q_chunk)]
    return torch.cat(outs, dim=1)


def _attn_block(q, k, v, q_pos, k_pos, rep, scale, window, causal,
                softmax_dtype, lanes=None):
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, rep, d)
    # grouped attention without materialising repeated K/V
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg, k)
    if lanes is not None:       # summed at the wider of the two dtypes
        scores = _GroupSum.apply(scores.to(torch.promote_types(
            scores.dtype, softmax_dtype)), lanes)
    scores = scores.to(softmax_dtype) * scale
    mask = FA.mask(q_pos, k_pos, window, causal)
    scores = torch.where(mask[:, None, None], scores,
                         torch.finfo(softmax_dtype).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v)
    if lanes is not None:
        out = _GroupGather.apply(out, lanes)
    return out.reshape(b, sq, h, out.shape[-1])


# ---------------------------------------------------------------------------
# Attention on the model axis: each rank on its part of the heads
# ---------------------------------------------------------------------------

def head_partition(ways: int, n_heads: int, n_kv: int, head_dim: int,
                   k_split: bool):
    """``(split, lanes)``: over a model axis of ``ways`` ranks that splits
    the query projection's output, the query heads go ``split`` ways in
    blocks of ``n_heads // split`` and each block's head dim ``lanes`` ways
    (the rest of the axis holds copies).  This is the partition XLA gives
    the reference's ``attn_apply`` (read from its compiled HLO, pinned by
    ``tests/test_torch_heads.py``):

      * ``split`` is the largest factor of ``ways`` that divides the query
        heads such that a block is whole KV groups or lies within one
        (``split`` divides ``n_kv``, or ``n_kv`` divides it and the quotient
        divides the group size ``n_heads // n_kv``);
      * the rest of the axis, ``ways // split`` ranks, splits the head dim
        where a block is one query head, or one KV head whose projection
        the axis splits as well (``k_split``); it holds copies otherwise.

    starcoder2-7b's (36, 4, 128) over 16: 9 heads a rank and 32 lanes;
    recurrentgemma-2b's (10, 1, 256): 5 heads on 8 copies; whisper-tiny's
    (6, 6, 64): 3 heads on 8 copies."""
    rep = n_heads // n_kv
    split = max(f for f in range(1, ways + 1)
                if ways % f == 0 and n_heads % f == 0
                and (n_kv % f == 0 or (f % n_kv == 0
                                       and rep % (f // n_kv) == 0)))
    rest = ways // split
    if rest > 1 and head_dim % rest == 0 and (
            n_heads == split or (n_kv == split and k_split)):
        return split, rest
    return split, 1


_BLOCKS: Optional[list] = None


@contextlib.contextmanager
def recording_blocks():
    """Within it, each sharded attention appends to the yielded list the
    block this rank runs: (query heads, KV heads, head-dim lanes)."""
    global _BLOCKS
    saved, _BLOCKS = _BLOCKS, []
    try:
        yield _BLOCKS
    finally:
        _BLOCKS = saved


class _GroupSum(torch.autograd.Function):
    """The sum over a process group; its gradient is the sum of the
    ranks' gradients (each rank's result feeds its own lanes)."""

    @staticmethod
    def forward(x, group):
        return _c10d("all_reduce", x, "sum", group=group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _c10d("all_reduce", g, "sum", group=ctx.group), None


class _GroupGather(torch.autograd.Function):
    """The ranks' blocks concatenated on the last dim, in group order; the
    gradient of a rank's block is the sum of the ranks' gradients of it."""

    @staticmethod
    def forward(x, group):
        return _c10d("all_gather_into_tensor", x.movedim(-1, 0),
                     group.size(), group=group).movedim(0, -1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _c10d("reduce_scatter_tensor", g.movedim(-1, 0), "sum",
                     ctx.group.size(), group=ctx.group).movedim(0, -1), None


def _c10d(op: str, x: torch.Tensor, *args, group):
    """A functional collective over ``group``, waited for: the ops that
    DTensor issues, which the dry run counts."""
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(getattr(c10d, op)(x.contiguous(), *args,
                                              group.group_name))


def _run_group(mesh, dim: int, size: int):
    """This rank's run of ``size`` consecutive ranks of its row of mesh dim
    ``dim`` (the runs tile the row): the ranks that share its block of
    heads, or whose blocks of a projection hold its heads.  Made once a
    mesh, by its members alone (every member asks at the same point of the
    step), and kept on the mesh."""
    import torch.distributed as dist
    held = mesh.__dict__.setdefault("_attn_run_groups", {})
    if (dim, size) not in held:
        row = dist.get_process_group_ranks(mesh.get_group(dim))
        at = mesh.get_local_rank(dim)
        assert row[at] == dist.get_rank(), (row, at)
        first = at - at % size
        held[(dim, size)] = dist.new_group(row[first:first + size],
                                           use_local_synchronization=True)
    return held[(dim, size)]


def _split_dim(w) -> Optional[int]:
    """The mesh dim that splits a projection weight's output dim, if any
    (``None`` for a plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(w, DTensor):
        return None
    dims = [i for i, p in enumerate(w.placements)
            if isinstance(p, Shard) and p.dim == w.dim() - 1]
    if len(dims) > 1:
        raise ValueError(f"a projection's output split over several mesh "
                         f"dims: {w.placements}")
    return dims[0] if dims else None


def _sharded_attention(q, k, v, q_pos, k_pos, *, n_heads, n_kv, head_dim,
                       dim, k_split, rope_theta=0.0, rope_k=True, **kw):
    """``attention`` on DTensors, each rank on its block of the partition
    of ``head_partition``.  ``q`` is the query projection [B, Sq, H * hd]
    before RoPE; ``k`` and ``v`` are projections [B, Sk, KV * hd] or a
    cache [B, Sk, KV, hd] (``rope_k``: RoPE k here, else it has it).  The
    model axis is mesh dim ``dim``, the one that splits wq's output
    (``None``: no axis does, every rank runs every head); ``k_split``: it
    splits wk's too.  (Which mesh dim splits q itself is DTensor's choice:
    with the residual stream's features split, its product comes out
    partial there.)

    A rank takes its query heads and the KV heads they read, of its batch
    rows (the batch stays split where q, k and v split it alike), each
    rank's gradient of them its own share: a projection split on the
    model axis (or partial there) is reduced to its blocks and the blocks
    that hold the rank's heads gathered over their run of ranks
    (``_run_group``, ``_GroupGather``), so that the shares come back
    reduce-scattered onto the blocks; one whole there, or a cache, is
    gathered and read with a ``Partial`` gradient.  The rank RoPEs its
    heads and, where the head dim is split, takes its lanes: the score
    products are then summed over its lane group (its run of
    ``ways // split``) and the output gathered over it
    (``attention(lanes=)``).  The output is the rank's block of columns of
    the merged [B, Sq, H * hd], which lies within its heads, placed as
    ``Shard(2)`` on the model axis: ``wo``'s rows are split the same way,
    so nothing is gathered for the product."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    k, v = (t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False) for t in (k, v))
    want = [pq if pq == Shard(0) and pq == pk == pv else Replicate()
            for pq, pk, pv in zip(q.placements, k.placements, v.placements)]
    if dim is not None and want[dim] != Replicate():
        dim = None              # the rows are split there: every head
    ways = mesh.size(dim) if dim is not None else 1
    split, lanes = head_partition(ways, n_heads, n_kv, head_dim, k_split)
    rest = ways // split
    grad = [Partial() if i == dim and ways > 1 else w
            for i, w in enumerate(want)]

    keep = [mesh.size(i) == 1 for i in range(mesh.ndim)]
    group, lane = divmod(mesh.get_local_rank(dim), rest) if ways > 1 \
        else (0, 0)
    hs = n_heads // split
    kvs = n_kv // split if n_kv % split == 0 else 1
    k0 = group * kvs if n_kv % split == 0 else group // (split // n_kv)

    def local(t, n, h0, hn):
        """Heads ``h0 .. h0 + hn - 1`` of the ``n`` of ``t`` on this rank,
        [rows, S, hn, hd]."""
        pl = [p if kp else w for p, w, kp in zip(t.placements, want, keep)]
        gp = [p if kp else g for p, g, kp in zip(t.placements, grad, keep)]
        run = hn * ways // n          # the ranks whose blocks hold them
        blocks = ways > 1 and t.dim() == 3 and (
            t.placements[dim].is_partial() or t.placements[dim] == Shard(2)
        ) and (n * head_dim) % ways == 0 and (hn * ways) % n == 0 and (
            h0 * ways) % n == 0
        if blocks:              # a partial gradient here would have every
            pl[dim] = Shard(2)  # rank run all of the projection's backward
        if tuple(pl) != tuple(t.placements):
            t = t.redistribute(mesh, pl)
        if not blocks:
            t = t.to_local(grad_placements=gp)
            return t.reshape(*t.shape[:2], n, head_dim)[:, :, h0:h0 + hn]
        t = t.to_local()
        if run > 1:
            t = _GroupGather.apply(t, _run_group(mesh, dim, run))
        return t.reshape(*t.shape[:2], hn, head_dim)

    ql = local(q, n_heads, group * hs, hs)
    kl, vl = (local(t, n_kv, k0, kvs) for t in (k, v))
    rows, sq = ql.shape[:2]

    def local_pos(p):
        p = p.full_tensor() if isinstance(p, DTensor) else p
        return p[:rows] if p.dim() == 2 else p   # every row holds the same

    q_pos, k_pos = local_pos(q_pos), local_pos(k_pos)
    if rope_theta:
        ql = rope(ql, q_pos, rope_theta)
        if rope_k:
            kl = rope(kl, k_pos, rope_theta)
    lane_group = None
    if lanes > 1:
        c = head_dim // lanes
        ql, kl, vl = (t[..., lane * c:(lane + 1) * c] for t in (ql, kl, vl))
        lane_group = _run_group(mesh, dim, rest)
    if _BLOCKS is not None:     # the block that runs, from its tensors
        _BLOCKS.append((ql.shape[2], kl.shape[2], ql.shape[-1]))
    out = attention(ql, kl, vl, q_pos, k_pos, lanes=lane_group, **kw)
    width = n_heads * head_dim // ways
    y = out.reshape(rows, sq, hs * head_dim)[..., lane * width:
                                             (lane + 1) * width]
    place = list(want)
    if dim is not None:
        place[dim] = Shard(2)
    return DTensor.from_local(y, mesh, place, run_check=False)


def split_heads(y, b: int, s: int, n: int, head_dim: int):
    """``y`` [B, S, n * head_dim] as [B, S, n, head_dim].  On a DTensor
    whose last dim is split over mesh dims that ``n`` does not divide,
    those mesh dims are gathered first: DTensor refuses to unflatten a dim
    it cannot split evenly (a decode step's new K/V, on their way into the
    cache)."""
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
        "pos": torch.full(lead + (cache_len,), FA.INVALID_POS,
                          dtype=torch.int32, device=device),
    }


def attn_apply(p: Params, x, positions, *, n_heads, n_kv, head_dim, window=0,
               causal=True, rope_theta=10000.0, q_chunk=512,
               softmax_dtype=torch.float32, cache: Optional[Params] = None,
               pos: Optional[int] = None, cross_kv=None,
               decode: bool = False):
    """Self- or cross-attention.  Returns (y, cache).

    cache: optional ring-buffer cache (decode), updated in place: the new
    k/v go to slot ``pos % cache_len`` and attention runs against the whole
    cache using the absolute positions stored per slot.
    cross_kv: optional precomputed (k, v, k_pos) for encoder-decoder
    cross-attention, k and v [B, F, n_kv * head_dim].
    decode: the caller's step holds a cache (a cross-attention has none of
    its own): the eager ``_attn_block`` then, as for a self-attention with
    a cache; without one ``attention`` may take the fused kernel.
    On DTensors each rank runs its block of the heads
    (``_sharded_attention``).
    """
    from torch.distributed.tensor import DTensor
    b, s, _ = x.shape
    q = x @ p["wq"]
    kw = dict(q_chunk=q_chunk, softmax_dtype=softmax_dtype)
    sharded = isinstance(q, DTensor)
    if sharded:
        dim = _split_dim(p["wq"])
        kw.update(n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, dim=dim,
                  k_split=dim is not None and _split_dim(p["wk"]) == dim)
    if cross_kv is not None:
        ck, cv, k_pos = cross_kv
        if sharded:
            out = _sharded_attention(q, ck, cv, positions, k_pos, window=0,
                                     causal=False, **kw)
            return out @ p["wo"], None
        f = ck.shape[1]
        out = attention(q.reshape(b, s, n_heads, head_dim),
                        ck.reshape(b, f, n_kv, head_dim),
                        cv.reshape(b, f, n_kv, head_dim), positions, k_pos,
                        window=0, causal=False, fusable=not decode, **kw)
        return out.reshape(b, s, -1) @ p["wo"], None

    k, v = x @ p["wk"], x @ p["wv"]
    if cache is not None:
        k = split_heads(k, b, s, n_kv, head_dim)
        v = split_heads(v, b, s, n_kv, head_dim)
        if rope_theta:
            k = rope(k, positions, rope_theta)
        slot = pos % cache["k"].shape[1]
        cache["k"][:, slot:slot + s] = k.to(cache["k"].dtype)
        cache["v"][:, slot:slot + s] = v.to(cache["v"].dtype)
        cache["pos"][slot] = pos
        k, v, k_pos = (cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                       cache["pos"])
    else:
        k_pos = positions
    if sharded:
        out = _sharded_attention(q, k, v, positions, k_pos, window=window,
                                 causal=cache is not None or causal,
                                 rope_theta=rope_theta,
                                 rope_k=cache is None, **kw)
        return out @ p["wo"], cache
    q = q.reshape(b, s, n_heads, head_dim)
    if cache is None:
        k = k.reshape(b, s, n_kv, head_dim)
        v = v.reshape(b, s, n_kv, head_dim)
        if rope_theta:
            k = rope(k, positions, rope_theta)
    if rope_theta:
        q = rope(q, positions, rope_theta)
    out = attention(q, k, v, positions, k_pos, window=window,
                    causal=cache is not None or causal,
                    fusable=cache is None, **kw)
    return out.reshape(b, s, -1) @ p["wo"], cache


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
