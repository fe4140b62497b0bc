"""Mixture-of-Experts layer: top-k routing with capacity, gather dispatch
(port of ``repro/models/moe.py``).

Tokens are ranked within their expert by an exclusive cumsum of the expert
one-hot (no sort).  Each of the ``E * C`` capacity slots gathers its
token's row; the slots feed a grouped einsum against the stacked expert
weights, and their outputs, times the gates, are added back to their
tokens (an ``index_add``).  Dropped tokens (beyond capacity) pass through
the residual only: standard capacity-factor semantics.

The reference writes dispatch and combine as scatters with scatter-only
custom VJPs so that XLA's SPMD partitioner never meets a gather.  The port
gathers instead, through autograd: the function is the same, an empty
slot's output carries gate 0, and no two writes meet in one row (the
reference sends every dropped token to one overflow slot, which on the
card is a hot row of writes and gradients).  Dispatch stays out of place,
so ``torch.func.vmap`` can batch it over workers.

A layer may hold a share of the experts (``moe_apply``'s ``offset``, the
stacked expert weights fewer than the router's outputs): one chip's part
of an expert-parallel layer.  It routes over every expert as the whole
layer does, with the same capacity, and computes only what its own
experts add; the whole layer is the share of every expert.  The shares'
outputs, with the residual and the aux loss counted once, add up to the
whole layer's.  On one chip the layer runs without the exchange that
would bring the other experts' part.

While a profiler runs (``obs/spans.py``), the layer adds to the open
phase's record ``moe_routed`` (token-expert assignments to the experts it
holds, over the workers) and ``moe_dropped`` (of those, the ones beyond
capacity), as device tensors read when the log is.

The sharding anchors (``set_moe_sharding``, off by default) are the
reference's: on a DTensor, each anchor redistributes the intermediate to
its spec (groups over ``data``, experts over ``model`` for the grouped
einsum) with the entries whose axes do not divide the dim (or are not on
the tensor's mesh) dropped; a plain tensor passes through untouched.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, _init, activate, rows_local
from repro_torch.obs import spans

# optional sharding anchors (set by the launcher via set_moe_sharding)
_MOE_AXES = {"enabled": False, "data": "data", "model": "model"}


def set_moe_sharding(enabled: bool, data_axis="data", model_axis="model"):
    _MOE_AXES.update(enabled=enabled, data=data_axis, model=model_axis)


def _anchor(x, spec):
    """``x`` redistributed to ``spec`` when the anchors are on and ``x`` is a
    DTensor; an entry whose axes do not divide its dim is dropped."""
    from torch.distributed.tensor import DTensor
    if not _MOE_AXES["enabled"] or not isinstance(x, DTensor):
        return x
    from repro_torch.launch.mesh import _constrain
    mesh = x.device_mesh
    sizes = {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names or ())}

    def ok(entry, dim):
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for a in axes:
            n *= sizes.get(a, 0) or 10**9
        return dim % n == 0

    return _constrain(x, tuple(e if e is None or ok(e, x.shape[i]) else None
                               for i, e in enumerate(spec)))


def _D():
    return (_MOE_AXES["data"],)


def _M():
    return _MOE_AXES["model"]


def init_moe(gen, d_model, d_ff, n_experts, activation, dtype=torch.float32,
             lead=(), held: int = 0) -> Params:
    """The router over ``n_experts`` and the stacked weights of ``held`` of
    them (0: all)."""
    # the experts' scale is the whole layer's (the reference's quirk:
    # 1/sqrt of the stack's first dim), whatever the share held
    kw = dict(scale=n_experts ** -0.5, dtype=dtype, lead=lead)
    e = held or n_experts
    p = {
        "router": _init(gen, (d_model, n_experts), scale=0.02,
                        dtype=torch.float32, lead=lead),
        "w_up": _init(gen, (e, d_model, d_ff), **kw),
        "w_down": _init(gen, (e, d_ff, d_model), **kw),
    }
    if activation == "silu":
        p["w_gate"] = _init(gen, (e, d_model, d_ff), **kw)
    return p


class _PermuteCopy(torch.autograd.Function):
    """``x.permute(dims)`` copied to a contiguous block, its gradient
    likewise: a DTensor's local block need not be laid out as its global
    strides say, and a view of a permuted DTensor (or of its gradient) then
    fails."""

    @staticmethod
    def forward(x, dims):
        return x.permute(dims).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.inverse = tuple(sorted(range(len(inputs[1])),
                                   key=inputs[1].__getitem__))

    @staticmethod
    def backward(ctx, g):
        return g.permute(ctx.inverse).clone(
            memory_format=torch.contiguous_format), None


def _expert_mm(x, w):
    """``einsum("gecd,edf->gecf", x, w)``.  On a DTensor, as the one
    batched product that einsum runs (the same bits) with the permutations
    copied (``_PermuteCopy``): DTensor's einsum views a strided local block
    and fails when the experts are sharded and G > 1."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return torch.einsum("gecd,edf->gecf", x, w)
    g, e, c, d = x.shape
    xe = _PermuteCopy.apply(x, (1, 0, 2, 3)).reshape(e, g * c, d)
    return _PermuteCopy.apply(torch.bmm(xe, w).reshape(e, g, c, -1),
                              (1, 0, 2, 3))


def _route(p: Params, xg, *, top_k: int, capacity: int, activation: str,
           offset: int):
    """xg: [G, T, d], on a layer that holds experts ``offset .. offset +
    E_held - 1`` of the router's E (all of them where E_held == E) ->
    ([G, T, d], router probs [G, T, E], the assignments to held experts
    [G, T * K], those kept).

    The router, its top-k and the gates (renormalised over all k chosen)
    are the whole layer's.  A token's assignment to a held expert is ranked
    within that expert in token order and kept below ``capacity``.  Each of
    the held experts' ``E_held * C`` slots gathers its token's row, and its
    output, times its gate, is added back to that token.  An assignment
    not kept writes its token and gate to a spare slot of its own past
    those (so no two writes meet), and an empty slot keeps a row spread
    over the group and gate 0 (so no row takes every empty slot's zero
    output and gradient)."""
    g, t, d = xg.shape
    held = p["w_up"].shape[0]
    tk = t * top_k
    n_slots = held * capacity

    logits = xg.to(torch.float32) @ p["router"].to(torch.float32)  # [G,T,E]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, top_k, dim=-1)               # [G,T,K]
    gate = (gate / torch.sum(gate, -1, keepdim=True)).to(xg.dtype)

    local = _anchor(idx.reshape(g, tk) - offset, (_D(), None))  # [G,TK]
    mine = (local >= 0) & (local < held)
    slot = _anchor(rows_local(_slots, (local, mine), held=held,
                              capacity=capacity), (_D(), None))
    keep = slot < n_slots
    tok_of_slot = rows_local(_tokens, (slot,), n_slots=n_slots, t=t,
                             top_k=top_k)                       # [G,E_h*C]
    eb = rows_local(_gather, (xg, tok_of_slot)).reshape(g, held, capacity, d)
    eb = _anchor(eb, (_D(), _M(), None, None))                 # experts
    y = _anchor(_experts(p, eb, activation), (_D(), None, None))
    out = rows_local(_combine, (y, gate.reshape(g, tk), slot, tok_of_slot),
                     t=t)
    return _anchor(out, (_D(), None, None)), probs, mine, keep


def _experts(p: Params, eb, activation: str):
    """The experts over their slots [G, E, C, d]: [G, E * C, d]."""
    g, d = eb.shape[0], eb.shape[-1]
    if activation == "silu":
        h = F.silu(_expert_mm(eb, p["w_gate"])) * _expert_mm(eb, p["w_up"])
    else:
        h = activate(_expert_mm(eb, p["w_up"]), activation)
    return _expert_mm(h, p["w_down"]).reshape(g, -1, d)


def _slots(local, mine, *, held: int, capacity: int):
    """Each assignment's slot [G, TK]: ``expert * capacity + rank`` where
    kept, else ``held * capacity`` plus its own index.  The rank within
    expert is an exclusive cumsum of the expert one-hot, laid out [G, E_h,
    TK] so that the scan runs along the contiguous dim."""
    tk, dev = local.shape[1], local.device
    onehot = (local[:, None, :] == torch.arange(held, device=dev)[:, None]
              ).to(torch.int32)                                 # [G,Eh,TK]
    prior = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - onehot
    rank = torch.sum(onehot * prior, dim=1)
    keep = mine & (rank < capacity)
    return torch.where(keep, local * capacity + rank,
                       held * capacity + torch.arange(tk, device=dev))


def _tokens(slot, *, n_slots: int, t: int, top_k: int):
    """The token of each of a group's ``n_slots`` slots [G, n_slots]; an
    empty slot's spread over the group's rows."""
    g, tk = slot.shape
    dev = slot.device
    g_idx = torch.arange(g, device=dev)[:, None].expand(g, tk)
    spread = torch.arange(n_slots + tk, device=dev) % t
    a = torch.arange(tk, device=dev)
    return spread.repeat(g, 1).index_put((g_idx, slot), a // top_k)[
        :, :n_slots]


def _gather(xg, tok_of_slot):
    """Each slot's token row [G, n_slots, d] (a group's own, on a rank's
    block of groups)."""
    g_idx = torch.arange(xg.shape[0], device=xg.device)[:, None]
    return xg[g_idx, tok_of_slot]


def _combine(y, gate_flat, slot, tok_of_slot, *, t: int):
    """Each slot's output [G, n_slots, d], times its gate (0 for an empty
    slot), added to its token: [G, T, d].  The gates are placed by slot,
    so their gradient reaches the router."""
    g, n_slots, d = y.shape
    tk, dev = slot.shape[1], y.device
    g_idx = torch.arange(g, device=dev)[:, None]
    w_of_slot = torch.zeros((g, n_slots + tk), dtype=gate_flat.dtype,
                            device=dev).index_put(
        (g_idx.expand(g, tk), slot), gate_flat)[:, :n_slots]
    out = torch.zeros((g * t, d), dtype=y.dtype, device=dev).index_add(
        0, (g_idx * t + tok_of_slot).reshape(-1),
        (y * w_of_slot[..., None]).reshape(-1, d))
    return out.reshape(g, t, d)


def moe_apply(p: Params, x, *, top_k: int, capacity_factor: float = 1.25,
              activation: str = "silu", group_size: int = 4096,
              offset: int = 0):
    """x: [B, S, d]. Routes per group of <= group_size tokens (per row when
    S >= group_size, else over the flattened batch).  Where ``p`` stacks
    fewer experts than its router has outputs, they are experts ``offset
    ..`` of the router's; the capacity is the whole layer's either way.

    Returns (out, aux_loss) where aux_loss is the load-balance loss.
    """
    b, s, d = x.shape
    n_experts = p["router"].shape[1]

    if s >= group_size and s % group_size == 0:
        xg = x.reshape(b * (s // group_size), group_size, d)
    else:
        xg = x.reshape(1, b * s, d)
    tokens_per_group = xg.shape[1]
    capacity = max(int(tokens_per_group * top_k / n_experts * capacity_factor),
                   top_k)
    xg = _anchor(xg, (_D(), None, None))
    out, probs, mine, keep = _route(
        p, xg, top_k=top_k, capacity=capacity, activation=activation,
        offset=offset)
    if spans.counting():
        mine, keep = spans.plain(mine), spans.plain(keep)
        spans.count(moe_routed=mine.sum(), moe_dropped=(mine & ~keep).sum())
    out = out.reshape(b, s, d)
    # load-balance aux loss (Switch-style smooth proxy)
    me = torch.mean(probs, dim=(0, 1))
    aux = n_experts * torch.sum(me * me)
    return out, aux.to(torch.float32)
