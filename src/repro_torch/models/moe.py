"""Mixture-of-Experts layer: top-k routing with capacity, scatter dispatch
(port of ``repro/models/moe.py``).

Tokens are ranked within their expert by an exclusive cumsum of the expert
one-hot (no sort), scattered into an ``[E * C + 1, d]`` buffer (the last
row is the overflow slot of the dropped tokens) that feeds a grouped einsum
against the stacked expert weights, and combined back by a scatter-add.
Dropped tokens (beyond capacity) pass through the residual only: standard
capacity-factor semantics.

The reference writes both scatters with scatter-only custom VJPs so that
XLA's SPMD partitioner never meets a gather; their gradients equal plain
autograd through ``index_put`` and ``index_add``, because the overflow
slot's expert output is a constant zero and dropped tokens carry
``keep = 0``.  So the port uses autograd.  Dispatch stays out of place, so
``torch.func.vmap`` can batch it over workers.

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
             lead=()) -> Params:
    p = {
        "router": _init(gen, (d_model, n_experts), scale=0.02,
                        dtype=torch.float32, lead=lead),
        "w_up": _init(gen, (n_experts, d_model, d_ff), dtype=dtype,
                      lead=lead),
        "w_down": _init(gen, (n_experts, d_ff, d_model), dtype=dtype,
                        lead=lead),
    }
    if activation == "silu":
        p["w_gate"] = _init(gen, (n_experts, d_model, d_ff), dtype=dtype,
                            lead=lead)
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


def _route_grouped(p: Params, xg, *, top_k: int, capacity: int,
                   activation: str):
    """xg: [G, T, d] -> ([G, T, d], router probs [G, T, E])."""
    g, t, d = xg.shape
    n_experts = p["router"].shape[1]
    tk = t * top_k
    cap1 = n_experts * capacity + 1          # +1 overflow slot
    dev = xg.device

    logits = xg.to(torch.float32) @ p["router"].to(torch.float32)  # [G,T,E]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, top_k, dim=-1)               # [G,T,K]
    gate = (gate / torch.sum(gate, -1, keepdim=True)).to(xg.dtype)

    e_flat = _anchor(idx.reshape(g, tk), (_D(), None))         # [G,TK]
    gate_flat = gate.reshape(g, tk)
    # rank within expert via exclusive cumsum of the expert one-hot
    onehot = (e_flat[..., None] == torch.arange(n_experts, device=dev)
              ).to(torch.int32)                                 # [G,TK,E]
    prior = torch.cumsum(onehot, dim=1) - onehot
    rank = torch.sum(onehot * prior, dim=-1)                    # [G,TK]
    keep = rank < capacity
    slot = _anchor(torch.where(keep, e_flat * capacity + rank,
                               torch.full_like(e_flat, cap1 - 1)),
                   (_D(), None))

    # dispatch: x repeated K times, scattered to its slot (out of place)
    keepf = keep.to(xg.dtype)
    updates = xg[:, :, None, :].expand(g, t, top_k, d).reshape(g, tk, d)
    updates = updates * keepf[..., None]
    buf = rows_local(_dispatch, (updates, slot), cap1=cap1)
    eb = buf[:, :-1].reshape(g, n_experts, capacity, d)
    eb = _anchor(eb, (_D(), _M(), None, None))                 # experts

    if activation == "silu":
        h = F.silu(_expert_mm(eb, p["w_gate"])) * _expert_mm(eb, p["w_up"])
    else:
        h = activate(_expert_mm(eb, p["w_up"]), activation)
    y = _expert_mm(h, p["w_down"]).reshape(g, -1, d)
    y = _anchor(torch.cat([y, torch.zeros((g, 1, d), dtype=y.dtype,
                                          device=dev)], dim=1),
                (_D(), None, None))                             # [G,cap1,d]
    out = rows_local(_combine, (y, gate_flat, keep, slot), t=t, top_k=top_k)
    return _anchor(out, (_D(), None, None)), probs


def _dispatch(updates, slot, *, cap1: int):
    """Each group's rows [G, TK, d] scattered to their slots: [G, cap1,
    d] (a group's own, on a rank's block of groups)."""
    g, tk, d = updates.shape
    g_idx = torch.arange(g, device=updates.device)[:, None].expand(g, tk)
    return torch.zeros((g, cap1, d), dtype=updates.dtype,
                       device=updates.device).index_put((g_idx, slot),
                                                        updates)


def _combine(y, gate_flat, keep, slot, *, t: int, top_k: int):
    """Each slot's output [G, cap1, d], times its gate, added to its token
    (the overflow slot's to a trash row): [G, T, d].  The gates are
    dispatched the same way, so their gradient reaches the router."""
    g, cap1, d = y.shape
    tk, dev = slot.shape[1], y.device
    g_idx = torch.arange(g, device=dev)[:, None].expand(g, tk)
    w_of_slot = torch.zeros((g, cap1), dtype=gate_flat.dtype,
                            device=dev).index_put(
        (g_idx, slot), gate_flat * keep.to(gate_flat.dtype))
    tok_flat = (torch.arange(tk, device=dev) // top_k)[None].expand(g, tk)
    tok_of_slot = torch.full((g, cap1), t, dtype=torch.long,
                             device=dev).index_put(
        (g_idx, slot), torch.where(keep, tok_flat, t))
    rows = (torch.arange(g, device=dev)[:, None] * (t + 1)
            + tok_of_slot).reshape(-1)
    out = torch.zeros((g * (t + 1), d), dtype=y.dtype, device=dev).index_add(
        0, rows, (y * w_of_slot[..., None]).reshape(-1, d))
    return out.reshape(g, t + 1, d)[:, :t]


def moe_apply(p: Params, x, *, top_k: int, capacity_factor: float = 1.25,
              activation: str = "silu", group_size: int = 4096):
    """x: [B, S, d]. Routes per group of <= group_size tokens (per row when
    S >= group_size, else over the flattened batch).

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
    out, probs = _route_grouped(p, xg, top_k=top_k, capacity=capacity,
                                activation=activation)
    out = out.reshape(b, s, d)
    # load-balance aux loss (Switch-style smooth proxy)
    me = torch.mean(probs, dim=(0, 1))
    aux = n_experts * torch.sum(me * me)
    return out, aux.to(torch.float32)
