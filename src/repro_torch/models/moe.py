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
``torch.func.vmap`` can batch it over workers.  The reference's sharding
anchors (``set_moe_sharding``, ``_anchor``) have no meaning on one card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, _init, activate


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

    e_flat = idx.reshape(g, tk)
    gate_flat = gate.reshape(g, tk)
    # rank within expert via exclusive cumsum of the expert one-hot
    onehot = (e_flat[..., None] == torch.arange(n_experts, device=dev)
              ).to(torch.int32)                                 # [G,TK,E]
    prior = torch.cumsum(onehot, dim=1) - onehot
    rank = torch.sum(onehot * prior, dim=-1)                    # [G,TK]
    keep = rank < capacity
    slot = torch.where(keep, e_flat * capacity + rank,
                       torch.full_like(e_flat, cap1 - 1))
    g_idx = torch.arange(g, device=dev)[:, None].expand(g, tk)

    # dispatch: x repeated K times, scattered to its slot (out of place)
    keepf = keep.to(xg.dtype)
    updates = xg[:, :, None, :].expand(g, t, top_k, d).reshape(g, tk, d)
    updates = updates * keepf[..., None]
    buf = torch.zeros((g, cap1, d), dtype=xg.dtype, device=dev).index_put(
        (g_idx, slot), updates)
    eb = buf[:, :-1].reshape(g, n_experts, capacity, d)

    if activation == "silu":
        h = F.silu(torch.einsum("gecd,edf->gecf", eb, p["w_gate"])) * \
            torch.einsum("gecd,edf->gecf", eb, p["w_up"])
    else:
        h = activate(torch.einsum("gecd,edf->gecf", eb, p["w_up"]),
                     activation)
    y = torch.einsum("gecf,efd->gecd", h, p["w_down"]).reshape(g, -1, d)
    y = torch.cat([y, torch.zeros((g, 1, d), dtype=y.dtype, device=dev)],
                  dim=1)                                        # [G,cap1,d]

    # combine: each slot's output, times its gate, added to its token (the
    # overflow slot's to a trash row); the gates are dispatched the same
    # way so their gradient reaches the router
    w_of_slot = torch.zeros((g, cap1), dtype=xg.dtype, device=dev).index_put(
        (g_idx, slot), gate_flat * keepf)
    tok_flat = (torch.arange(tk, device=dev) // top_k)[None].expand(g, tk)
    tok_of_slot = torch.full((g, cap1), t, dtype=torch.long,
                             device=dev).index_put(
        (g_idx, slot), torch.where(keep, tok_flat, t))
    rows = (torch.arange(g, device=dev)[:, None] * (t + 1)
            + tok_of_slot).reshape(-1)
    out = torch.zeros((g * (t + 1), d), dtype=y.dtype, device=dev).index_add(
        0, rows, (y * w_of_slot[..., None]).reshape(-1, d))
    return out.reshape(g, t + 1, d)[:, :t], probs


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
    out, probs = _route_grouped(p, xg, top_k=top_k, capacity=capacity,
                                activation=activation)
    out = out.reshape(b, s, d)
    # load-balance aux loss (Switch-style smooth proxy)
    me = torch.mean(probs, dim=(0, 1))
    aux = n_experts * torch.sum(me * me)
    return out, aux.to(torch.float32)
