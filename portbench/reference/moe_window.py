"""The plain reference of a mixture-of-experts language model whose layers
mix windowed and full attention (``mellum2-12b-a2.5b-1period-ep8``), as one
chip's expert-parallel share.

Plain PyTorch in float32, with TF32 off, written from the configuration
file.  Each layer of the period (``pattern``: ``la+moe`` attends within
``local_window``, ``attn+moe`` fully) is pre-norm, RMSNorm with scale
``1 + gamma``:

* attention: grouped-query, rotary positions (halves concatenated) at
  ``rope_theta``; a full layer's positions take YaRN (the published
  ``rope_type: yarn``): frequency ``f_i = theta^(-2i/d)`` becomes ``f_i /
  factor`` below index ``low``, ``f_i`` above ``high``, linear between,
  with ``low = floor(d ln(L / (2 pi beta_fast)) / (2 ln theta))``, ``high``
  the ceiling at ``beta_slow``, and cos and sin times the attention
  factor; a key is seen where ``k <= q`` and, in a windowed layer, ``q - k
  < window``.  The scores are computed a block of queries at a time over
  the keys that block can see, so that a long row fits;
* the expert layer: a router over all ``n_experts`` experts, softmax,
  the top ``top_k`` with their gates renormalised over the k chosen; of
  those, the assignments to this chip's experts (``expert_offset ..
  expert_offset + experts_held - 1``) are ranked within their expert in
  token order inside each group of ``moe_group`` tokens of a row (the
  token's k choices in order), and kept below the capacity
  ``max(int(moe_group k / n_experts capacity_factor), k)``; a kept
  assignment adds ``gate * W_down(silu(x W_gate) * (x W_up))``.  The other
  experts' part is left out, as a chip holding these experts computes it.

The loss is the mean next-token NLL over the labelled positions plus 0.01
times the load-balance loss summed over the layers, ``n_experts *
sum_e mean(p_e)^2`` with the mean over every token of the worker's rows.
A block of rows at a time: the means come first from a pass without
gradients, and a block's gradient takes the loss's derivative at them (the
gradient of a function of a sum is the sum of its blocks').

Parameters are ``groups/<j>/...`` (layer j of the period, a stack of one),
``embed``, ``unembed`` and ``final_norm``, in the program's flatten order.
A step's model FLOPs (``step_flops``) count the expert layer at the
expected assignments to this chip's experts (T k held / E), not at its
capacity's slots, and attention at the pairs each query sees.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from portbench.reference.model import (Numerics, Params, Spec, no_tf32,
                                       param_count, rms_norm, rows)

__all__ = ["Numerics", "no_tf32", "param_count", "rows", "param_spec",
           "mean_loss_grad", "step_flops"]

AUX = 0.01                  # the load-balance loss's coefficient
Q_BLOCK = 1024              # queries a block of attention scores


def _held(cfg: dict) -> int:
    return cfg.get("experts_held") or cfg["n_experts"]


def param_spec(cfg: dict) -> Spec:
    """Every parameter as (path, shape, initial std), in path order."""
    if cfg["family"] != "moe" or not cfg.get("pattern"):
        raise ValueError("the moe_window reference takes the moe family "
                         "with a pattern")
    d, v, ff, hd = cfg["d_model"], cfg["vocab"], cfg["d_ff"], cfg["head_dim"]
    hq, hk = cfg["n_heads"] * hd, cfg["n_kv"] * hd
    e, eh = cfg["n_experts"], _held(cfg)
    spec = [("embed", (v, d), 0.02), ("unembed", (d, v), 0.02),
            ("final_norm", (d,), 0.0)]
    for j in range(len(cfg["pattern"])):
        pre = f"groups/{j}"
        spec += [(f"{pre}/attn/wq", (1, d, hq), d ** -0.5),
                 (f"{pre}/attn/wk", (1, d, hk), d ** -0.5),
                 (f"{pre}/attn/wv", (1, d, hk), d ** -0.5),
                 (f"{pre}/attn/wo", (1, hq, d), hq ** -0.5),
                 (f"{pre}/ln1", (1, d), 0.0), (f"{pre}/ln2", (1, d), 0.0),
                 (f"{pre}/moe/router", (1, d, e), d ** -0.5),
                 (f"{pre}/moe/w_gate", (1, eh, d, ff), d ** -0.5),
                 (f"{pre}/moe/w_up", (1, eh, d, ff), d ** -0.5),
                 (f"{pre}/moe/w_down", (1, eh, ff, d), ff ** -0.5)]
    return sorted(spec, key=lambda s: s[0].split("/"))


def _check_groups(cfg: dict, seq: int) -> int:
    gs = cfg["moe_group"]
    if seq < gs or seq % gs:
        raise ValueError(f"the reference routes each row's groups of "
                         f"{gs} tokens: seq {seq} is no multiple of it")
    return gs


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _frequencies(cfg: dict, half: int, full: bool, device):
    """(inverse frequencies [half], the cos and sin scale)."""
    theta = float(cfg["rope_theta"])
    i = torch.arange(half, dtype=torch.float32, device=device)
    inv = 1.0 / theta ** (2.0 * i / (2 * half))
    factor = cfg.get("rope_yarn_factor") or 0.0
    if not full or not factor:
        return inv, 1.0
    d, orig = 2 * half, cfg["rope_yarn_original"]

    def corr(beta):
        return d * math.log(orig / (beta * 2 * math.pi)) / (2 * math.log(
            theta))
    low = max(math.floor(corr(cfg["rope_yarn_beta_fast"])), 0)
    high = min(math.ceil(corr(cfg["rope_yarn_beta_slow"])), d - 1)
    if low == high:
        high += 0.001
    extra = 1.0 - ((i - low) / (high - low)).clamp(0.0, 1.0)
    inv = (inv / factor) * (1.0 - extra) + inv * extra
    return inv, float(cfg["rope_yarn_attn_factor"])


def rope(x, inv, scale: float):
    """x [B, S, H, D] at positions 0..S-1."""
    s, half = x.shape[1], x.shape[-1] // 2
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = (torch.cos(ang) * scale)[:, None], (torch.sin(ang) * scale)[
        :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(num: Numerics, q, k, v, window: int):
    """q [B, S, H, D], k and v [B, S, KV, D], causal, within ``window``
    where it is above 0; a block of ``Q_BLOCK`` queries at a time against
    the keys it can see."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qh = q.reshape(b, s, kv, h // kv, d).permute(0, 2, 3, 1, 4)  # b kv r q d
    kh = k.permute(0, 2, 3, 1)[:, :, None]                      # b kv 1 d s
    vh = v.permute(0, 2, 1, 3)[:, :, None]                      # b kv 1 s d
    outs = []
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(s, q0 + Q_BLOCK)
        k0 = max(0, q0 - window + 1) if window else 0
        qp = torch.arange(q0, q1, device=q.device)[:, None]
        kp = torch.arange(k0, q1, device=q.device)[None, :]
        seen = kp <= qp
        if window:
            seen = seen & (qp - kp < window)
        scores = num.mm(qh[..., q0:q1, :], kh[..., k0:q1]) * d ** -0.5
        scores = scores.masked_fill(~seen, float("-inf"))
        outs.append(num.mm(torch.softmax(scores, dim=-1), vh[..., k0:q1, :]))
    out = torch.cat(outs, dim=3)                                 # b kv r q d
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h * d)


def attn_block(num: Numerics, cfg: dict, p: Params, x, window: int):
    b, s, _ = x.shape
    h, kv, hd = cfg["n_heads"], cfg["n_kv"], cfg["head_dim"]
    inv, scale = _frequencies(cfg, hd // 2, not window, x.device)
    q = rope(num.mm(x, p["wq"]).reshape(b, s, h, hd), inv, scale)
    k = rope(num.mm(x, p["wk"]).reshape(b, s, kv, hd), inv, scale)
    v = num.mm(x, p["wv"]).reshape(b, s, kv, hd)
    return num.mm(attention(num, q, k, v, window), p["wo"])


# ---------------------------------------------------------------------------
# the expert layer, this chip's share
# ---------------------------------------------------------------------------

def router_probs(num: Numerics, cfg: dict, p: Params, x):
    """The router's probabilities over every expert, [B, S, E]."""
    return torch.softmax(num.mm(x, p["router"]), dim=-1)


def experts(num: Numerics, cfg: dict, p: Params, x, probs):
    """What this chip's experts add to x [B, S, d], routed a group at a
    time."""
    b, s, d = x.shape
    k, e, eh = cfg["top_k"], cfg["n_experts"], _held(cfg)
    off = cfg.get("expert_offset", 0)
    gs = _check_groups(cfg, s)
    cap = max(int(gs * k / e * cfg["capacity_factor"]), k)
    xg = x.reshape(-1, gs, d)
    gate, idx = torch.topk(probs.reshape(-1, gs, e), k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(xg)
    for g in range(xg.shape[0]):
        choice = idx[g].reshape(-1) - off            # [gs * k], token order
        for j in range(eh):
            at = torch.nonzero(choice == j)[:cap, 0]      # the kept, in order
            if not at.numel():
                continue
            tok, slot = at // k, at % k
            xe = xg[g, tok]
            hid = torch.nn.functional.silu(num.mm(xe, p["w_gate"][j])) \
                * num.mm(xe, p["w_up"][j])
            y = num.mm(hid, p["w_down"][j]) * gate[g, tok, slot][:, None]
            out[g] = out[g].index_add(0, tok, y)
    return out.reshape(b, s, d)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _layer(p: Params, j: int) -> Params:
    pre = f"groups/{j}/"
    return {k[len(pre):]: t[0] for k, t in p.items() if k.startswith(pre)}


def _sub(p: Params, name: str) -> Params:
    pre = name + "/"
    return {k[len(pre):]: t for k, t in p.items() if k.startswith(pre)}


def _window(cfg: dict, kind: str) -> int:
    return cfg["local_window"] if kind.startswith("la") else 0


def hidden(num: Numerics, cfg: dict, p: Params, batch, on_probs=None):
    """The final normed hidden states [B, S, d]; ``on_probs(j, probs)``
    sees each layer's router probabilities."""
    eps = cfg["norm_eps"]
    x = p["embed"][batch["tokens"].long()]
    for j, kind in enumerate(cfg["pattern"]):
        lp = _layer(p, j)
        x = x + attn_block(num, cfg, _sub(lp, "attn"),
                           rms_norm(x, lp["ln1"], eps), _window(cfg, kind))
        xn = rms_norm(x, lp["ln2"], eps)
        probs = router_probs(num, cfg, _sub(lp, "moe"), xn)
        if on_probs is not None:
            on_probs(j, probs)
        x = x + experts(num, cfg, _sub(lp, "moe"), xn, probs)
    return rms_norm(x, p["final_norm"], eps)


def _nll_sum(num: Numerics, x, p: Params, tok):
    logits = num.mm(x[:, :-1], p["unembed"])
    gold = torch.gather(logits, -1, tok[:, 1:, None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def mean_loss_grad(num: Numerics, cfg: dict, p: Params, batch,
                   block: int) -> Tuple[float, List[torch.Tensor]]:
    """The loss over ``batch`` and its gradient (in ``param_spec``'s
    order, float32), the rows taken ``block`` at a time."""
    names = list(p)
    n, s = batch["tokens"].shape
    e, layers = cfg["n_experts"], len(cfg["pattern"])
    count, tokens = n * (s - 1), n * s
    # each layer's mean router probabilities over every token
    means = torch.zeros((layers, e), device=batch["tokens"].device)

    def add(j, probs):
        means[j] += probs.sum((0, 1))

    with torch.no_grad():
        for lo in range(0, n, block):
            hidden(num, cfg, p, rows(batch, lo, min(n, lo + block)), add)
    means /= tokens
    aux = float(e * (means * means).sum())
    leaves = [p[k].detach().requires_grad_(True) for k in names]
    pl = dict(zip(names, leaves))
    grads = [torch.zeros_like(t) for t in leaves]
    total = 0.0
    for lo in range(0, n, block):
        part = rows(batch, lo, min(n, lo + block))
        probs_sums = []
        x = hidden(num, cfg, pl, part,
                   lambda j, pr: probs_sums.append(pr.sum((0, 1))))
        nll = _nll_sum(num, x, pl, part["tokens"].long())
        # d(aux)/d(sum of a block's probs) at the whole batch's means
        lin = sum((2.0 * e / tokens) * (means[j] * ps).sum()
                  for j, ps in enumerate(probs_sums))
        # an expert that keeps no assignment in these rows is not used
        for g, d in zip(grads, torch.autograd.grad(
                nll / count + AUX * lin, leaves, allow_unused=True)):
            if d is not None:
                g += d
        total += float(nll.detach())
    return total / count + AUX * aux, grads


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------

def _pairs(seq: int, window: int) -> float:
    """The (query, key) pairs a causal row of ``seq`` sees, within
    ``window`` where it is above 0."""
    if not window or window >= seq:
        return seq * (seq + 1) / 2
    return window * (window + 1) / 2 + (seq - window) * window


def step_flops(cfg: dict, rows: int, seq: int, frames: int = 0) -> float:
    """A step's model FLOPs: 6 a weight a position it acts on (forward
    and backward), the experts at their expected assignments here (each
    token's k choices, held / E of them on this chip), and 12 H hd a
    (query, key) pair a layer sees."""
    d, ff, v = cfg["d_model"], cfg["d_ff"], cfg["vocab"]
    hq, hk = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv"] * cfg["head_dim"]
    e, k = cfg["n_experts"], cfg["top_k"]
    per_layer = (2 * d * hq + 2 * d * hk + d * e
                 + k * _held(cfg) / e * 3 * d * ff)
    kinds = cfg["pattern"]
    tokens = rows * seq
    linear = 6.0 * tokens * (len(kinds) * per_layer + d * v)
    pairs = rows * sum(_pairs(seq, _window(cfg, kind)) for kind in kinds)
    return linear + 12.0 * hq * pairs
