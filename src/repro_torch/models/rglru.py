"""RG-LRU recurrent block (RecurrentGemma / Griffin; port of
``repro/models/rglru.py``).

Recurrence (per channel):
    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Like the SSM block, training uses the chunked log-depth scan
(``ssm.chunked_scan``); decode is O(1).  The full "recurrent block" wraps
the RG-LRU with a short depthwise conv and a gated linear unit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import Params, _init, gelu, softplus
from repro_torch.models.ssm import causal_conv, chunked_scan

C_CONST = 8.0


def init_rglru(gen, d_model, lru_width, d_conv=4, dtype=torch.float32,
               lead=()) -> Params:
    lead = tuple(lead)
    u = torch.rand(lead + (lru_width,), generator=gen, device=gen.device)
    u = 0.9 + (0.999 - 0.9) * u
    return {
        "in_x": _init(gen, (d_model, lru_width), dtype=dtype, lead=lead),
        "in_gate": _init(gen, (d_model, lru_width), dtype=dtype, lead=lead),
        "conv_w": _init(gen, (d_conv, lru_width), scale=0.5, dtype=dtype,
                        lead=lead),
        "w_r": _init(gen, (lru_width, lru_width), dtype=dtype, lead=lead),
        "w_i": _init(gen, (lru_width, lru_width), dtype=dtype, lead=lead),
        # Lambda init so a^c in [0.9, 0.999] at r=1 (Griffin appendix)
        "lam": torch.log(torch.expm1(-torch.log(u) / C_CONST)),
        "out": _init(gen, (lru_width, d_model), dtype=dtype, lead=lead),
    }


def _gates(p: Params, xc):
    r = torch.sigmoid(xc @ p["w_r"])
    i = torch.sigmoid(xc @ p["w_i"])
    decay = softplus(p["lam"]).to(torch.float32)
    log_a = -C_CONST * decay * r.to(torch.float32)
    a = torch.exp(log_a)
    drive = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    bx = drive * (i * xc).to(torch.float32)
    return a, bx


def rglru_apply(p: Params, x, *, chunk=256, state: Optional[Params] = None):
    """x: [B, S, d_model]. Returns (y, state or None); state as in ssm.py,
    updated in place."""
    b, s, d = x.shape
    lw = p["out"].shape[0]
    xi = x @ p["in_x"]
    gate = gelu(x @ p["in_gate"])
    conv_w = p["conv_w"].to(x.dtype)

    if state is None:
        a, bx = _gates(p, causal_conv(xi, conv_w))
        h0 = torch.zeros((b, lw), dtype=torch.float32, device=x.device)
        y = chunked_scan(a, bx, h0, chunk).to(x.dtype)
    else:
        window = torch.cat([state["conv"], xi], dim=1)
        xc = torch.einsum("bkd,kd->bd", window, conv_w)[:, None]
        a, bx = _gates(p, xc)
        h = a[:, 0] * state["h"] + bx[:, 0]
        y = h.to(x.dtype)[:, None]
        state["conv"].copy_(window[:, 1:])
        state["h"].copy_(h)

    return (y * gate) @ p["out"], state


def init_rglru_state(b, lru_width, d_conv=4, dtype=torch.float32, lead=(),
                     device=None) -> Params:
    lead = tuple(lead)
    return {"conv": torch.zeros(lead + (b, d_conv - 1, lru_width),
                                dtype=dtype, device=device),
            "h": torch.zeros(lead + (b, lru_width), dtype=torch.float32,
                             device=device)}
