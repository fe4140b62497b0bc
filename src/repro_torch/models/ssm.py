"""Mamba-1 selective SSM block (falcon-mamba architecture; port of
``repro/models/ssm.py``).

Training and prefill run a chunked scan: a loop over sequence chunks that
carries the state, with a log-depth (Hillis-Steele) scan inside each chunk
(``linear_scan``), so the materialised state tensor is [B, chunk, d_inner,
d_state] per chunk.  The reference's ``lax.associative_scan`` combines in
another tree order, so the two agree to rounding, not bit for bit.  Decode
is the O(1) recurrent update.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, _init, rows_local, softplus


def d_inner(d_model, expand=2):
    return expand * d_model


def dt_rank(d_model):
    return -(-d_model // 16)


def init_mamba(gen, d_model, d_state=16, d_conv=4, expand=2,
               dtype=torch.float32, lead=()) -> Params:
    di, dr = d_inner(d_model, expand), dt_rank(d_model)
    lead = tuple(lead)
    u = torch.rand(lead + (di,), generator=gen, device=gen.device)
    lo, hi = math.log(0.001), math.log(0.1)
    a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                                   device=gen.device))
    return {
        "in_proj": _init(gen, (d_model, 2 * di), dtype=dtype, lead=lead),
        "conv_w": _init(gen, (d_conv, di), scale=0.5, dtype=dtype, lead=lead),
        "x_proj": _init(gen, (di, dr + 2 * d_state), dtype=dtype, lead=lead),
        "dt_proj": _init(gen, (dr, di), scale=dr ** -0.5, dtype=dtype,
                         lead=lead),
        "dt_bias": torch.log(torch.expm1(torch.exp(u * (hi - lo) + lo))),
        "A_log": a_log.expand(lead + (di, d_state)).clone(),
        "D": torch.ones(lead + (di,), device=gen.device),
        "out_proj": _init(gen, (di, d_model), dtype=dtype, lead=lead),
    }


def linear_scan(a: torch.Tensor, b: torch.Tensor):
    """The inclusive scan over axis 1 of the recurrence's combine
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``, in log2(L) doubling
    steps (Hillis-Steele).  Returns (prod a, h) with ``h_t = a_t h_{t-1} +
    b_t`` from h = 0."""
    off, n = 1, a.shape[1]
    while off < n:
        a_cur, b_cur = a[:, off:], b[:, off:]
        b = torch.cat([b[:, :off], a_cur * b[:, :-off] + b_cur], dim=1)
        a = torch.cat([a[:, :off], a_cur * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def chunked_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """All states ``h_t = a_t h_{t-1} + b_t`` from ``h0``: in chunks of
    ``chunk`` carrying the state when S is a multiple of it (and longer),
    else one scan.  a, b: [B, S, ...]; h0: [B, ...]."""
    s = a.shape[1]
    step = chunk if (s % chunk == 0 and s > chunk) else s
    h, outs = h0, []
    for i in range(0, s, step):
        aa, hh = linear_scan(a[:, i:i + step], b[:, i:i + step])
        hh = hh + aa * h[:, None]
        h = hh[:, -1]
        outs.append(hh)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def causal_conv(xi: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence, summed tap by tap as the
    reference's ``sum(...)`` does.  xi: [B, S, D]; conv_w: [K, D].  On
    DTensors each rank convolves its own rows (``rows_local``)."""
    return rows_local(_causal_conv, (xi,), (conv_w,))


def _causal_conv(xi: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    k, s = conv_w.shape[0], xi.shape[1]
    pad = F.pad(xi, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + s] * conv_w[i] for i in range(k))


def _ssm_coeffs(p: Params, xc, *, d_state):
    """xc: [..., S, di] (post-conv). Returns decay a=[...,S,di,N], drive bx."""
    dr = p["dt_proj"].shape[0]
    proj = xc @ p["x_proj"]                                   # [..., S, dr+2N]
    dt = softplus(proj[..., :dr] @ p["dt_proj"]
                  + p["dt_bias"].to(xc.dtype))                # [..., S, di]
    B = proj[..., dr:dr + d_state]                            # [..., S, N]
    C = proj[..., dr + d_state:]                              # [..., S, N]
    A = -torch.exp(p["A_log"]).to(torch.float32)              # [di, N]
    a = torch.exp(dt[..., None].to(torch.float32) * A)        # [..., S, di, N]
    bx = (dt * xc)[..., :, :, None] * B[..., :, None, :]      # [..., S, di, N]
    return a, bx.to(torch.float32), C


_SCAN_PARAMS = ("x_proj", "dt_proj", "dt_bias", "A_log")


def _scan(xc, *leaves, d_state: int, chunk: int):
    """The selective scan of the post-conv ``xc`` [B, S, di]: y [B, S,
    di] in xc's dtype."""
    p = dict(zip(_SCAN_PARAMS, leaves))
    a, bx, C = _ssm_coeffs(p, xc, d_state=d_state)
    h0 = torch.zeros((xc.shape[0], xc.shape[-1], d_state),
                     dtype=torch.float32, device=xc.device)
    h_all = chunked_scan(a, bx, h0, chunk)
    return torch.einsum("bsdn,bsn->bsd", h_all.to(xc.dtype), C)


def mamba_apply(p: Params, x, *, d_state=16, chunk=256,
                state: Optional[Params] = None):
    """x: [B, S, d_model]. Train/prefill when state is None (full sequence);
    decode when S == 1 and state = dict(conv=[B, d_conv-1, di], h=[B, di,
    N]), which is updated in place.

    Returns (y, state or None).
    """
    di = p["out_proj"].shape[0]
    xz = x @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    conv_w = p["conv_w"].to(x.dtype)                           # [K, di]

    if state is None:
        xc = F.silu(causal_conv(xi, conv_w))
        # on DTensors each rank scans its own rows (``rows_local``)
        y = rows_local(_scan, (xc,), tuple(p[k] for k in _SCAN_PARAMS),
                       d_state=d_state, chunk=chunk)
    else:
        # O(1) decode step
        window = torch.cat([state["conv"], xi], dim=1)         # [B, K, di]
        xc = F.silu(torch.einsum("bkd,kd->bd", window, conv_w))[:, None]
        a, bx, C = _ssm_coeffs(p, xc, d_state=d_state)
        h = a[:, 0] * state["h"] + bx[:, 0]                    # [B, di, N]
        y = torch.einsum("bdn,bn->bd", h.to(x.dtype), C[:, 0])[:, None]
        state["conv"].copy_(window[:, 1:])
        state["h"].copy_(h)

    y = y + xi * p["D"].to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"], state


def init_mamba_state(b, d_model, d_state=16, d_conv=4, expand=2,
                     dtype=torch.float32, lead=(), device=None) -> Params:
    di, lead = d_inner(d_model, expand), tuple(lead)
    return {"conv": torch.zeros(lead + (b, d_conv - 1, di), dtype=dtype,
                                device=device),
            "h": torch.zeros(lead + (b, di, d_state), dtype=torch.float32,
                             device=device)}
