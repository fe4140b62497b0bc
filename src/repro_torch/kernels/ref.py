"""Plain PyTorch oracles for the per-tile squant kernels (port of
``repro/kernels/ref.py``).

Every function takes 2-D tensors already padded to block multiples, with one
scale per (bm x bn) tile: the layout the kernels produce, so a test can ask
for exact agreement given the same uniforms ``u``.  The names and arguments
are the reference's.  These are the kernels' plain versions: the wrappers of
``kernels/squant.py`` call them for CPU tensors, and ``chip_smoke.py`` holds
the CUDA kernels against them on the card.

One deliberate difference from the reference: ``squant_encode_ref`` clamps a
non-finite tile norm to a zero scale, as the Pallas kernels
(``repro/kernels/squant.py:35``) and the codecs do, where the reference's
``ref.py`` ships the NaN.  The port is held to the kernels.
"""
from __future__ import annotations

import torch


def _blockify(x: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """[M, N] -> [M // bm, N // bn, bm, bn] (a view)."""
    m, n = x.shape
    if bm < 1 or bn < 1 or m % bm or n % bn:
        raise ValueError(f"block {(bm, bn)} does not tile shape {(m, n)}")
    return x.reshape(m // bm, bm, n // bn, bn).transpose(1, 2)


def _unblockify(b: torch.Tensor) -> torch.Tensor:
    gm, gn, bm, bn = b.shape
    return b.transpose(1, 2).reshape(gm * bm, gn * bn)


def squant_encode_ref(x: torch.Tensor, u: torch.Tensor, s: int, bm: int,
                      bn: int):
    """Per-tile stochastic s-quantization, the math in f32 whatever the
    dtypes of x and u.  Returns (q int8 [M, N], scales f32 [M/bm, N/bn])
    with ``decode(q, scales) = q * scale`` per tile and scale = ||tile|| / s
    (0 when the norm is not finite; the level is 0 where r is NaN and
    saturated to the int8 range where r overflows it)."""
    xb = _blockify(x, bm, bn).to(torch.float32)
    ub = _blockify(u, bm, bn).to(torch.float32)
    norms = torch.sqrt(torch.sum(xb * xb, dim=(-2, -1), keepdim=True))
    scales = torch.where(torch.isfinite(norms), norms / s,
                         torch.zeros_like(norms))
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    r = xb.abs() / safe * s
    low = torch.floor(r)
    psi = low + (ub < (r - low)).to(torch.float32)
    qf = torch.sign(xb) * psi
    # int8 as XLA converts: NaN to 0, out of range saturated (only a tile
    # with a NaN norm, where safe is 1, can leave [-(s+1), s+1])
    q = torch.where(torch.isnan(qf), torch.zeros_like(qf),
                    qf.clamp(-128.0, 127.0))
    return _unblockify(q.to(torch.int8)), scales[..., 0, 0]


def squant_decode_ref(q: torch.Tensor, scales: torch.Tensor, bm: int,
                      bn: int, dtype=torch.float32) -> torch.Tensor:
    """``q * scale`` per tile in ``dtype`` (both cast to it first)."""
    qb = _blockify(q, bm, bn).to(dtype)
    return _unblockify(qb * scales[..., None, None].to(dtype))


def fused_memory_ref(g: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
                     alpha: float, s: int, bm: int, bn: int):
    """delta = g - h; (q, scales) = encode(delta); h' = h + alpha * deq(q).
    Returns (q, scales f32, h_new in g's dtype): the fused kernel's
    arithmetic, as the Pallas kernel writes it.  g - h is rounded to g's
    dtype, the norm and levels are in f32, and the memory update rounds
    alpha (f32, then g's dtype), the scale, q * scale, alpha * (...) and
    h + ... each to g's dtype in turn (exact in f32 but for alpha's f32
    rounding)."""
    q, scales = squant_encode_ref(g - h, u, s, bm, bn)
    a = torch.as_tensor(alpha, dtype=torch.float32, device=g.device)
    h_new = h + a.to(g.dtype) * squant_decode_ref(q, scales, bm, bn,
                                                  dtype=g.dtype)
    return q, scales, h_new


def dequant_apply_ref(w: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                      gamma: float, bm: int, bn: int) -> torch.Tensor:
    """w' = w - gamma * deq(q, scales), in w's dtype: gamma is rounded to f32
    and then to w's dtype, and each operation rounds to w's dtype, as the
    Pallas kernel's ``gamma.astype(w.dtype)`` arithmetic does."""
    g = torch.as_tensor(gamma, dtype=torch.float32, device=w.device)
    return w - g.to(w.dtype) * squant_decode_ref(q, scales, bm, bn,
                                                 dtype=w.dtype)
