"""Fused Artemis worker uplink: encode + memory update in one pass.

Replaces the Pallas kernel ``repro/kernels/fused_memory.py::
fused_memory_update`` with the hand-written CUDA kernel
``csrc/fused_memory.cu``.  Per (bm x bn) tile of g, h, u it computes

    delta  = g - h
    scale  = ||delta|| / s            (0 when the norm is not finite)
    q      = int8(sign(delta) * psi)  stochastic levels from the uniforms u
    h_new  = h + alpha * (q * scale)

and returns ``(q int8 [M, N], scales f32 [M/bm, N/bn], h_new [M, N])``.  The
Artemis round calls it with ``block=(1, d)``: one worker row per tile, so the
scale is that worker's L2 norm over s.  The compression API
(``ops.memory_update``) calls it on (256, 256) tiles.  g, h and u share one
dtype, float32 or bfloat16, and h_new comes back in it; in bfloat16 each
step of g - h and of the memory update is rounded to it, as the Pallas
kernel writes them (``ref.fused_memory_ref``), and the norm and levels are
float32.

Bound on an H100 SXM: bytes.  Per element it reads g, h, u (12 B in f32, 6 B
in bf16) and writes q and h_new (5 B, 3 B), plus one 4 B scale per tile, at
3.35 TB/s.  The kernel is ``csrc/tile_quant.cuh`` with a memory (the
encode of ``squant.py`` is the same kernel without one); it picks one of
three regimes from the tile's size, one launch each: tiles of at most 1024
elements (the round's rows) go to a group of 4 to 32 lanes with the norm
reduced by shuffles; larger tiles are split across a thread-block cluster
that sums the norm through distributed shared memory
(``csrc/tile_norm.cuh``), holding its share in registers ((256, 256)
tiles) or streaming it twice (rows of 2^20).  See the source.

``fused_memory_update`` launches the kernel for CUDA tensors (or raises) and
takes ``fused_memory_update_plain`` only for CPU tensors.
``fused_memory_update.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, ref

DEFAULT_BLOCK = (256, 256)
FLOATS = (torch.float32, torch.bfloat16)


def _check(g, h, u, s, block) -> Tuple[int, int]:
    if not 1 <= int(s) <= 126:
        raise ValueError(f"levels s={s} must fit int8: 1 <= s <= 126")
    if g.dim() != 2 or h.shape != g.shape or u.shape != g.shape:
        raise ValueError(f"g, h, u must share one 2-D shape: "
                         f"{tuple(g.shape)}, {tuple(h.shape)}, "
                         f"{tuple(u.shape)}")
    if g.dtype not in FLOATS or h.dtype != g.dtype or u.dtype != g.dtype:
        raise TypeError(f"g, h and u must share one dtype of {FLOATS}, got "
                        f"{g.dtype}, {h.dtype} and {u.dtype}")
    for name, t in (("h", h), ("u", u)):
        if t.device != g.device:
            raise ValueError(f"{name} is on {t.device}, g on {g.device}")
    bm, bn = (int(b) for b in block)
    m, n = g.shape
    if bm < 1 or bn < 1 or m % bm or n % bn:
        raise ValueError(f"block {block} does not tile shape {(m, n)}")
    return bm, bn


def fused_memory_update_plain(g: torch.Tensor, h: torch.Tensor,
                              u: torch.Tensor, alpha: float, *, s: int = 1,
                              block=DEFAULT_BLOCK):
    """The kernel's arithmetic in plain PyTorch, on any device
    (``ref.fused_memory_ref``)."""
    bm, bn = _check(g, h, u, s, block)
    return ref.fused_memory_ref(g, h, u, alpha, s, bm, bn)


def fused_memory_update(g: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
                        alpha: float, *, s: int = 1, block=DEFAULT_BLOCK):
    """g, h, u [M, N] in one dtype (f32 or bf16) -> (q int8 [M, N], scales
    f32 [M/bm, N/bn], h_new [M, N] in g's dtype)."""
    if g.device.type == "cpu":
        return fused_memory_update_plain(g, h, u, alpha, s=s, block=block)
    if g.device.type != "cuda":
        raise ValueError(f"fused_memory_update runs on cuda or cpu, not "
                         f"{g.device}")
    bm, bn = _check(g, h, u, s, block)
    for name, t in (("g", g), ("h", h), ("u", u)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, n = g.shape
    if (m // bm) * (n // bn) >= 2**31 or bm * bn >= 2**31:
        raise ValueError(f"{(m // bm) * (n // bn)} tiles of {bm * bn} "
                         f"elements exceed the kernel's 31-bit indices")
    q = torch.empty((m, n), dtype=torch.int8, device=g.device)
    scales = torch.empty((m // bm, n // bn), dtype=torch.float32,
                         device=g.device)
    h_new = torch.empty_like(g)
    lib = _build.load("fused_memory")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        code = lib.fused_memory_update(
            g.data_ptr(), h.data_ptr(), u.data_ptr(),
            int(g.dtype == torch.bfloat16), float(alpha), int(s),
            m, n, bm, bn, q.data_ptr(), scales.data_ptr(), h_new.data_ptr(),
            stream)
    _build.check("fused_memory", code)
    fused_memory_update.launches += 1
    return q, scales, h_new


fused_memory_update.launches = 0
