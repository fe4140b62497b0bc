"""Per-tile stochastic s-quantization: encode, decode and the fused apply.

Replaces the Pallas kernels of ``repro/kernels/squant.py`` with the
hand-written CUDA kernels of ``csrc/squant.cu``.  Arrays are 2-D ``[M, N]``
cut into (bm x bn) tiles (``DEFAULT_BLOCK`` = (256, 256)), with one f32
scale per tile:

- ``squant_encode(x, u)``: ``scale = ||tile|| / s`` (0 when not finite) and
  int8 levels ``sign(x) * (floor(r) + (u < r - floor(r)))`` with
  ``r = |x| / ||tile|| * s``; x and u are f32 or bf16, each on its own, and
  the math is in f32;
- ``squant_decode(q, scales)``: ``q * scale``, written as f32 or bf16;
- ``dequant_apply(w, q, scales, gamma)``: ``w - gamma * (q * scale)`` in
  w's dtype (f32 or bf16), gamma cast to it.

Bound on an H100 SXM: bytes, at 3.35 TB/s.  In f32, encode reads x and u and
writes q (9 B per element, plus 4 B per tile), decode reads q and writes the
values (5 B), dequant_apply reads w and q and writes w' (9 B).  The encode
is ``csrc/tile_quant.cuh`` without a memory, B1's design (lane groups for
small tiles, a thread-block cluster for a (256, 256) tile); decode and
dequant_apply take 16 levels a thread with 16-byte accesses.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain version, the oracle of ``kernels/ref.py``, only for CPU tensors; any
other device raises.  ``<wrapper>.launches`` counts kernel launches.  The
reference's ``interpret`` argument has no counterpart.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, ref

DEFAULT_BLOCK = (256, 256)
_FLOATS = (torch.float32, torch.bfloat16)


def _grid(shape, block) -> Tuple[int, int]:
    """(M / bm, N / bn); raises when the block does not tile the shape."""
    (m, n), (bm, bn) = tuple(shape), (int(b) for b in block)
    if bm < 1 or bn < 1 or m % bm or n % bn:
        raise ValueError(f"block {tuple(block)} does not tile shape "
                         f"{(m, n)}")
    return m // bm, n // bn


def _check_2d(name: str, t: torch.Tensor, dtypes) -> None:
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")


def _check_scales(q: torch.Tensor, scales: torch.Tensor, block) -> None:
    _check_2d("q", q, (torch.int8,))
    _check_2d("scales", scales, (torch.float32,))
    if tuple(scales.shape) != _grid(q.shape, block):
        raise ValueError(f"scales {tuple(scales.shape)} for q "
                         f"{tuple(q.shape)} in blocks {tuple(block)}")
    if scales.device != q.device:
        raise ValueError(f"scales on {scales.device}, q on {q.device}")


def _device(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return t.device.type == "cuda"


def _launch_ready(block, *tensors: torch.Tensor) -> Tuple[int, int]:
    """Check what the kernels need beyond the plain version's checks."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the squant kernels need contiguous tensors")
    bm, bn = (int(b) for b in block)
    m, n = tensors[0].shape
    gm, gn = _grid((m, n), block)
    if bm * bn >= 2**31 or gm * gn >= 2**31 or n >= 2**30:
        raise ValueError(f"shape {(m, n)} in blocks {(bm, bn)} exceeds the "
                         f"kernels' index range")
    return bm, bn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _check_encode(x, u, s, block) -> None:
    if not 1 <= int(s) <= 126:
        raise ValueError(f"levels s={s} must fit int8: 1 <= s <= 126")
    _check_2d("x", x, _FLOATS)
    _check_2d("u", u, _FLOATS)
    if u.shape != x.shape or u.device != x.device:
        raise ValueError(f"u {tuple(u.shape)} on {u.device} for x "
                         f"{tuple(x.shape)} on {x.device}")
    _grid(x.shape, block)


def squant_encode_plain(x: torch.Tensor, u: torch.Tensor, *, s: int = 1,
                        block=DEFAULT_BLOCK):
    """The kernel's arithmetic in plain PyTorch, on any device."""
    _check_encode(x, u, s, block)
    return ref.squant_encode_ref(x, u, int(s), *(int(b) for b in block))


def squant_encode(x: torch.Tensor, u: torch.Tensor, *, s: int = 1,
                  block=DEFAULT_BLOCK):
    """x, u [M, N] (block multiples; f32 or bf16) -> (q int8 [M, N],
    scales f32 [M/bm, N/bn])."""
    if not _device("squant_encode", x):
        return squant_encode_plain(x, u, s=s, block=block)
    _check_encode(x, u, s, block)
    bm, bn = _launch_ready(block, x, u)
    m, n = x.shape
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    scales = torch.empty(_grid((m, n), block), dtype=torch.float32,
                         device=x.device)
    lib = _build.load("squant")
    with torch.cuda.device(x.device):
        code = lib.squant_encode(
            x.data_ptr(), int(x.dtype == torch.bfloat16), u.data_ptr(),
            int(u.dtype == torch.bfloat16), int(s), m, n, bm, bn,
            q.data_ptr(), scales.data_ptr(), _stream(x))
    _build.check("squant", code)
    squant_encode.launches += 1
    return q, scales


squant_encode.launches = 0


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def squant_decode_plain(q: torch.Tensor, scales: torch.Tensor, *,
                        block=DEFAULT_BLOCK, dtype=torch.float32):
    """The kernel's arithmetic in plain PyTorch, on any device."""
    _check_scales(q, scales, block)
    if dtype not in _FLOATS:
        raise TypeError(f"decode writes float32 or bfloat16, not {dtype}")
    return ref.squant_decode_ref(q, scales, *(int(b) for b in block),
                                 dtype=dtype)


def squant_decode(q: torch.Tensor, scales: torch.Tensor, *,
                  block=DEFAULT_BLOCK, dtype=torch.float32) -> torch.Tensor:
    """q int8 [M, N], scales f32 [M/bm, N/bn] -> q * scale [M, N] in
    ``dtype`` (float32 or bfloat16)."""
    if not _device("squant_decode", q):
        return squant_decode_plain(q, scales, block=block, dtype=dtype)
    _check_scales(q, scales, block)
    if dtype not in _FLOATS:
        raise TypeError(f"decode writes float32 or bfloat16, not {dtype}")
    bm, bn = _launch_ready(block, q, scales)
    m, n = q.shape
    out = torch.empty((m, n), dtype=dtype, device=q.device)
    lib = _build.load("squant")
    with torch.cuda.device(q.device):
        code = lib.squant_decode(q.data_ptr(), scales.data_ptr(), m, n, bm,
                                 bn, out.data_ptr(),
                                 int(dtype == torch.bfloat16), _stream(q))
    _build.check("squant", code)
    squant_decode.launches += 1
    return out


squant_decode.launches = 0


# ---------------------------------------------------------------------------
# dequant_apply
# ---------------------------------------------------------------------------

def _check_apply(w, q, scales, block) -> None:
    _check_2d("w", w, _FLOATS)
    _check_scales(q, scales, block)
    if q.shape != w.shape or q.device != w.device:
        raise ValueError(f"q {tuple(q.shape)} on {q.device} for w "
                         f"{tuple(w.shape)} on {w.device}")


def dequant_apply_plain(w: torch.Tensor, q: torch.Tensor,
                        scales: torch.Tensor, gamma, *,
                        block=DEFAULT_BLOCK) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device."""
    _check_apply(w, q, scales, block)
    return ref.dequant_apply_ref(w, q, scales, gamma,
                                 *(int(b) for b in block))


def dequant_apply(w: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                  gamma, *, block=DEFAULT_BLOCK) -> torch.Tensor:
    """Fused optimizer apply: ``w - gamma * (q * scale)`` [M, N] in w's
    dtype (float32 or bfloat16), in a new tensor."""
    if not _device("dequant_apply", w):
        return dequant_apply_plain(w, q, scales, gamma, block=block)
    _check_apply(w, q, scales, block)
    bm, bn = _launch_ready(block, w, q, scales)
    m, n = w.shape
    out = torch.empty_like(w)
    lib = _build.load("squant")
    with torch.cuda.device(w.device):
        code = lib.dequant_apply(w.data_ptr(), int(w.dtype == torch.bfloat16),
                                 q.data_ptr(), scales.data_ptr(),
                                 float(gamma), m, n, bm, bn, out.data_ptr(),
                                 _stream(w))
    _build.check("squant", code)
    dequant_apply.launches += 1
    return out


dequant_apply.launches = 0
