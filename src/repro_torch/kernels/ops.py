"""Public shape-agnostic compression API over the squant kernels (port of
``repro/kernels/ops.py``).

Arrays of any shape, or whole gradient trees, go in; the int8 wire
(``Compressed``: levels and one f32 scale per tile) comes out.  Each array
is flattened and zero-padded to ``[M, bn]`` with M a multiple of bm
(``_pack``), the reference's layout: a 7-element vector ships one whole
256 x 256 tile.  The kernels are ``squant_encode``, ``squant_decode`` and
``dequant_apply`` (``kernels/squant.py``) and ``fused_memory_update``
(``kernels/fused_memory.py``); each launches on the card for CUDA tensors
and takes its plain version for CPU tensors.

Randomness enters as in the rest of the port: each call takes the uniforms
``u`` over the packed shape, or a ``torch.Generator`` to draw them from (in
the input's dtype, as the reference draws them); it never reads a global
RNG.  The tree helpers take one generator and draw leaf by leaf in flatten
order, or a list of per-leaf ``u``.  Trees are nested dicts of tensors,
flattened in JAX's order, dict keys sorted: a flat dict keyed
``"layer_00/w"`` flattens like the reference's nested
``{"layer_00": {"w": ...}}``.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import fused_memory as _fm
from repro_torch.kernels import squant as _sq

DEFAULT_BLOCK = _sq.DEFAULT_BLOCK


def _pack(x: torch.Tensor, block) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Flatten and zero-pad to an [M, bn] layout with M a multiple of bm."""
    bm, bn = block
    flat = x.reshape(-1)
    n = flat.numel()
    rows = -(-n // bn)                      # ceil
    rows = -(-rows // bm) * bm              # round rows up to bm
    padded = torch.zeros(rows * bn, dtype=x.dtype, device=x.device)
    padded[:n] = flat
    return padded.view(rows, bn), tuple(x.shape)


def _unpack(x2d: torch.Tensor, shape) -> torch.Tensor:
    return x2d.reshape(-1)[:math.prod(shape)].reshape(shape)


class Compressed(NamedTuple):
    """Wire format: int8 levels and f32 per-tile scales."""
    q: torch.Tensor           # int8 [M, N]
    scales: torch.Tensor      # f32 [M // bm, N // bn]

    @property
    def wire_bytes(self) -> int:
        return self.q.numel() + 4 * self.scales.numel()


def _uniforms(x2d: torch.Tensor, u: Optional[torch.Tensor],
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """The uniforms over the packed shape: ``u`` as given, or drawn from
    ``generator`` in x's dtype."""
    if u is not None:
        if tuple(u.shape) != tuple(x2d.shape):
            raise ValueError(f"uniforms of shape {tuple(u.shape)} for a "
                             f"packed shape {tuple(x2d.shape)}")
        return u
    if generator is None:
        raise ValueError("encoding needs uniforms u or a generator")
    return torch.rand(x2d.shape, generator=generator, device=x2d.device,
                      dtype=x2d.dtype)


def encode(x: torch.Tensor, u: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None, *, s: int = 1,
           block=DEFAULT_BLOCK) -> Tuple[Compressed, Tuple[int, ...]]:
    """Compress ``x`` (any shape, f32 or bf16): the wire and x's shape."""
    x2d, shape = _pack(x, block)
    q, scales = _sq.squant_encode(x2d, _uniforms(x2d, u, generator), s=s,
                                  block=block)
    return Compressed(q, scales), shape


def decode(c: Compressed, shape, *, block=DEFAULT_BLOCK,
           dtype=torch.float32) -> torch.Tensor:
    out = _sq.squant_decode(c.q, c.scales, block=block, dtype=dtype)
    return _unpack(out, shape)


def compress(x: torch.Tensor, u: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None, *, s: int = 1,
             block=DEFAULT_BLOCK) -> torch.Tensor:
    """Round trip encode then decode: an unbiased compressor (Assumption 5
    with omega = sqrt(bm * bn) / s)."""
    c, shape = encode(x, u, generator, s=s, block=block)
    return decode(c, shape, block=block, dtype=x.dtype)


def memory_update(g: torch.Tensor, h: torch.Tensor, alpha,
                  u: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None, *,
                  s: int = 1, block=DEFAULT_BLOCK):
    """The fused Artemis worker step on a gradient of any shape (f32 or
    bf16; h in g's dtype, the uniforms drawn in it).

    Returns (delta_hat decoded to g's shape and dtype, h_new in g's dtype,
    the wire)."""
    g2d, shape = _pack(g, block)
    h2d, _ = _pack(h, block)
    q, scales, h_new2d = _fm.fused_memory_update(
        g2d, h2d, _uniforms(g2d, u, generator), alpha, s=s, block=block)
    c = Compressed(q, scales)
    delta_hat = decode(c, shape, block=block, dtype=g.dtype)
    return delta_hat, _unpack(h_new2d, shape), c


def apply_update(w: torch.Tensor, c: Compressed, gamma, shape=None, *,
                 block=DEFAULT_BLOCK) -> torch.Tensor:
    """The fused apply ``w - gamma * decode(c)``, in w's dtype."""
    shape = tuple(w.shape) if shape is None else shape
    w2d, _ = _pack(w, block)
    out = _sq.dequant_apply(w2d, c.q, c.scales, gamma, block=block)
    return _unpack(out, shape)


# ---------------------------------------------------------------------------
# Trees of tensors (gradient trees)
# ---------------------------------------------------------------------------

def tree_flatten(tree) -> Tuple[List[torch.Tensor], Callable]:
    """The leaves of a tree of nested dicts in JAX's flatten order (keys
    sorted at every level) and a function that rebuilds a tree of the same
    structure from a list of leaves in that order."""
    if not isinstance(tree, dict):
        return [tree], lambda leaves: leaves[0]
    keys = sorted(tree)
    subs = [tree_flatten(tree[k]) for k in keys]
    sizes = [len(leaves) for leaves, _ in subs]

    def unflatten(leaves):
        out, i = {}, 0
        for k, (_, sub), n in zip(keys, subs, sizes):
            out[k] = sub(leaves[i:i + n])
            i += n
        return out

    return [x for leaves, _ in subs for x in leaves], unflatten


def _per_leaf(u: Optional[Sequence[torch.Tensor]], n: int) -> list:
    if u is None:
        return [None] * n
    if len(u) != n:
        raise ValueError(f"{len(u)} uniforms for {n} leaves")
    return list(u)


def tree_compress(tree, u: Optional[Sequence[torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None, *, s: int = 1,
                  block=DEFAULT_BLOCK):
    """``compress`` leaf by leaf, with independent uniforms per leaf."""
    leaves, unflatten = tree_flatten(tree)
    return unflatten([compress(x, ui, generator, s=s, block=block)
                      for x, ui in zip(leaves, _per_leaf(u, len(leaves)))])


def tree_memory_update(grads, h, alpha,
                       u: Optional[Sequence[torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None, *,
                       s: int = 1, block=DEFAULT_BLOCK):
    """``memory_update`` over a gradient tree and its memory tree of the
    same structure.  Returns (delta_hat tree, h_new tree)."""
    gl, unflatten = tree_flatten(grads)
    hl, _ = tree_flatten(h)
    if len(hl) != len(gl):
        raise ValueError(f"memory tree has {len(hl)} leaves, gradient tree "
                         f"{len(gl)}")
    dh, hn = [], []
    for g, hh, ui in zip(gl, hl, _per_leaf(u, len(gl))):
        d, h2, _ = memory_update(g, hh, alpha, ui, generator, s=s,
                                 block=block)
        dh.append(d)
        hn.append(h2)
    return unflatten(dh), unflatten(hn)
