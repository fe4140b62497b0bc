"""Two-sided wire codecs (port of ``repro/core/codec.py``).

A ``Codec`` pairs ``encode(x, u) -> WirePayload`` with ``decode(payload) ->
x_hat``.  The registry holds every codec of the reference: ``identity``,
``squant`` (global-norm s-quantization, paper Definition 1), ``tile_squant``
(one scale per tile of the message), ``row_squant`` (the fused kernels' wire
format), ``sparsify`` (keep each coordinate with probability q, an index and
value payload) and ``topk`` (the k largest magnitudes, biased).

Batching: the LAST axis of ``x`` is one message; leading axes are independent
messages.  This is what ``jax.vmap`` over the JAX codec gives, written out.

Randomness: the uniforms enter as a tensor ``u`` of ``x``'s shape, or are
drawn from a passed ``torch.Generator``.  Given the same ``u`` the levels
agree with the JAX codec up to the order of the norm's reduction: bit for
bit on the CPU for messages (tile_squant: tiles) of at most 32 elements.
sparsify keeps coordinate i where ``u[i] < q`` (the reference's Bernoulli
draw is that comparison); topk draws nothing.  tile_squant takes ``u`` of
``x``'s shape too: the reference draws over the zero-padded tiles, and a
padded coordinate quantizes to 0 whatever its uniform.

The norm's order (``sum_squares``).  On the CPU, for messages of at most 32
elements, the port repeats the reference's order bit for bit: XLA's CPU
reduce of ``jnp.linalg.norm`` (squant) adds the squares left to right, each
a fused multiply-add, and the separate square and sum of ``row_squant``
add them left to right with a rounding each; both take a correctly rounded
square root.  Beyond 32 elements XLA vectorises the reduce in an order not
matched here (ROADMAP.md C2), and the port takes torch's sum.  On the card
a norm is one reduction kernel in torch's order (one launch, not one per
element).

Both scale conventions of the reference are kept: ``squant`` ships the
undivided norm and decodes ``(q * norm) / s``; ``row_squant`` ships
``norm / s`` (0 for a non-finite norm) and decodes ``q * scale``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

FP_BITS = 32  # uncompressed scalar width used by the paper's bit accounting


@dataclasses.dataclass(frozen=True)
class PayloadMeta:
    """Which codec produced a payload, the shape and dtype to restore on
    decode, and the codec's static parameters."""
    codec: str
    shape: Tuple[int, ...]
    dtype: str
    params: Tuple[Tuple[str, Any], ...] = ()


@dataclasses.dataclass
class WirePayload:
    """A named bundle of wire tensors plus static metadata.  ``leaves()``
    lists the tensors in sorted-key order, the order the reference's pytree
    flattening gives (its fault streams key off it)."""
    data: Dict[str, torch.Tensor]
    meta: PayloadMeta

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.data[name]

    def replace(self, **updates) -> "WirePayload":
        return WirePayload({**self.data, **updates}, self.meta)

    def keys(self) -> Tuple[str, ...]:
        return tuple(sorted(self.data))

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return tuple(self.data[k] for k in self.keys())


@dataclasses.dataclass(frozen=True)
class Codec:
    """A two-sided compression operator with known variance factor omega.

    ``encode(x, u=None, generator=None)``; ``bits(n)`` is the paper's
    Elias-coded size of one n-element message; ``wire_bytes(shape)`` the
    physical payload by dtype; ``validate(payload)`` 1.0 per valid message.
    """
    name: str
    omega: float
    encode: Callable
    decode: Callable
    bits: Callable
    wire_bytes: Callable
    validate: Callable
    unbiased: bool = True
    fused_uplink: Optional[str] = None  # kernel family of the fused uplink
    fused_acc: bool = False

    def __call__(self, x: torch.Tensor, u: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Round-trip compress: decode(encode(x, u))."""
        return self.decode(self.encode(x, u, generator))


def _nelems(shape) -> int:
    return math.prod(int(d) for d in shape)


def _uniforms(x: torch.Tensor, u: Optional[torch.Tensor],
              generator: Optional[torch.Generator]) -> torch.Tensor:
    if u is not None:
        if tuple(u.shape) != tuple(x.shape):
            raise ValueError(f"uniforms of shape {tuple(u.shape)} for a "
                             f"message of shape {tuple(x.shape)}")
        return u.to(torch.float32)
    if generator is None:
        raise ValueError("a stochastic codec needs uniforms u or a generator")
    return torch.rand(x.shape, generator=generator, device=x.device)


SEQUENTIAL_NORM_MAX = 32   # longest message whose norm order is matched


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for float32 tensors with one rounding to float32, as a
    fused multiply-add rounds it.  In float64 the product is exact and the
    sum is rounded once; where that rounding lands on a float32 tie while the
    exact sum does not (double rounding), the float64 sum is moved one step
    toward the exact sum first, so the result is the FMA's in every case."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)            # s + err == p + c exactly
    tie = (s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    s = torch.where(tie & (err != 0), torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (torch's vectorised CPU sqrt
    can be one ulp off; XLA's and the card's are not)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def sum_squares(x: torch.Tensor, fused: bool) -> torch.Tensor:
    """Sum of squares over the last axis, in the reference's order on the
    CPU where it is known (module docstring): left to right from 0.0, each
    step an FMA when ``fused`` (a square fused into XLA's reduce, as in
    ``jnp.linalg.norm``) or a multiply then an add (a square computed on
    its own, then ``jnp.sum``).  Elsewhere torch's sum, one reduction."""
    if x.device.type != "cpu" or x.shape[-1] > SEQUENTIAL_NORM_MAX:
        return torch.sum(x * x, dim=-1)
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32)
    for i in range(x.shape[-1]):
        v = x[..., i]
        acc = fma32(v, v, acc) if fused else acc + v * v
    return acc


def l2_norm(x: torch.Tensor, fused: bool = True) -> torch.Tensor:
    """L2 norm over the last axis (``sum_squares``, then a correctly rounded
    square root on the CPU)."""
    ss = sum_squares(x, fused)
    return sqrt32(ss) if x.device.type == "cpu" else torch.sqrt(ss)


def _levels_ok(q: torch.Tensor, s: int) -> torch.Tensor:
    return (q.to(torch.int32).abs() <= s + 1).all(-1)


def _finite_nonneg(x: torch.Tensor) -> torch.Tensor:
    return (torch.isfinite(x) & (x >= 0)).all(-1)


# ---------------------------------------------------------------------------
# identity (omega = 0)
# ---------------------------------------------------------------------------

def _identity_codec(d: int, **_) -> Codec:
    def encode(x, u=None, generator=None):
        meta = PayloadMeta("identity", tuple(x.shape), str(x.dtype))
        return WirePayload({"values": x}, meta)

    def decode(p):
        return p["values"]

    def validate(p):
        return torch.isfinite(p["values"]).all(-1).to(torch.float32)

    return Codec(
        name="identity", omega=0.0, encode=encode, decode=decode,
        bits=lambda n: FP_BITS * n,
        wire_bytes=lambda shape: {"f32": 4 * _nelems(shape)},
        validate=validate)


# ---------------------------------------------------------------------------
# s-quantization (paper Definition 1 / QSGD): one norm per message
# ---------------------------------------------------------------------------

def squant_omega(d: int, s: int) -> float:
    """omega_C = min(d/s^2, sqrt(d)/s)  (Alistarh et al., App. A.1)."""
    return min(d / s**2, math.sqrt(d) / s)


def squant_bits(n: int, s: int) -> float:
    """Elias-coded message size upper bound (Prop. S1)."""
    t = s * (s + math.sqrt(n))
    return (3.0 + 1.5 * math.log(2.0 * (s**2 + n) / t)) * t + FP_BITS


def _check_levels(name: str, s) -> int:
    s = int(s)
    if not 1 <= s <= 126:
        raise ValueError(f"{name} levels s={s} must fit int8: 1 <= s <= 126")
    return s


def _squant_codec(d: int, s: int = 1, **_) -> Codec:
    s = _check_levels("squant", s)

    def encode(x, u=None, generator=None):
        u = _uniforms(x, u, generator)
        norm = l2_norm(x)[..., None]     # jnp.linalg.norm
        r = torch.where(norm > 0, x.abs() / norm * s, torch.zeros_like(x))
        low = torch.floor(r)
        psi = low + (u < (r - low)).to(x.dtype)
        q = (torch.sign(x) * psi).to(torch.int8)
        meta = PayloadMeta("squant", tuple(x.shape), str(x.dtype),
                           (("s", s),))
        # the scale is the UNdivided norm: decode does (q * norm) / s
        return WirePayload({"levels": q, "scales": norm}, meta)

    def decode(p):
        return p["levels"].to(p["scales"].dtype) * p["scales"] / s

    def validate(p):
        return (_levels_ok(p["levels"], s)
                & _finite_nonneg(p["scales"])).to(torch.float32)

    return Codec(
        name=f"squant(s={s})", omega=squant_omega(d, s),
        encode=encode, decode=decode,
        bits=lambda n, s=s: squant_bits(n, s),
        wire_bytes=lambda shape: {"s8": _nelems(shape),
                                  "f32": 4 * _nelems(shape[:-1])},
        validate=validate, fused_uplink="squant_rows")


# ---------------------------------------------------------------------------
# per-tile s-quantization: one norm per ``tile`` coordinates of a message
# ---------------------------------------------------------------------------

def _tile_squant_codec(d: int, s: int = 1, tile: int = 1024, **_) -> Codec:
    s, tile = _check_levels("tile_squant", s), int(tile)
    if tile < 1:
        raise ValueError(f"tile_squant tile={tile} must be positive")

    def encode(x, u=None, generator=None):
        u = _uniforms(x, u, generator)
        n = x.shape[-1]
        pad = (-n) % tile
        tiles = F.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, tile)
        # a padded coordinate has r = 0, so its level is 0 for any uniform
        ut = F.pad(u, (0, pad)).reshape(tiles.shape)
        norms = l2_norm(tiles)[..., None]        # jnp.linalg.norm per tile
        r = torch.where(norms > 0, tiles.abs() / norms * s,
                        torch.zeros_like(tiles))
        low = torch.floor(r)
        psi = low + (ut < (r - low)).to(tiles.dtype)
        q = (torch.sign(tiles) * psi).to(torch.int8)
        meta = PayloadMeta("tile_squant", tuple(x.shape), str(x.dtype),
                           (("s", s), ("tile", tile)))
        return WirePayload({"levels": q, "scales": norms}, meta)

    def decode(p):
        out = p["levels"].to(p["scales"].dtype) * p["scales"] / s
        n = p.meta.shape[-1]
        return out.reshape(*out.shape[:-2], -1)[..., :n]

    def validate(p):
        return (_levels_ok(p["levels"], s).all(-1)
                & _finite_nonneg(p["scales"]).all(-1)).to(torch.float32)

    def wire_bytes(shape):
        rows, n = _nelems(shape[:-1]), int(shape[-1])
        t = -(-n // tile)
        return {"s8": rows * t * tile, "f32": 4 * rows * t}

    return Codec(
        name=f"tile_squant(s={s},t={tile})", omega=squant_omega(tile, s),
        encode=encode, decode=decode,
        bits=lambda n, s=s, tile=tile: math.ceil(n / tile)
        * squant_bits(min(n, tile), s),
        wire_bytes=wire_bytes, validate=validate)


# ---------------------------------------------------------------------------
# row s-quantization: the fused kernels' wire format
# ---------------------------------------------------------------------------

def row_squant_encode(x: torch.Tensor, u: torch.Tensor, s: int):
    """Per-row (last axis) stochastic s-quantization -> (levels int8,
    scales f32 = norm/s, keepdims).  A non-finite row ships a 0 scale so that
    its decode is exactly 0 (the clamp of ``kernels/fused_memory.py``)."""
    xf = x.to(torch.float32)
    norm = l2_norm(xf, fused=False)[..., None]   # square, then sum
    scale = torch.where(torch.isfinite(norm), norm / s,
                        torch.zeros_like(norm))
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    r = xf.abs() / safe * s
    low = torch.floor(r)
    psi = low + (u.to(torch.float32) < (r - low)).to(torch.float32)
    q = (torch.sign(xf) * psi).to(torch.int8)
    return q, scale


def row_squant_decode(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _row_squant_codec(d: int, s: int = 1, **_) -> Codec:
    s = _check_levels("row_squant", s)

    def encode(x, u=None, generator=None):
        q, scale = row_squant_encode(x, _uniforms(x, u, generator), s)
        meta = PayloadMeta("row_squant", tuple(x.shape), str(x.dtype),
                           (("s", s),))
        return WirePayload({"levels": q, "scales": scale}, meta)

    def decode(p):
        return row_squant_decode(p["levels"], p["scales"],
                                 getattr(torch, p.meta.dtype.removeprefix(
                                     "torch.")))

    def validate(p):
        return (_levels_ok(p["levels"], s)
                & _finite_nonneg(p["scales"])).to(torch.float32)

    def wire_bytes(shape):
        return {"s8": _nelems(shape), "f32": 4 * _nelems(shape[:-1])}

    return Codec(
        name=f"row_squant(s={s})", omega=squant_omega(max(d, 1), s),
        encode=encode, decode=decode,
        bits=lambda n, s=s, d=max(d, 1): math.ceil(n / d)
        * squant_bits(min(n, d), s),
        wire_bytes=wire_bytes, validate=validate,
        fused_uplink="squant_rows", fused_acc=True)


# ---------------------------------------------------------------------------
# index + value payloads: sparsify and topk
# ---------------------------------------------------------------------------

def _scatter(p) -> torch.Tensor:
    """Decode an index + value payload: ``values`` set at ``indices`` on the
    last axis of a zero message, as the reference's ``.at[idx].set(vals,
    mode="drop")``: an index in [-n, 0) counts from the end, any other
    index outside [0, n) (the sentinel n, a corrupted index) is dropped.
    Dropped entries land in an extra slot n that is cut off."""
    n = p.meta.shape[-1]
    idx = p["indices"].to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    vals = p["values"]
    out = torch.zeros(vals.shape[:-1] + (n + 1,), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_(-1, idx, vals)[..., :n]


def _sparsify_codec(d: int, q: float = 0.25, **_) -> Codec:
    q = float(q)
    if not 0.0 < q <= 1.0:
        raise ValueError(f"sparsify keep-probability q={q} not in (0, 1]")

    def encode(x, u=None, generator=None):
        u = _uniforms(x, u, generator)
        n = x.shape[-1]
        mask = u < q
        # kept coordinates first, each group in ascending index order; the
        # dropped slots carry the out-of-range sentinel n
        order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
        kept = torch.gather(mask, -1, order)
        idx = torch.where(kept, order, n).to(torch.int32)
        vals = torch.where(kept, torch.gather(x, -1, order) / q,
                           torch.zeros_like(x))
        meta = PayloadMeta("sparsify", tuple(x.shape), str(x.dtype),
                           (("q", q),))
        return WirePayload({"indices": idx, "values": vals}, meta)

    def validate(p):
        n = p.meta.shape[-1]
        oki = ((p["indices"] >= 0) & (p["indices"] <= n)).all(-1)
        return (oki & torch.isfinite(p["values"]).all(-1)).to(torch.float32)

    def wire_bytes(shape):
        # fixed capacity: n index slots (s32) and n value slots (f32)
        n = _nelems(shape)
        return {"s32": 4 * n, "f32": 4 * n}

    return Codec(
        name=f"sparsify(q={q})", omega=1.0 / q - 1.0,
        encode=encode, decode=_scatter,
        bits=lambda n, q=q: q * n * (FP_BITS + max(1.0,
                                                   math.log2(max(n, 2)))),
        wire_bytes=wire_bytes, validate=validate)


def _topk_codec(d: int, frac: float = 0.1, **_) -> Codec:
    frac = float(frac)

    def top(n: int) -> int:
        return max(1, int(n * frac))

    def encode(x, u=None, generator=None):
        k = top(x.shape[-1])
        # exactly k coordinates; on tied magnitudes the lower index first,
        # as jax.lax.top_k orders them (torch.topk promises no tie order)
        idx = torch.argsort(x.abs(), dim=-1, descending=True,
                            stable=True)[..., :k]
        meta = PayloadMeta("topk", tuple(x.shape), str(x.dtype),
                           (("frac", frac), ("k", k)))
        return WirePayload({"indices": idx.to(torch.int32),
                            "values": torch.gather(x, -1, idx)}, meta)

    def validate(p):
        n = p.meta.shape[-1]
        oki = ((p["indices"] >= 0) & (p["indices"] < n)).all(-1)
        return (oki & torch.isfinite(p["values"]).all(-1)).to(torch.float32)

    def wire_bytes(shape):
        k = _nelems(shape[:-1]) * top(int(shape[-1]))
        return {"s32": 4 * k, "f32": 4 * k}

    return Codec(
        name=f"topk({frac})", omega=1.0 - frac,
        encode=encode, decode=_scatter,
        bits=lambda n: top(n) * (FP_BITS + max(1.0, math.log2(max(n, 2)))),
        wire_bytes=wire_bytes, validate=validate, unbiased=False)


_REGISTRY: Dict[str, Callable[..., Codec]] = {
    "identity": _identity_codec,
    "none": _identity_codec,
    "squant": _squant_codec,
    "tile_squant": _tile_squant_codec,
    "row_squant": _row_squant_codec,
    "sparsify": _sparsify_codec,
    "topk": _topk_codec,
}


def available() -> Tuple[str, ...]:
    """Names of the codecs the port runs."""
    return tuple(sorted(_REGISTRY))


def make_codec(name: str, d: int, **kwargs) -> Codec:
    """Build a registered codec for messages of dimension ``d`` (``d`` fixes
    omega).  Unknown kwargs are ignored, as in the reference."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown codec {name!r}; choose from {sorted(_REGISTRY)}")
    return _REGISTRY[name](d, **kwargs)
