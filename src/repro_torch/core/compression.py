"""Unbiased compression operators (paper Assumption 5): the simulator's
``Compressor`` view of the codecs (port of ``repro/core/compression.py``).

Every unbiased operator C satisfies E[C(x)] = x and
E||C(x) - x||^2 <= omega * ||x||^2.  A compressor's ``__call__(x, u)`` is
its codec's round trip ``decode(encode(x, u))`` on the last axis of ``x``
(leading axes are independent messages); ``bits(n)`` is the paper's
Elias-coded size of one n-element message (Prop. S1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import codec as wire

FP_BITS = wire.FP_BITS
squant_omega = wire.squant_omega
squant_bits = wire.squant_bits


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A compression operator with known variance factor omega."""
    name: str
    omega: float                       # Assumption-5 variance factor
    compress: Callable                 # (x, u, generator) -> x_hat
    bits: Callable                     # (n_elements,) -> float per message
    unbiased: bool = True

    def __call__(self, x: torch.Tensor, u: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        return self.compress(x, u, generator)


def from_codec(c: wire.Codec) -> Compressor:
    """The simulator view of a codec: compress == decode(encode(.))."""
    return Compressor(name=c.name, omega=c.omega, compress=c.__call__,
                      bits=c.bits, unbiased=c.unbiased)


def identity() -> Compressor:
    return from_codec(wire.make_codec("identity", 1))


def squant(d: int, s: int = 1) -> Compressor:
    """Global-norm s-quantization of d-element messages."""
    return from_codec(wire.make_codec("squant", d, s=s))


def tile_squant(tile: int = 1024, s: int = 1) -> Compressor:
    """s-quantization with one scale per ``tile`` coordinates; omega is
    that of a ``tile``-element message."""
    return from_codec(wire.make_codec("tile_squant", tile, s=s, tile=tile))


def sparsify(q: float) -> Compressor:
    """Keep each coordinate with probability q, rescaled by 1/q;
    omega = 1/q - 1 (Lemma S15)."""
    return from_codec(wire.make_codec("sparsify", 1, q=q))


def topk(frac: float) -> Compressor:
    """The k = max(1, int(n * frac)) largest magnitudes (biased)."""
    return from_codec(wire.make_codec("topk", 1, frac=frac))


def make_compressor(name: str, d: int, **kwargs) -> Compressor:
    return from_codec(wire.make_codec(name, d, **kwargs))
