"""The fault model (port of ``repro/core/faults.py``, DESIGN.md §8).

``FaultConfig`` keeps the reference's fields, checks and static gates; ``of``
maps None to the all-off config, which is the identity: every fault path is
gated on the config, so ``FaultConfig()`` runs the same code as no config.

Faults (rates per round): stragglers (an available worker misses the
round), Markov-correlated availability (``p_stay``), wire bit flips on the
uplink payload, and gradient blowups.  Defenses: scrubbing (a payload that
fails its codec's ``validate`` is treated as inactive by zeroing its float
leaves; a non-finite gradient is masked at entry) and the sweep's
divergence sentinel (rollback with step-size backoff, ``core/sweep.py``).

Randomness enters as tensors, as everywhere in the port: a primitive takes
the flipped bit of each element (``bit``, drawn as the reference's
``randint(0, 8)`` for int8 and ``randint(0, 32)`` for float32 and int32)
and its hit uniform (``u``; the element is hit where ``u < rate``, which is
the reference's Bernoulli draw).  A payload's draws come one pair per leaf
in sorted-key order (``core/noise.py``).

Both paths run every fault: the simulator (``core/artemis.py``,
``core/sweep.py``) and the mesh wire on both of its wires
(``core/dist.py``, ``core/dist_pg.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

# the reference's salt for its fault key streams; the port's noise sources
# seed their fault draws outside the base draws' seed range instead
FAULT_SALT = 0x6F175EED


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    straggler_rate: float = 0.0     # P(available worker misses the deadline)
    p_stay: Optional[float] = None  # Markov P(active -> active); None = i.i.d.
    bitflip_rate: float = 0.0       # per-element P(one random flipped bit)
    blowup_rate: float = 0.0        # per-worker P(gradient -> blowup_value)
    blowup_value: float = float("nan")
    scrub: bool = False             # server finite/checksum scrubbing
    sentinel: float = 0.0           # loss/||w|| rollback threshold (0 = off)
    backoff: float = 0.5            # gamma *= backoff on each rollback

    def __post_init__(self):
        for name in ("straggler_rate", "bitflip_rate", "blowup_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} not in [0, 1]")
        if self.p_stay is not None and not 0.0 <= self.p_stay <= 1.0:
            raise ValueError(f"p_stay={self.p_stay} not in [0, 1]")
        if not 0.0 < self.backoff <= 1.0:
            raise ValueError(f"backoff={self.backoff} not in (0, 1]")

    @property
    def markov(self) -> bool:
        return self.p_stay is not None

    @property
    def rollback(self) -> bool:
        return self.sentinel > 0.0

    @property
    def wire_faults(self) -> bool:
        """Anything that touches the uplink payload path."""
        return self.bitflip_rate > 0.0 or self.scrub

    @property
    def enabled(self) -> bool:
        return (self.straggler_rate > 0.0 or self.markov
                or self.bitflip_rate > 0.0 or self.blowup_rate > 0.0
                or self.scrub or self.rollback)


ZERO = FaultConfig()


def of(fc: Optional[FaultConfig]) -> FaultConfig:
    """None-safe accessor: ``faults=None`` is the all-off config."""
    return ZERO if fc is None else fc


# ---------------------------------------------------------------------------
# correlated (Markov) participation
# ---------------------------------------------------------------------------

def markov_rates(fc: FaultConfig, p: float) -> Tuple[float, float]:
    """Transition probabilities (a, b) = (P(1->1), P(0->1)) with stationary
    participation ``p``.  ``p_stay = p`` gives a == b == p (i.i.d.)."""
    a = float(fc.p_stay)
    if p >= 1.0:
        return a, 1.0
    b = p * (1.0 - a) / (1.0 - p)
    if b > 1.0 + 1e-9:
        raise ValueError(
            f"Markov participation infeasible: p={p}, p_stay={a} needs "
            f"P(0->1)={b:.3f} > 1; require p_stay >= (2p-1)/p")
    return a, min(b, 1.0)


def markov_autocorr(fc: FaultConfig, p: float) -> float:
    """Lag-1 autocorrelation of the stationary availability chain."""
    if p >= 1.0:
        return 0.0
    return (float(fc.p_stay) - p) / (1.0 - p)


def participation(fc: FaultConfig, p: float, u: torch.Tensor,
                  prev: Optional[torch.Tensor] = None,
                  k: int = 0) -> torch.Tensor:
    """Availability mask as float32 from the participation uniforms ``u``.
    ``prev``: the previous round's availability (``u``'s shape); ``k``: the
    round (round 0 draws from the stationary distribution).  Equals
    ``u < p`` when the chain is off or ``p_stay == p``."""
    if not fc.markov or k == 0:
        return (u < p).to(torch.float32)
    a, b = markov_rates(fc, p)
    return (u < torch.where(prev > 0, a, b)).to(torch.float32)


# ---------------------------------------------------------------------------
# injection primitives
# ---------------------------------------------------------------------------

def _flip_mask(bit: torch.Tensor, dtype) -> torch.Tensor:
    # a tensor shift: a Python ``1 << 31`` would overflow int32
    return torch.ones(bit.shape, dtype=dtype, device=bit.device) \
        << bit.to(dtype)


def corrupt_int8(q: torch.Tensor, bit: torch.Tensor, u: torch.Tensor,
                 rate: float) -> torch.Tensor:
    """Flip bit ``bit`` (0-7) of each int8 element where ``u < rate``."""
    flipped = (q.view(torch.uint8) ^ _flip_mask(bit, torch.uint8)
               ).view(torch.int8)
    return torch.where(u < rate, flipped, q)


def corrupt_f32(x: torch.Tensor, bit: torch.Tensor, u: torch.Tensor,
                rate: float) -> torch.Tensor:
    """Flip bit ``bit`` (0-31; 31 is the sign) of each element's float32
    pattern where ``u < rate``.  Returns float32 (a bf16 leaf goes through
    float32, as the reference's does)."""
    x = x.to(torch.float32)
    flipped = (x.view(torch.int32) ^ _flip_mask(bit, torch.int32)
               ).view(torch.float32)
    return torch.where(u < rate, flipped, x)


def corrupt_i32(x: torch.Tensor, bit: torch.Tensor, u: torch.Tensor,
                rate: float) -> torch.Tensor:
    """Flip bit ``bit`` (0-31) of each int32 element (index payloads) where
    ``u < rate``."""
    return torch.where(u < rate, x ^ _flip_mask(bit, torch.int32), x)


def flip_bits(dtype) -> int:
    """The range of the flipped bit's draw for a leaf of ``dtype``."""
    return 8 if dtype == torch.int8 else 32


# ---------------------------------------------------------------------------
# payload-level operators (codec WirePayloads)
# ---------------------------------------------------------------------------

def _lead_broadcast(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A leading-axes mask ([..., N]) shaped to broadcast against a payload
    leaf ([..., N, d] levels, [..., N, 1] scales)."""
    return mask.reshape(tuple(mask.shape)
                        + (1,) * (leaf.dim() - mask.dim()))


def corrupt_payload(draws: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    payload, rate: float,
                    only: Optional[torch.Tensor] = None):
    """Flip bits of every wire leaf of ``payload``, dispatching on the leaf
    dtype (int8 levels, float scales and values, int32 indices).  ``draws``
    holds one (bit, u) pair per leaf in sorted-key order, each with the
    leaf's number of elements.  ``only``: an optional {0, 1} mask on the
    leading axes restricting corruption to payloads that were sent."""
    keys = payload.keys()
    if len(draws) != len(keys):
        raise ValueError(f"{len(draws)} fault draws for the {len(keys)} "
                         f"leaves {keys}")
    out = {}
    for key, (bit, u) in zip(keys, draws):
        leaf = payload[key]
        bit, u = bit.reshape(leaf.shape), u.reshape(leaf.shape)
        if leaf.dtype == torch.int8:
            c = corrupt_int8(leaf, bit, u, rate)
        elif leaf.dtype == torch.int32:
            c = corrupt_i32(leaf, bit, u, rate)
        elif leaf.is_floating_point():
            c = corrupt_f32(leaf, bit, u, rate).to(leaf.dtype)
        else:
            c = leaf
        if only is not None:
            c = torch.where(_lead_broadcast(only, leaf) > 0, c, leaf)
        out[key] = c
    return payload.replace(**out)


def mask_payload(payload, keep: torch.Tensor):
    """PP2 inactivity on the payload: scale every floating wire leaf by
    ``keep`` so a masked payload decodes to exactly zero; integer levels
    ride along untouched.  No NaN cleanup: an unprotected corrupt payload
    keeps poisoning what it touches."""
    return payload.replace(**{
        k: v * _lead_broadcast(keep, v).to(v.dtype)
        for k, v in payload.data.items() if v.is_floating_point()})


def scrub_payload(payload, valid: torch.Tensor):
    """Server-side scrubbing: zero the non-finite float entries and scale
    them by the ``valid`` checksum mask (``Codec.validate``), so a corrupt
    payload contributes exactly zero through PP2's zero-scale path."""
    return payload.replace(**{
        k: nan_to_zero(v) * _lead_broadcast(valid, v).to(v.dtype)
        for k, v in payload.data.items() if v.is_floating_point()})


def blowup_mask(fc: FaultConfig, u: torch.Tensor) -> torch.Tensor:
    """The per-worker blowup draw: True where ``u < blowup_rate``."""
    return u < fc.blowup_rate


def apply_blowup(fc: FaultConfig, hit: torch.Tensor,
                 grads: torch.Tensor) -> torch.Tensor:
    """Replace the hit workers' gradients (``hit`` on grads' leading axes,
    [..., N] against [..., N, d]) with ``blowup_value``."""
    # a fill on the device, not a copy from the host (which would wait)
    value = torch.full((), fc.blowup_value, dtype=torch.float32,
                       device=grads.device).to(grads.dtype)
    return torch.where(_lead_broadcast(hit, grads), value, grads)


def inject_blowup(fc: FaultConfig, u: torch.Tensor,
                  grads: torch.Tensor) -> torch.Tensor:
    """Replace whole per-worker gradients with ``blowup_value`` where the
    worker's uniform ``u`` is below ``blowup_rate``."""
    return apply_blowup(fc, blowup_mask(fc, u), grads)


# ---------------------------------------------------------------------------
# server-side scrubbing
# ---------------------------------------------------------------------------

def _all(x: torch.Tensor, dims) -> torch.Tensor:
    """``x.all`` over ``dims`` (an int or a tuple), keeping them."""
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    for dim in sorted({d % x.dim() for d in dims}, reverse=True):
        x = x.all(dim, keepdim=True)
    return x


def finite_mask(x: torch.Tensor, dims) -> torch.Tensor:
    """1.0 where ``x`` is finite over ``dims`` (kept), else 0.0."""
    return _all(torch.isfinite(x), dims).to(torch.float32)


def nan_to_zero(x: torch.Tensor) -> torch.Tensor:
    """Zero the non-finite entries (``0 * NaN`` is NaN: masking alone does
    not clear them)."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def payload_valid(q: torch.Tensor, scale: torch.Tensor, lmax: int,
                  dims) -> torch.Tensor:
    """Checksum-style validity of a quantized payload over ``dims`` (kept):
    int8 levels in [-lmax, lmax] and scales finite and non-negative, in
    ``scale``'s dtype."""
    okq = _all(q.to(torch.int32).abs() <= lmax, dims)
    oks = _all(torch.isfinite(scale) & (scale >= 0), dims)
    return (okq & oks).to(scale.dtype)
