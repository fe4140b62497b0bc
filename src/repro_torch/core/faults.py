"""The zero-fault surface of the fault model (port of part of
``repro/core/faults.py``).

``FaultConfig`` keeps the reference's fields and checks; ``of`` maps None to
the all-off config.  The mesh aggregate touches two helpers:
``participation`` on its i.i.d. branch (``u < p``) and ``mask_payload``
(PP2's ``scale *= active``).  Fault injection and the server's defenses are
not ported yet: ``check_zero`` raises for any enabled fault, naming
ROADMAP A7.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NOT_PORTED = "fault injection is not ported yet; see ROADMAP.md A7"


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
    def enabled(self) -> bool:
        return (self.straggler_rate > 0.0 or self.markov
                or self.bitflip_rate > 0.0 or self.blowup_rate > 0.0
                or self.scrub or self.rollback)


ZERO = FaultConfig()


def of(fc: Optional[FaultConfig]) -> FaultConfig:
    """None-safe accessor: ``faults=None`` is the all-off config."""
    return ZERO if fc is None else fc


def check_zero(fc: Optional[FaultConfig]) -> None:
    """Raise for any enabled fault: only the zero-fault config runs."""
    if of(fc).enabled:
        raise NotImplementedError(NOT_PORTED)


def participation(fc: FaultConfig, p: float,
                  u: torch.Tensor) -> torch.Tensor:
    """Availability mask ``u < p`` as float32 (the i.i.d. branch; the
    Markov chain is not ported)."""
    if fc.markov:
        raise NotImplementedError(NOT_PORTED)
    return (u < p).to(torch.float32)


def _lead_broadcast(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A leading-axes mask ([W]) shaped to broadcast against a leaf
    ([W, B, R, C] levels, [W, B, R, 1] scales)."""
    return mask.reshape(tuple(mask.shape)
                        + (1,) * (leaf.dim() - mask.dim()))


def mask_payload(payload, keep: torch.Tensor):
    """PP2 inactivity on the payload: scale every floating wire leaf by
    ``keep`` so a masked payload decodes to exactly zero; integer levels
    ride along untouched."""
    return payload.replace(**{
        k: v * _lead_broadcast(keep, v).to(v.dtype)
        for k, v in payload.data.items() if v.is_floating_point()})
