"""Per-round noise of the sweep (``TorchNoise``) and per-step noise of the
mesh (``MeshNoise``): sample indices, participation and codec uniforms.

``round(k)`` returns a ``RoundNoise`` for round ``k`` with a leading axis of
S seeds: ``idx [S, N, batch]`` (None when the run takes full gradients),
``u_act [S, N]``, ``u_up [S, N, d]`` and ``u_dwn [S, d]``.  The sweep lays
them over its gamma x seed cells, so every variant and step size sees the
same draws for a seed (common random numbers, as in the reference, whose
cell keys depend only on the seed).

The interface replaces the reference's key derivation (``core/sweep.py``
micro step and ``core/artemis.py`` round keys).  A test hands the sweep a
source that replays the reference's exact draws, so the port needs no
bitwise copy of JAX's generator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Sequence, Tuple

import torch


@dataclasses.dataclass
class RoundNoise:
    idx: Optional[torch.Tensor]   # [S, N, batch] int64 sample indices
    u_act: torch.Tensor           # [S, N] participation uniforms
    u_up: torch.Tensor            # [S, N, d] uplink codec uniforms
    u_dwn: torch.Tensor           # [S, d] downlink codec uniforms


class NoiseSource(Protocol):
    def round(self, k: int) -> RoundNoise:
        ...


class TorchNoise:
    """The default noise source: one ``torch.Generator`` on the run's
    device, one stream per cell seed.  Draws come in chunks of ``CHUNK``
    rounds; chunk c of seed s is drawn right after
    ``manual_seed(s * 2**20 + c)``, so a seed's stream depends on nothing
    but the seed, and ``round(k)`` may be asked in any order (the sweep asks
    again from round 0 for each variant)."""

    CHUNK = 64

    def __init__(self, seeds: Sequence[int], n_workers: int, dim: int,
                 batch: Optional[int], n_per: int, device):
        self.seeds = [int(s) for s in seeds]
        if any(s < 0 or s >= 2**40 for s in self.seeds):
            raise ValueError(f"seeds must lie in [0, 2**40): {self.seeds}")
        self.n, self.d, self.batch, self.n_per = n_workers, dim, batch, n_per
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self._chunk = -1
        self._draws = None

    def _draw(self, c: int):
        r, n, d, dev, gen = self.CHUNK, self.n, self.d, self.device, self.gen
        per_seed = []
        for s in self.seeds:
            gen.manual_seed(s * 2**20 + c)
            idx = (None if self.batch is None else
                   torch.randint(0, self.n_per, (r, n, self.batch),
                                 generator=gen, device=dev))
            per_seed.append((idx,
                             torch.rand(r, n, generator=gen, device=dev),
                             torch.rand(r, n, d, generator=gen, device=dev),
                             torch.rand(r, d, generator=gen, device=dev)))
        # [R, S, ...]: one round's draws are a contiguous slice
        return [None if parts[0] is None else torch.stack(parts, dim=1)
                for parts in zip(*per_seed)]

    def round(self, k: int) -> RoundNoise:
        c, j = divmod(int(k), self.CHUNK)
        if c != self._chunk:
            self._draws, self._chunk = self._draw(c), c
        idx, u_act, u_up, u_dwn = (None if x is None else x[j]
                                   for x in self._draws)
        return RoundNoise(idx=idx, u_act=u_act, u_up=u_up, u_dwn=u_dwn)


@dataclasses.dataclass
class MeshDraws:
    """One communicating step's draws on the simulated mesh."""
    u_up: torch.Tensor    # [W, B, R, C] uplink codec uniforms, per worker
    u_act: torch.Tensor   # [W] participation uniforms
    u_dwn: torch.Tensor   # [B, R, C] downlink uniforms, shared by all workers


class MeshNoiseSource(Protocol):
    def step(self, k: int) -> MeshDraws:
        ...


class MeshNoise:
    """The default noise of the mesh step (``core/dist.py``), replacing the
    reference's ``dist._round_keys`` chain: step k's draws come from one
    ``torch.Generator`` on the run's device, seeded with
    ``seed * 2**20 + k``, so they depend on nothing but (seed, k).  The
    downlink uniforms are one tensor for every worker: the reference's
    zero-byte broadcast, where each worker compresses the identical
    aggregate with the identical key."""

    def __init__(self, seed: int, n_workers: int,
                 shape: Tuple[int, int, int], device):
        if not 0 <= int(seed) < 2**40:
            raise ValueError(f"seed must lie in [0, 2**40): {seed}")
        self.seed, self.n, self.shape = int(seed), n_workers, tuple(shape)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)

    def step(self, k: int) -> MeshDraws:
        gen, dev = self.gen, self.device
        gen.manual_seed(self.seed * 2**20 + int(k))
        u_up = torch.rand((self.n,) + self.shape, generator=gen, device=dev)
        u_act = torch.rand(self.n, generator=gen, device=dev)
        u_dwn = torch.rand(self.shape, generator=gen, device=dev)
        return MeshDraws(u_up=u_up, u_act=u_act, u_dwn=u_dwn)
