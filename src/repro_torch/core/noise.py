"""Per-round noise of the sweep (``TorchNoise``) and per-step noise of the
mesh (``MeshNoise``): sample indices, participation and codec uniforms.

``round(k)`` returns a ``RoundNoise`` for round ``k`` with a leading axis of
S seeds: ``idx [S, N, batch]`` (None when the run takes full gradients),
``u_act [S, N]``, ``u_up [S, N, d]`` and ``u_dwn [S, d]``.  The sweep lays
them over its gamma x seed cells, so every variant and step size sees the
same draws for a seed (common random numbers, as in the reference, whose
cell keys depend only on the seed).

A faulted variant also asks for the fault draws of its round
(``faults=True``): the straggler and blowup uniforms ``u_strag`` and
``u_blow [S, N]``, and, for each leaf of its uplink payload in sorted-key
order (``leaves``: the per-cell shape and the range of the flipped bit), a
flip-bit tensor (int32) and a hit-uniform tensor of that shape with the
seed axis in front (``flips``).  A run without faults draws none of them.

After a rollback of the divergence sentinel (``core/sweep.py``) a cell's
``ArtemisState.step`` falls behind the round; the sweep then hands the
cells' steps to ``round`` (``steps [G * S]``).  The reference keys its codec
and wire draws on that step; ``TorchNoise`` keys every draw on the round
alone and ignores it.  A source that uses it returns ``u_up``, ``u_dwn``
and ``flips`` per cell, with a leading axis of G * S in place of S.

The mesh's ``step(k)`` returns a ``MeshDraws`` for communicating step k:
per-worker uplink uniforms, participation uniforms and the shared downlink
uniforms, on the bucket stack or per parameter leaf; with ``faults=True``
also the straggler and blowup uniforms and the bit flips of every wire
message (the reference's ``dist._round_keys`` chain).

The interface replaces the reference's key derivation (``core/sweep.py``
micro step, ``core/artemis.py`` round keys, ``core/dist.py`` step keys).  A test hands the sweep a
source that replays the reference's exact draws, so the port needs no
bitwise copy of JAX's generator.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence, Tuple, Union

import torch


# a payload leaf's fault draw: its shape per cell and the range of the
# flipped bit (``faults.flip_bits``)
LeafSpec = Tuple[Tuple[int, ...], int]


@dataclasses.dataclass
class RoundNoise:
    idx: Optional[torch.Tensor]   # [S, N, batch] int64 sample indices
    u_act: torch.Tensor           # [S, N] participation uniforms
    u_up: torch.Tensor            # [S, N, d] uplink codec uniforms
    u_dwn: torch.Tensor           # [S, d] downlink codec uniforms
    u_strag: Optional[torch.Tensor] = None   # [S, N] straggler uniforms
    u_blow: Optional[torch.Tensor] = None    # [S, N] blowup uniforms
    # per uplink payload leaf, sorted-key order: (bit int32, u f32), each
    # [S, *leaf shape]
    flips: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None


class NoiseSource(Protocol):
    def round(self, k: int, *, steps: Optional[torch.Tensor] = None,
              faults: bool = False,
              leaves: Sequence[LeafSpec] = ()) -> RoundNoise:
        ...


class TorchNoise:
    """The default noise source: one ``torch.Generator`` on the run's
    device, one stream per cell seed.  Draws come in chunks of ``CHUNK``
    rounds; chunk c of seed s is drawn right after
    ``manual_seed(s * 2**20 + c)``, so a seed's stream depends on nothing
    but the seed, and ``round(k)`` may be asked in any order (the sweep asks
    again from round 0 for each variant, and a resumed sweep from its
    snapshot's round: the source keeps no state a resume must restore).

    The fault draws are drawn on demand in the same chunks, from seeds
    outside the base draws' range (those lie below 2**60): ``2**60 +
    s * 2**20 + c`` for the straggler and blowup uniforms and ``2**61 +
    s * 2**20 + c`` for the wire flips, which follow the leaf list in order
    (bits, then hit uniforms, per leaf).  So a run without faults draws
    exactly what it drew before they existed, and a seed's fault draws
    depend only on the seed and, for the flips, on the payload's leaves,
    not on the other variants of the sweep."""

    CHUNK = 64
    FAULT_TAG, WIRE_TAG = 1, 2          # multiples of 2**60 in the seed

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
        self._faults = (-1, None)
        self._wire = {}                 # leaves -> (chunk, draws)

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

    def _seeded(self, tag: int, c: int):
        """Seed the generator for chunk c of each seed in turn (yields the
        generator once per seed)."""
        for s in self.seeds:
            self.gen.manual_seed(tag * 2**60 + s * 2**20 + c)
            yield self.gen

    def _draw_faults(self, c: int):
        r, n, dev = self.CHUNK, self.n, self.device
        parts = [(torch.rand(r, n, generator=g, device=dev),
                  torch.rand(r, n, generator=g, device=dev))
                 for g in self._seeded(self.FAULT_TAG, c)]
        return [torch.stack(p, dim=1) for p in zip(*parts)]

    def _draw_wire(self, c: int, leaves: Tuple[LeafSpec, ...]):
        r, dev = self.CHUNK, self.device
        per_seed = []
        for g in self._seeded(self.WIRE_TAG, c):
            per_seed.append([
                t for shape, bits in leaves for t in (
                    torch.randint(0, bits, (r,) + tuple(shape), generator=g,
                                  device=dev, dtype=torch.int32),
                    torch.rand((r,) + tuple(shape), generator=g,
                               device=dev))])
        return [torch.stack(p, dim=1) for p in zip(*per_seed)]

    def round(self, k: int, *, steps: Optional[torch.Tensor] = None,
              faults: bool = False,
              leaves: Sequence[LeafSpec] = ()) -> RoundNoise:
        c, j = divmod(int(k), self.CHUNK)
        if c != self._chunk:
            self._draws, self._chunk = self._draw(c), c
        idx, u_act, u_up, u_dwn = (None if x is None else x[j]
                                   for x in self._draws)
        out = RoundNoise(idx=idx, u_act=u_act, u_up=u_up, u_dwn=u_dwn)
        if not faults:
            return out
        if self._faults[0] != c:
            self._faults = (c, self._draw_faults(c))
        out.u_strag, out.u_blow = (x[j] for x in self._faults[1])
        leaves = tuple((tuple(shape), int(bits)) for shape, bits in leaves)
        if leaves:
            if self._wire.get(leaves, (-1,))[0] != c:
                self._wire[leaves] = (c, self._draw_wire(c, leaves))
            draws = [x[j] for x in self._wire[leaves][1]]
            out.flips = list(zip(draws[0::2], draws[1::2]))
        return out


@dataclasses.dataclass
class MeshDraws:
    """One communicating step's draws on the simulated mesh.

    On the bucketed wire ``u_up`` is one ``[W, B, R, C]`` tensor and
    ``u_dwn`` one ``[B, R, C]``; on the leaf wire each is a list with one
    tensor per parameter leaf in flatten order, ``[W, *leaf shape]`` and
    ``leaf shape``.  The fault draws are None unless asked for: the
    straggler and blowup uniforms (``[W]``), and ``flips``, one list per
    wire message (the bucket stack, or each parameter leaf) holding a
    (bit int32, uniform f32) pair per payload leaf in sorted-key order, each
    ``[W, *payload leaf shape]``."""
    u_up: Union[torch.Tensor, List[torch.Tensor]]
    u_act: torch.Tensor   # [W] participation uniforms
    u_dwn: Union[torch.Tensor, List[torch.Tensor]]
    u_strag: Optional[torch.Tensor] = None
    u_blow: Optional[torch.Tensor] = None
    flips: Optional[List[List[Tuple[torch.Tensor, torch.Tensor]]]] = None


class MeshNoiseSource(Protocol):
    def step(self, k: int, *, faults: bool = False,
             leaves: Sequence[Sequence[LeafSpec]] = ()) -> MeshDraws:
        ...


def _is_shape(x) -> bool:
    return all(isinstance(d, int) for d in x)


class MeshNoise:
    """The default noise of the mesh step (``core/dist.py``), replacing the
    reference's ``dist._round_keys`` chain: step k's draws come from one
    ``torch.Generator`` on the run's device, seeded with
    ``seed * 2**20 + k``, so they depend on nothing but (seed, k).  The
    downlink uniforms are one draw for every worker: the reference's
    zero-byte broadcast, where each worker compresses the identical
    aggregate with the identical key.

    ``shape`` is the bucket stack's ``[B, R, C]`` (the bucketed wire) or a
    list of parameter-leaf shapes (the leaf wire: the uplink uniforms of
    every leaf in turn, then the participation uniforms, then the downlink
    uniforms of every leaf).

    ``step(k, faults=True, leaves=...)`` adds the fault draws, from seeds
    outside the base draws' range as ``TorchNoise`` seeds them
    (``2**60 + seed * 2**20 + k`` for the straggler and blowup uniforms,
    ``2**61 + ...`` for the flips, message by message, bits then hit
    uniforms per payload leaf), so a run without faults draws exactly what
    it drew before they existed.  ``leaves`` holds one sequence of
    ``(payload leaf shape, flipped-bit range)`` per wire message, without
    the worker axis."""

    FAULT_TAG, WIRE_TAG = TorchNoise.FAULT_TAG, TorchNoise.WIRE_TAG

    def __init__(self, seed: int, n_workers: int, shape, device):
        if not 0 <= int(seed) < 2**40:
            raise ValueError(f"seed must lie in [0, 2**40): {seed}")
        self.seed, self.n = int(seed), n_workers
        self.bucketed = _is_shape(shape)
        self.shapes = ([tuple(shape)] if self.bucketed
                       else [tuple(int(d) for d in s) for s in shape])
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)

    def _seed(self, tag: int, k: int) -> torch.Generator:
        return self.gen.manual_seed(tag * 2**60 + self.seed * 2**20 + int(k))

    def step(self, k: int, *, faults: bool = False,
             leaves: Sequence[Sequence[LeafSpec]] = ()) -> MeshDraws:
        dev, n = self.device, self.n
        gen = self._seed(0, k)
        u_up = [torch.rand((n,) + s, generator=gen, device=dev)
                for s in self.shapes]
        u_act = torch.rand(n, generator=gen, device=dev)
        u_dwn = [torch.rand(s, generator=gen, device=dev)
                 for s in self.shapes]
        if self.bucketed:
            u_up, u_dwn = u_up[0], u_dwn[0]
        out = MeshDraws(u_up=u_up, u_act=u_act, u_dwn=u_dwn)
        if not faults:
            return out
        gen = self._seed(self.FAULT_TAG, k)
        out.u_strag = torch.rand(n, generator=gen, device=dev)
        out.u_blow = torch.rand(n, generator=gen, device=dev)
        if leaves:
            gen = self._seed(self.WIRE_TAG, k)
            out.flips = [[(torch.randint(0, bits, (n,) + tuple(shape),
                                         generator=gen, device=dev,
                                         dtype=torch.int32),
                           torch.rand((n,) + tuple(shape), generator=gen,
                                      device=dev))
                          for shape, bits in msg] for msg in leaves]
        return out
