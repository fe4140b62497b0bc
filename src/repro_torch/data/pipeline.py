"""The batch pipeline (port of ``repro/data/pipeline.py``).

The reference's ``ShardedBatches`` places each global batch on its mesh
with the batch axis split over the worker axes.  For workers simulated on
one card a batch moves to the device whole (``Batches``), and
``core/dist.make_train_step`` splits it into W contiguous blocks, one a
worker, as the reference's ``P(worker_axes)`` batch spec does.  A rank of
a process group (``core/dist_pg.py``) takes its own block
(``ShardedBatches``): the rows a simulated worker of the same index gets.
"""
from __future__ import annotations

from typing import Iterator

from repro_torch import default_device
from repro_torch.data.synthetic import TokenStream


class Batches:
    def __init__(self, stream: TokenStream, device=None):
        self.stream = stream
        self.device = default_device(device)

    def batch_at(self, step: int) -> dict:
        return {k: v.to(self.device)
                for k, v in self.stream.batch_at(step).items()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ShardedBatches(Batches):
    """This rank's contiguous block of every global batch: rows
    ``[rank * b / world, (rank + 1) * b / world)`` of its ``b`` rows."""

    def __init__(self, stream: TokenStream, device=None, rank: int = 0,
                 world: int = 1):
        super().__init__(stream, device)
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not one of {world} ranks")
        self.rank, self.world = rank, world

    def batch_at(self, step: int) -> dict:
        out = {}
        for k, v in self.stream.batch_at(step).items():
            if v.shape[0] % self.world:
                raise ValueError(f"a batch of {v.shape[0]} rows does not "
                                 f"split over {self.world} ranks")
            n = v.shape[0] // self.world
            out[k] = v[self.rank * n:(self.rank + 1) * n].to(self.device)
        return out
