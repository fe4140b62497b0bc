"""The batch pipeline (port of ``repro/data/pipeline.py``).

The reference's ``ShardedBatches`` places each global batch on its mesh
with the batch axis split over the batch axes.  For workers simulated on
one card a batch moves to the device whole (``Batches``), and
``core/dist.make_train_step`` splits it into W contiguous blocks, one a
worker, as the reference's ``P(worker_axes)`` batch spec does.  A rank of
a process group (``core/dist_pg.py``) takes its own block
(``ShardedBatches``): the rows a simulated worker of the same index gets.
On a device mesh (``mesh=``) every rank makes the global batch and keeps
its block over the batch axes as a DTensor (each batch coordinate's rows,
replicated over the other axes, ``model`` among them), as the reference's
``NamedSharding(mesh, P(batch_axes))`` places it.
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
                 world: int = 1, *, mesh=None, batch_axes=("pod", "data")):
        super().__init__(stream, device)
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not one of {world} ranks")
        self.rank, self.world = rank, world
        self.sharding = None
        if mesh is not None:
            from repro_torch.launch.mesh import NamedSharding, Spec
            names = mesh.mesh_dim_names
            axes = tuple(dict.fromkeys(a for a in batch_axes if a in names))
            self.sharding = NamedSharding(mesh, Spec(axes))

    def batch_at(self, step: int) -> dict:
        if self.sharding is not None:
            from repro_torch.launch.mesh import distribute
            return {k: distribute(v.to(self.device), self.sharding)
                    for k, v in self.stream.batch_at(step).items()}
        out = {}
        for k, v in self.stream.batch_at(step).items():
            if v.shape[0] % self.world:
                raise ValueError(f"a batch of {v.shape[0]} rows does not "
                                 f"split over {self.world} ranks")
            n = v.shape[0] // self.world
            out[k] = v[self.rank * n:(self.rank + 1) * n].to(self.device)
        return out
