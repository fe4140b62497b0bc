"""The batch pipeline (port of ``repro/data/pipeline.py``).

The reference's ``ShardedBatches`` places each global batch on its mesh
with the batch axis split over the worker axes.  On one card a batch moves
to the device whole, and ``core/dist.make_train_step`` splits it into W
contiguous blocks, one a simulated worker, as the reference's
``P(worker_axes)`` batch spec does.
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


