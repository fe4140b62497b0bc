"""PyTorch/CUDA port of the Artemis simulator.

The JAX package ``repro`` is the reference this package is held against; the
port imports nothing from it.  Its layout mirrors ``repro``: ``core/`` holds
the codecs, the Artemis round, the federated problems, the per-round noise
source, the fault model and the grid sweep; ``checkpoint/`` the
checkpointer of resumable sweeps; ``kernels/`` the hand-written CUDA
kernels (sources under ``csrc/``) beside their plain PyTorch versions.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` when the caller names
    one, else CUDA.  Raises when CUDA is asked for (or defaulted to) and is
    missing: the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:               # 'cuda' means the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
