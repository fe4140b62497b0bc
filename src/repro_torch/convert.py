"""Carry the JAX package's state across: numpy arrays in, the port's objects
out.  Tests use it to give both packages the same problem, state and start
point (``np.asarray`` of a JAX array is the hand-over)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.core.artemis import ArtemisState
from repro_torch.core.federated import Problem


def _tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def problem(X, Y, kind: str, reg: float = 0.0, *, device=None) -> Problem:
    """A ``Problem`` from the reference's stacked data X [N, n, d], Y [N, n]."""
    dev = default_device(device)
    return Problem(X=_tensor(X, dev), Y=_tensor(Y, dev), kind=kind,
                   reg=float(reg))


def state(h, hbar, e, step, *, device=None) -> ArtemisState:
    """An ``ArtemisState`` from the reference's (h, hbar, e, step)."""
    dev = default_device(device)
    return ArtemisState(h=_tensor(h, dev), hbar=_tensor(hbar, dev),
                        e=_tensor(e, dev),
                        step=_tensor(step, dev, torch.int32))


def vector(w, *, device=None) -> torch.Tensor:
    """A float32 vector such as ``w0`` or ``w_star``."""
    return _tensor(w, default_device(device))
