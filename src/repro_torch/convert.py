"""Carry the JAX package's state across: numpy arrays in, the port's objects
out.  Tests use it to give both packages the same problem, state and start
point (``np.asarray`` of a JAX array is the hand-over)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.core.artemis import ArtemisState
from repro_torch.core.dist import ArtemisDistState
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


def toy_params(params, *, device=None):
    """ToyMLP parameters from the reference's nested dict
    ``{"head", "layer_00": {"b", "w"}, ...}`` of numpy arrays: a dict under
    the port's leaf names, in the reference's flatten order (sorted keys)."""
    dev = default_device(device)
    out = {}
    for key in sorted(params):
        if isinstance(params[key], dict):
            for sub in sorted(params[key]):
                out[f"{key}/{sub}"] = _tensor(params[key][sub], dev)
        else:
            out[key] = _tensor(params[key], dev)
    return out


def dist_state(h, hbar, e, acc, prev_active, step, *,
               device=None) -> ArtemisDistState:
    """An ``ArtemisDistState`` from the reference's bucketed mesh state
    (``[W, B, R, C]`` stacks or ``[W]`` stubs, a replicated ``hbar``)."""
    dev = default_device(device)

    def memory(a):
        # numpy has no bfloat16 of its own: go through float32, exactly
        dt = (torch.bfloat16 if np.asarray(a).dtype.name == "bfloat16"
              else torch.float32)
        return _tensor(np.asarray(a, np.float32), dev).to(dt)

    return ArtemisDistState(h=memory(h), hbar=memory(hbar),
                            e=_tensor(e, dev), acc=_tensor(acc, dev),
                            prev_active=_tensor(prev_active, dev),
                            step=int(np.asarray(step)))
