"""The weights of a run, made on the device from the seed.

One ``torch.randn`` over every drawn element, in ``param_spec`` order, on a
generator on the run's device; each leaf is a view of it, scaled in place
by its standard deviation.  A norm's scale starts at zero.  The benchmark
hands the same weights to the program and to the reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.model import Spec


def make_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn = sum(math.prod(s) for _, s, std in spec if std)
    flat = torch.randn(drawn, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, std in spec:
        if std:
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape).mul_(std)
            off += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
