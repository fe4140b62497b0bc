"""Minimal functional optimizers (port of ``repro/optim/optimizers.py``).

They act on lists of tensors, one per parameter, in a fixed order:
``update(grads, state, step, params=None) -> (updates, new_state)``, and the
caller applies ``params - updates`` (the step size is folded in already).
Artemis composes with either, because compression acts on the gradient
aggregate before the optimizer sees it.  ``cosine_lr`` is the warm-up then
cosine step-size schedule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Tuple

import torch

Tensors = List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tensors], Any]
    update: Callable[..., Tuple[Tensors, Any]]


def sgd(lr: float, momentum: float = 0.0,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params: Tensors):
        if momentum == 0.0:
            return ()
        return [torch.zeros_like(p) for p in params]

    def update(grads: Tensors, state, step: int,
               params: Optional[Tensors] = None):
        del step
        if weight_decay and params is not None:
            grads = [g + weight_decay * p for g, p in zip(grads, params)]
        if momentum == 0.0:
            return [lr * g for g in grads], ()
        new_m = [momentum * m + g for m, g in zip(state, grads)]
        return [lr * m for m in new_m], new_m

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params: Tensors):
        z = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return {"m": z, "v": [torch.zeros_like(x) for x in z]}

    def update(grads: Tensors, state, step: int,
               params: Optional[Tensors] = None):
        # the bias corrections in float32, as the reference computes them
        t = torch.tensor(float(step) + 1.0, dtype=torch.float32)
        c1, c2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
        g32 = [g.to(torch.float32) for g in grads]
        m = [b1 * m_ + (1 - b1) * g for m_, g in zip(state["m"], g32)]
        v = [b2 * v_ + (1 - b2) * g * g for v_, g in zip(state["v"], g32)]
        upd = [lr * (m_ / c1.to(m_.device))
               / (torch.sqrt(v_ / c2.to(v_.device)) + eps)
               for m_, v_ in zip(m, v)]
        if weight_decay and params is not None:
            upd = [u + lr * weight_decay * p.to(torch.float32)
                   for u, p in zip(upd, params)]
        return upd, {"m": m, "v": v}

    return Optimizer(init, update)


def cosine_lr(base: float, warmup: int, total: int, floor: float = 0.1):
    """Step size at ``step``: linear warm-up over ``warmup`` steps, then a
    cosine decay from ``base`` to ``floor * base`` at ``total``.  Takes an
    int or an int tensor and returns a float32 tensor, in the reference's
    float32 arithmetic."""
    def sched(step) -> torch.Tensor:
        s = torch.as_tensor(step).to(torch.float32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base * torch.where(s < warmup, warm, cos)
    return sched
