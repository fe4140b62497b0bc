"""Tiny many-leaf regression model for the mesh wire (port of
``repro/models/toy.py``).

``ToyMLP`` is ``n_layers x (w [d, d] + b [d]) + head [d, 1]`` with a tanh
between layers: a cheap forward over many leaves of mixed shapes, so a step
costs what the bucketed wire costs.

Parameters are a dict from the reference's leaf names to tensors, in the
reference's flatten order (``jax.tree.flatten`` sorts dict keys):
``head, layer_00/b, layer_00/w, layer_01/b, ...``.  ``leaves()`` and
``init`` give that order, and the bucket layout depends on it; an
``nn.Module``'s ``named_parameters()`` comes in registration order instead.
``loss(params, batch) -> (mse, {"nll", "aux"})`` is the reference's
contract and takes the params dict, so ``torch.func`` can differentiate it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

Params = Dict[str, torch.Tensor]


class ToyMLP(nn.Module):
    def __init__(self, n_layers: int = 12, d: int = 64):
        super().__init__()
        self.n_layers, self.d = n_layers, d
        self.w = nn.ParameterList(
            [nn.Parameter(torch.zeros(d, d)) for _ in range(n_layers)])
        self.b = nn.ParameterList(
            [nn.Parameter(torch.zeros(d)) for _ in range(n_layers)])
        self.head = nn.Parameter(torch.zeros(d, 1))

    def names(self) -> Tuple[str, ...]:
        """Leaf names in the reference's flatten order."""
        return ("head",) + tuple(f"layer_{i:02d}/{k}"
                                 for i in range(self.n_layers)
                                 for k in ("b", "w"))

    def leaves(self) -> Params:
        """The module's parameters under the reference's names, in its
        flatten order."""
        out = {"head": self.head}
        for i in range(self.n_layers):
            out[f"layer_{i:02d}/b"] = self.b[i]
            out[f"layer_{i:02d}/w"] = self.w[i]
        return out

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> Params:
        """Draw fresh parameters from ``generator`` (on the module's
        device), load them into the module and return them as a detached
        params dict.  Layer weights come first, the head last, as the
        reference splits its key."""
        dev, d = self.head.device, self.d
        for i in range(self.n_layers):
            self.w[i].copy_(torch.randn(d, d, generator=generator,
                                        device=dev) / d ** 0.5)
            self.b[i].zero_()
        self.head.copy_(torch.randn(d, 1, generator=generator, device=dev)
                        / d ** 0.5)
        return {k: v.detach().clone() for k, v in self.leaves().items()}

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]):
        x = batch["x"]
        for i in range(self.n_layers):
            x = torch.tanh(x @ params[f"layer_{i:02d}/w"]
                           + params[f"layer_{i:02d}/b"])
        pred = x @ params["head"]
        mse = torch.mean(torch.square(pred - batch["y"]))
        return mse, {"nll": mse, "aux": torch.zeros((), device=mse.device)}

    def batch(self, generator: torch.Generator,
              n: int = 32) -> Dict[str, torch.Tensor]:
        """``n`` rows of the reference's regression target
        ``sum(sin(x[:, :4])) + 0.1 noise``, drawn from ``generator``."""
        dev = self.head.device
        x = torch.randn(n, self.d, generator=generator, device=dev)
        y = torch.sin(x[:, :4]).sum(-1, keepdim=True)
        y = y + 0.1 * torch.randn(n, 1, generator=generator, device=dev)
        return {"x": x, "y": y}
