"""Functional optimizers of the port."""
from repro_torch.optim.optimizers import Optimizer, adam, sgd

__all__ = ["Optimizer", "adam", "sgd"]
