"""Functional optimizers of the port."""
from repro_torch.optim.optimizers import Optimizer, adam, cosine_lr, sgd

__all__ = ["Optimizer", "adam", "cosine_lr", "sgd"]
