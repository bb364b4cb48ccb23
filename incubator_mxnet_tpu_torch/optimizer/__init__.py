"""Optimizers of the PyTorch port (SGD, Adam, LAMB) and the whole-tree
application the trainer runs."""

from .fused import all_finite, apply_updates, norm_based
from .optimizer import LAMB, SGD, Adam, Optimizer, create, register

__all__ = ["Optimizer", "SGD", "Adam", "LAMB", "create", "register",
           "apply_updates", "all_finite", "norm_based"]
