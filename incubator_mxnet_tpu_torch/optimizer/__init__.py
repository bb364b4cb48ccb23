"""Optimizers of the PyTorch port (SGD, Adam, LAMB), the whole-tree
application the trainer runs, and learning-rate schedulers."""

from . import lr_scheduler
from .fused import all_finite, apply_updates, norm_based
from .lr_scheduler import LRScheduler
from .optimizer import LAMB, SGD, Adam, Optimizer, create, register

__all__ = ["Optimizer", "SGD", "Adam", "LAMB", "create", "register",
           "apply_updates", "all_finite", "norm_based", "lr_scheduler",
           "LRScheduler"]
