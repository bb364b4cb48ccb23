"""Optimizers of the PyTorch port (the JAX package's registry), the
whole-tree application the trainers run (``apply_updates`` in
``parallel.SPMDTrainer``'s step, ``FusedApplier`` in gluon's Trainer),
and learning-rate schedulers."""

from . import lr_scheduler
from .fused import (FusedApplier, all_finite, apply_updates,
                    hyperparam_signature, norm_based)
from .lr_scheduler import LRScheduler
from .optimizer import (LAMB, LARS, NAG, SGD, SGLD, FTML, AdaDelta, AdaGrad,
                        Adam, Adamax, AdamW, DCASGD, Ftrl, Nadam, Optimizer,
                        RMSProp, Signum, Updater, create, get_updater,
                        register)

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "RMSProp", "Ftrl",
           "Signum", "LAMB", "LARS", "FTML", "AdaGrad", "AdaDelta",
           "Adamax", "Nadam", "DCASGD", "SGLD", "Updater", "get_updater",
           "create", "register", "apply_updates", "all_finite",
           "norm_based", "hyperparam_signature", "FusedApplier",
           "lr_scheduler", "LRScheduler"]
