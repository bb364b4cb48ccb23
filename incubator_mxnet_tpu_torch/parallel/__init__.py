"""Training over devices in the PyTorch port: the single-device
``SPMDTrainer``."""

from .spmd import SPMDTrainer

__all__ = ["SPMDTrainer"]
