"""Mixed precision of the PyTorch port: the dynamic loss scaler."""

from .loss_scaler import LossScaler

__all__ = ["LossScaler"]
