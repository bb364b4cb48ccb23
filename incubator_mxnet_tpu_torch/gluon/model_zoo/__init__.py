"""Model zoo: the port of the JAX package's
``incubator_mxnet_tpu/gluon/model_zoo/``."""

from . import vision
from .vision import get_model

__all__ = ["vision", "get_model"]
