"""``gluon.contrib``: the port of the JAX package's
``incubator_mxnet_tpu/gluon/contrib/`` (parity:
python/mxnet/gluon/contrib/)."""

from . import nn
from . import rnn
from . import estimator
from .estimator import Estimator

__all__ = ["nn", "rnn", "estimator", "Estimator"]
