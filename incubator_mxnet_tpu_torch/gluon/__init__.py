"""Gluon: the port of the JAX package's ``incubator_mxnet_tpu/gluon/``
(``Parameter``, ``Block`` / ``HybridBlock``, ``nn``, ``loss`` and
``Trainer``)."""

from . import parameter
from .parameter import Parameter, ParameterDict, Constant
from . import block
from .block import Block, HybridBlock, SymbolBlock
from . import loss
from . import nn
from . import trainer
from .trainer import Trainer

__all__ = ["Parameter", "ParameterDict", "Constant", "Block", "HybridBlock",
           "SymbolBlock", "Trainer", "loss", "nn"]
