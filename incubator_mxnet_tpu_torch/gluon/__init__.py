"""Gluon: the port of the JAX package's ``incubator_mxnet_tpu/gluon/``
(``Parameter``, ``Block`` / ``HybridBlock``, ``nn``, ``loss``,
``Trainer`` and ``utils``; ``data``, ``rnn``, ``model_zoo`` and
``contrib`` load on first use)."""

from . import parameter
from .parameter import Parameter, ParameterDict, Constant
from . import block
from .block import Block, HybridBlock, SymbolBlock
from . import loss
from . import nn
from . import trainer
from .trainer import Trainer
from . import utils
from .utils import split_and_load

__all__ = ["Parameter", "ParameterDict", "Constant", "Block", "HybridBlock",
           "SymbolBlock", "Trainer", "loss", "nn", "split_and_load"]


def __getattr__(name):
    if name in ("data", "rnn", "model_zoo", "contrib"):
        import importlib
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
