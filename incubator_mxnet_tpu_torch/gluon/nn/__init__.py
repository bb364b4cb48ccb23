"""Neural-network layers: the port of the JAX package's
``incubator_mxnet_tpu/gluon/nn/`` basic layers and activations (the
convolution and pooling layers are not ported yet)."""

from .basic_layers import (Sequential, HybridSequential, Dense, Dropout,
                           Embedding, BatchNorm, LayerNorm, InstanceNorm,
                           GroupNorm, Flatten, Lambda, HybridLambda, Identity)
from .activations import (Activation, LeakyReLU, PReLU, ELU, SELU, Swish,
                          GELU)
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "LayerNorm", "InstanceNorm", "GroupNorm", "Flatten",
           "Lambda", "HybridLambda", "Identity", "Activation", "LeakyReLU",
           "PReLU", "ELU", "SELU", "Swish", "GELU", "Block", "HybridBlock",
           "SymbolBlock"]
