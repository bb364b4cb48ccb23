"""Neural-network layers: the port of the JAX package's
``incubator_mxnet_tpu/gluon/nn/``: basic layers, activations, and the
convolution and pooling layers."""

from .basic_layers import (Sequential, HybridSequential, Dense, Dropout,
                           Embedding, BatchNorm, LayerNorm, InstanceNorm,
                           GroupNorm, Flatten, Lambda, HybridLambda, Identity)
from .activations import (Activation, LeakyReLU, PReLU, ELU, SELU, Swish,
                          GELU)
from .conv_layers import (Conv1D, Conv2D, Conv3D, Conv1DTranspose,
                          Conv2DTranspose, Conv3DTranspose, MaxPool1D,
                          MaxPool2D, MaxPool3D, AvgPool1D, AvgPool2D,
                          AvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, ReflectionPad2D)
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "LayerNorm", "InstanceNorm", "GroupNorm", "Flatten",
           "Lambda", "HybridLambda", "Identity", "Activation", "LeakyReLU",
           "PReLU", "ELU", "SELU", "Swish", "GELU", "Block", "HybridBlock",
           "SymbolBlock", "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]
