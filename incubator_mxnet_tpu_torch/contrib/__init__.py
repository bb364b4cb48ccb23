"""``mx.contrib``: the port of the JAX package's
``incubator_mxnet_tpu/contrib/`` (parity: python/mxnet/contrib/):
post-training int8 quantization (``quantization``, ``quantize_net``),
ONNX export and import (``onnx``, over a vendored wire-format layer, so
no ``onnx`` wheel is needed), token vocabularies and embeddings
(``text``) and the SVRG module (``SVRGModule``)."""

from . import quantization
from . import onnx
from . import text
from .quantization import quantize_net
from .svrg import SVRGModule

__all__ = ["quantization", "quantize_net", "onnx", "text", "SVRGModule"]
