"""``mx.contrib``: the port of the JAX package's
``incubator_mxnet_tpu/contrib/`` (parity: python/mxnet/contrib/).
It holds post-training int8 quantization (``quantization``,
``quantize_net``); ``onnx``, ``svrg`` and ``text`` are not ported yet
(ROADMAP Queue 1 item 13)."""

from . import quantization
from .quantization import quantize_net

__all__ = ["quantization", "quantize_net"]
