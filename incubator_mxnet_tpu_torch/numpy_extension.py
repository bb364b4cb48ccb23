"""``mx.npx``: the NumPy-extension namespace, the port of the JAX
package's ``incubator_mxnet_tpu/numpy_extension.py``.

MXNet's ``npx`` holds the neural-network operators NumPy has no name
for (``relu``, ``softmax``, ``batch_norm``, ``convolution``, ...) and the
NumPy-semantics switches. ``npx.<name>`` is ``mx.nd.<name>``; a
snake_case name without a registry spelling of its own is looked up in
CamelCase (``npx.batch_norm`` is ``nd.BatchNorm``, through
``_IRREGULAR_CAMEL`` where the capitalization is not regular). It
re-exports the ``util`` flags (``set_np``, ``reset_np``, ``use_np``,
...), ``waitall`` and the context names.
"""

from __future__ import annotations

from . import ndarray as _nd
from .context import cpu, current_context, gpu, num_gpus, tpu
from .util import (is_np_array, is_np_shape, np_array, np_shape, reset_np,
                   set_np, set_np_shape, use_np)

__all__ = ["set_np", "reset_np", "set_np_shape", "is_np_array",
           "is_np_shape", "use_np", "np_array", "np_shape", "waitall",
           "cpu", "gpu", "tpu", "num_gpus", "current_context"]


def waitall():
    """Parity: ``mx.npx.waitall``: every queued device operation done."""
    from .engine import wait_all
    wait_all()


# snake_case names whose registry spelling has irregular capitalization
_IRREGULAR_CAMEL = {
    "leaky_relu": "LeakyReLU", "lrn": "LRN", "rnn": "RNN",
    "roi_pooling": "ROIPooling", "roi_align": "ROIAlign",
    "ctc_loss": "CTCLoss", "l2_normalization": "L2Normalization",
    "svm_output": "SVMOutput",
}


def __getattr__(name: str):
    attr = getattr(_nd, name, None)
    if attr is not None:
        return attr
    camel = _IRREGULAR_CAMEL.get(
        name, "".join(p.capitalize() for p in name.split("_")))
    attr = getattr(_nd, camel, None)
    if attr is not None:
        return attr
    raise AttributeError(f"mx.npx has no attribute {name!r}")
