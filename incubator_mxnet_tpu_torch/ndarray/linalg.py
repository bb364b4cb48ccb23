"""``mx.nd.linalg``: the port of the JAX package's
``incubator_mxnet_tpu/ndarray/linalg.py``. Every op registered as
``linalg_X`` is ``nd.linalg.X``."""

from __future__ import annotations

import sys as _sys

from ..ops import registry as _registry
from .register import make_op_function

_THIS = _sys.modules[__name__]

for _name in _registry.list_all_names():
    if _name.startswith("linalg_"):
        _short = _name[len("linalg_"):]
        if not hasattr(_THIS, _short):
            setattr(_THIS, _short, make_op_function(_registry.get(_name),
                                                    _short))
