"""``mx.nd.contrib``: the port of the JAX package's
``incubator_mxnet_tpu/ndarray/contrib.py``. Every op registered as
``_contrib_X`` is ``nd.contrib.X``; ``foreach`` / ``while_loop`` /
``cond`` are the eager control flow of ``ops.control_flow``."""

from __future__ import annotations

import sys as _sys

from ..ops import registry as _registry
from ..ops.control_flow import cond, foreach, while_loop  # noqa: F401
from .register import make_op_function

_THIS = _sys.modules[__name__]

for _name in _registry.list_all_names():
    if _name.startswith("_contrib_"):
        _short = _name[len("_contrib_"):]
        if not hasattr(_THIS, _short):
            setattr(_THIS, _short, make_op_function(_registry.get(_name),
                                                    _short))
