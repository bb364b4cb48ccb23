"""``mx.sym.contrib``: the registry's ``_contrib_*`` ops under their
short names (the port of the JAX package's ``symbol/contrib.py``)."""

from __future__ import annotations

import sys as _sys

from ..ops import registry as _registry

_THIS = _sys.modules[__name__]

for _name in _registry.list_all_names():
    if _name.startswith("_contrib_"):
        _short = _name[len("_contrib_"):]
        if not hasattr(_THIS, _short):
            from . import _make_symbol_function
            setattr(_THIS, _short,
                    _make_symbol_function(_registry.get(_name).name, _short))
