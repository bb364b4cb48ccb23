"""Base utilities of the PyTorch port: the framework's error type and
the environment readers.

``MXNetError`` mirrors the exception the reference surfaces through its
C ABI (``python/mxnet/base.py``); the JAX package keeps the same type.
``getenv_bool`` reads a knob under the ``MXTPU_`` namespace, falling back
to the reference's ``MXNET_`` spelling, as the JAX package's does.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["MXNetError", "getenv_bool"]

_ENV_PREFIXES = ("MXTPU_", "MXNET_")


class MXNetError(RuntimeError):
    """Default error thrown by framework functions."""


def _getenv_raw(name: str) -> Optional[str]:
    """``name`` itself, then ``MXTPU_<name>``, then ``MXNET_<name>``: the
    JAX package's lookup order."""
    for prefix in _ENV_PREFIXES:
        for candidate in (name, prefix + name):
            if candidate.startswith(prefix) or candidate == name:
                val = os.environ.get(candidate)
                if val is not None:
                    return val
    return None


def getenv_bool(name: str, default: bool = False) -> bool:
    """True for 1 / true / yes / on (any case), False for any other set
    value, ``default`` when unset."""
    val = _getenv_raw(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")
