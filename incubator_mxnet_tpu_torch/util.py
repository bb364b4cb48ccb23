"""Utility helpers: the port of the JAX package's
``incubator_mxnet_tpu/util.py`` (parity: ``python/mxnet/util.py``): the
``environment()`` context manager for scoped environment-variable
overrides, ``getenv`` / ``setenv``, and the numpy-semantics flags
(``set_np``, ``reset_np``, ``np_array``, ``np_shape``, ``use_np``,
``is_np_array``, ``is_np_shape``), which ``mx.npx`` re-exports."""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Optional, Union

__all__ = ["environment", "getenv", "setenv", "set_np", "reset_np",
           "is_np_array", "is_np_shape", "set_np_shape", "use_np",
           "np_array", "np_shape"]


@contextmanager
def environment(*args):
    """Scoped environment-variable override.

    ``environment(name, value)`` or ``environment({name: value, ...})``;
    value ``None`` unsets. Parity: ``mx.util.environment`` (MXNet flips
    its ``MXNET_*`` knobs per test with it; the port reads ``MXTPU_*``
    first).
    """
    if len(args) == 1 and isinstance(args[0], dict):
        overrides = args[0]
    elif len(args) == 2:
        overrides = {args[0]: args[1]}
    else:
        raise ValueError("environment() takes (name, value) or a dict")
    saved = {k: os.environ.get(k) for k in overrides}
    try:
        for k, v in overrides.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, old in saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old


def getenv(name: str) -> Optional[str]:
    """Parity: ``mx.util.getenv`` (backed by `MXGetEnv` in the reference)."""
    return os.environ.get(name)


def setenv(name: str, value: Optional[str]) -> None:
    """Parity: ``mx.util.setenv``."""
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


# --- numpy-semantics switches (reference: mx.util.set_np / npx.set_np) -----

_np_state = threading.local()


def is_np_array() -> bool:
    """True when ``mx.np`` array semantics are active (parity:
    `python/mxnet/util.py` is_np_array)."""
    return getattr(_np_state, "array", False)


def is_np_shape() -> bool:
    """True when numpy shape semantics (0-dim/0-size arrays) are active."""
    return getattr(_np_state, "shape", False)


def set_np_shape(active: bool) -> bool:
    prev = is_np_shape()
    _np_state.shape = bool(active)
    return prev


def set_np(shape: bool = True, array: bool = True) -> None:
    """Activate numpy semantics (parity: ``mx.npx.set_np``): the flags
    only."""
    if array and not shape:
        raise ValueError("array semantics require shape semantics")
    _np_state.array = bool(array)
    _np_state.shape = bool(shape)


def reset_np() -> None:
    """Parity: ``mx.npx.reset_np``."""
    set_np(shape=False, array=False)


@contextmanager
def np_array(active: bool = True):
    prev = is_np_array()
    _np_state.array = bool(active)
    try:
        yield
    finally:
        _np_state.array = prev


@contextmanager
def np_shape(active: bool = True):
    prev = set_np_shape(active)
    try:
        yield
    finally:
        set_np_shape(prev)


def use_np(func):
    """Decorator parity for ``mx.util.use_np``: run ``func`` under numpy
    array+shape semantics."""
    import functools

    @functools.wraps(func)
    def _wrapped(*args, **kwargs):
        with np_shape(True), np_array(True):
            return func(*args, **kwargs)

    return _wrapped
