"""The execution engine's control surface: the port of the JAX package's
``incubator_mxnet_tpu/engine.py``.

MXNet's dependency engine is PyTorch's CUDA stream here: an op returns
once its kernels are queued. What stays user-visible is the engine's
control surface:

  - ``set_sync(True)`` (or ``MXTPU_ENGINE_TYPE=NaiveEngine``, MXNet's
    ``MXNET_ENGINE_TYPE=NaiveEngine``): every imperative op waits for its
    device before it returns, so an asynchronous CUDA error surfaces at
    the op that caused it;
  - ``wait_all`` (``mx.nd.waitall``): wait for every queued device
    computation (``torch.cuda.synchronize`` on the card);
  - ``set_bulk_size`` / ``bulk``: MXNet's op bulking knobs, kept for the
    API. A captured CUDA graph (gluon's fused applier, the Executor, the
    step programs) is the port's bulking, so they only track the size.
"""

from __future__ import annotations

import threading

import torch

from .base import _getenv_raw

__all__ = ["set_sync", "is_sync", "wait_all", "set_bulk_size", "bulk"]

_state = threading.local()
_DEFAULT_SYNC = (_getenv_raw("MXTPU_ENGINE_TYPE") or "").lower() == \
    "naiveengine"


def is_sync() -> bool:
    """True when the synchronous (NaiveEngine) mode is on."""
    return getattr(_state, "sync", _DEFAULT_SYNC)


def set_sync(sync: bool = True) -> bool:
    """Turn synchronous execution on or off; returns the previous
    setting."""
    prev = is_sync()
    _state.sync = bool(sync)
    return prev


def _maybe_sync(outputs):
    """Wait for the device of each CUDA output (the imperative front end
    calls this after each op in sync mode)."""
    for o in outputs:
        t = getattr(o, "_data", o)
        if torch.is_tensor(t) and t.is_cuda:
            torch.cuda.synchronize(t.device)


def wait_all() -> None:
    """Block until every queued device computation is done (parity:
    ``Engine::WaitForAll``)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


_bulk_size = 0


def set_bulk_size(size: int) -> int:
    """Record the op bulking size (parity:
    ``MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN``); returns the previous one."""
    global _bulk_size
    prev, _bulk_size = _bulk_size, int(size)
    return prev


class bulk:
    """``with mx.engine.bulk(size):`` (parity); tracks the size only."""

    def __init__(self, size: int):
        self._size = size
        self._prev = None

    def __enter__(self):
        self._prev = set_bulk_size(self._size)
        return self

    def __exit__(self, *exc):
        set_bulk_size(self._prev)
