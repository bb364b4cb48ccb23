"""Base utilities of the PyTorch port: the framework's error type.

``MXNetError`` mirrors the exception the reference surfaces through its
C ABI (``python/mxnet/base.py``); the JAX package keeps the same type.
"""

from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Default error thrown by framework functions."""
