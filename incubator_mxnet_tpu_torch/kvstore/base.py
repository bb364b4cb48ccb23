"""The kvstore type registry: the port of the JAX package's
``incubator_mxnet_tpu/kvstore/base.py`` (``KVStoreBase``, the MXNet >= 1.7
pluggable backend interface)."""

from __future__ import annotations

from typing import Dict

from ..base import MXNetError

_REGISTRY: Dict[str, type] = {}


def register(name, aliases=()):
    def deco(cls):
        for n in (name,) + tuple(aliases):
            _REGISTRY[n] = cls
        return cls
    return deco


def get(name):
    if name not in _REGISTRY:
        raise MXNetError(f"unknown kvstore type {name!r}")
    return _REGISTRY[name]


class KVStoreBase:
    """The backend interface: ``broadcast`` and ``pushpull``."""

    def broadcast(self, key, value, out):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        raise NotImplementedError

    @property
    def type(self):
        return type(self).__name__

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1
