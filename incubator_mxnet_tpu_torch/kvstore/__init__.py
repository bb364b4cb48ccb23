"""``mx.kv``: the key-value store of parameter synchronization (the port
of the JAX package's ``incubator_mxnet_tpu/kvstore``)."""

from .base import KVStoreBase, register
from .kvstore import KVStore, create

__all__ = ["KVStoreBase", "KVStore", "create", "register"]
