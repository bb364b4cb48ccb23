"""The local key-value store: the port of the JAX package's
``incubator_mxnet_tpu/kvstore/kvstore.py`` for one worker.

``create("local")`` (``"device"`` and ``"nccl"`` are the same store here)
keeps one value per key on the device of the value it was initialized
with. ``push`` sums the arrays it is given (a list: one per device, as
MXNet's ``CommDevice`` reduces them) and, with an optimizer set on the
store (``set_optimizer``), applies the optimizer's update to the stored
weight with the sum as the gradient (MXNet's server-side update);
``pull`` copies the stored value into each output in place;
``pushpull`` is both with the sum itself as the value; ``broadcast`` is
``init`` then ``pull``. The optimizer's states save and load in the
JAX package's pickle layout, so either package reads the other's file.

``row_sparse_pull`` gathers only the requested rows of a stored table.

Not ported, and refused with ``MXNetError``: the ``dist_*`` types,
``horovod`` / ``byteps`` and gradient compression (ROADMAP Queue 1 item
11).
"""

from __future__ import annotations

import pickle
from typing import Dict

import torch

from ..base import MXNetError
from ..ndarray import NDArray
from . import base as _base

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "device", "nccl")
_MULTI = ("dist_sync", "dist_async", "dist_sync_device", "dist_async_device",
          "horovod", "byteps")


def _is_list(v) -> bool:
    return isinstance(v, (list, tuple))


def _tensor(v) -> torch.Tensor:
    return v._data if isinstance(v, NDArray) else v


class KVStore(_base.KVStoreBase):
    """A key-value store of one worker (parity: ``mx.kv.create``)."""

    def __init__(self, kv_type: str = "local"):
        if kv_type in _MULTI:
            raise MXNetError(
                f"kvstore {kv_type!r}: several workers are not ported "
                f"(ROADMAP Queue 1 item 11); 'local' and 'device' run on "
                f"one worker")
        self._type = kv_type
        self._data: Dict = {}
        self._updater = None
        self._optimizer = None

    @property
    def type(self) -> str:
        return self._type

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    # -- init / push / pull -------------------------------------------- #
    def init(self, key, value):
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            v0 = v[0] if _is_list(v) else v
            self._data[k] = NDArray(_tensor(v0).detach().clone())

    def _normalize(self, key, value):
        if _is_list(key):
            return list(key), list(value)
        return [key], [value]

    def _reduce(self, vals) -> NDArray:
        """The sum of the arrays (on the first one's device)."""
        if not _is_list(vals):
            vals = [vals]
        first = _tensor(vals[0]).detach()
        total = first.clone()
        for v in vals[1:]:
            total += _tensor(v).detach().to(first.device)
        return NDArray(total)

    def push(self, key, value, priority=0):
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            reduced = self._reduce(v)
            if k not in self._data:
                self._data[k] = reduced
            elif self._updater is not None:
                # the server-side optimizer: the stored weight takes the
                # update with the sum as its gradient
                self._updater(self._str_or_int(k), reduced, self._data[k])
            else:
                self._data[k] = reduced

    @staticmethod
    def _copy_into(targets, src: torch.Tensor):
        with torch.no_grad():
            for t in targets if _is_list(targets) else [targets]:
                t._data.copy_(src)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = self._normalize(key, out)
        for k, o in zip(keys, outs):
            if k not in self._data:
                raise MXNetError(f"key {k} not initialized in kvstore")
            self._copy_into(o, self._data[k]._data)

    def pushpull(self, key, value, out=None, priority=0):
        """Push and pull in one call (the MXNet >= 1.7 contract): each
        output takes the sum."""
        keys, values = self._normalize(key, value)
        _, outs = self._normalize(key, out if out is not None else value)
        for k, v, o in zip(keys, values, outs):
            self._copy_into(o, self._reduce(v)._data)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out=out, priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the requested rows (the sparse embedding flow): the
        row ids are deduplicated and sorted, the gather clips ids past
        the table to its last row, and each output is written in place.
        A ``RowSparseNDArray`` output takes the rows as its compact parts
        (its dense mirror rewritten in place); a dense output is zero
        outside the rows. Without ``row_ids`` this is ``pull``."""
        if row_ids is None:
            return self.pull(key, out=out, priority=priority)
        from ..ndarray.sparse import RowSparseNDArray
        keys, outs = self._normalize(key, out)
        rids = row_ids if _is_list(row_ids) else [row_ids] * len(keys)
        for k, o, r in zip(keys, outs, rids):
            if k not in self._data:
                raise MXNetError(f"key {k} not initialized in kvstore")
            src = self._data[k]._data
            n = src.shape[0]
            ids = torch.unique(_tensor(r).detach().to(torch.int64)
                               .to(src.device))
            gathered = src.index_select(0, ids.clamp(0, n - 1))
            # the mirror keeps the rows inside the table
            keep = (ids >= 0) & (ids < n)
            with torch.no_grad():
                for t in o if _is_list(o) else [o]:
                    rows = gathered.to(t._data.dtype)
                    if isinstance(t, RowSparseNDArray):
                        t._sp_indices = ids.to(torch.int32)
                        t._sp_values = rows
                    t._data.zero_()
                    t._data[ids[keep]] = rows[keep]

    def set_gradient_compression(self, compression_params):
        raise MXNetError("KVStore.set_gradient_compression: gradient "
                         "compression is not ported (ROADMAP Queue 1 "
                         "item 11)")

    # -- optimizer ------------------------------------------------------ #
    def set_optimizer(self, optimizer):
        """Apply ``optimizer`` on the store at each push (MXNet ships it
        pickled to the servers; the round trip here checks that it
        pickles)."""
        from .. import optimizer as opt_mod
        optimizer = pickle.loads(pickle.dumps(optimizer))
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)

    @staticmethod
    def _str_or_int(k):
        try:
            return int(k)
        except (TypeError, ValueError):
            return k

    def barrier(self):
        """Every queued device write to the stored values done."""
        for v in self._data.values():
            if v._data.is_cuda:
                torch.cuda.synchronize(v._data.device)
                return

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        payload = self._updater.get_states()
        if dump_optimizer:
            data = pickle.loads(payload)
            data["optimizer"] = self._optimizer
            payload = pickle.dumps(data)
        with open(fname, "wb") as f:
            f.write(payload)

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "rb") as f:
            payload = f.read()
        device = next((v._data.device for v in self._data.values()), "cpu")
        self._updater.set_states(payload, device=device)


for _t in _LOCAL + _MULTI:
    _base.register(_t)(KVStore)


def create(name: str = "local") -> KVStore:
    """A KVStore (parity: ``mx.kv.create``): ``local``, ``device`` or
    ``nccl``; the multi-worker types raise ``MXNetError``."""
    if not isinstance(name, str):
        raise MXNetError("kvstore name must be a string")
    return _base.get(name)(name)
