"""The key-value store: the port of the JAX package's
``incubator_mxnet_tpu/kvstore/kvstore.py``.

``create("local")`` (``"device"``, ``"nccl"``, ``"horovod"`` and
``"byteps"`` are the same in-process store, as in the JAX registry) keeps
one value per key on the device of the value it was initialized with. ``push`` sums the arrays it is given (a list: one per device, as
MXNet's ``CommDevice`` reduces them) and, with an optimizer set on the
store (``set_optimizer``), applies the optimizer's update to the stored
weight with the sum as the gradient (MXNet's server-side update);
``pull`` copies the stored value into each output in place;
``pushpull`` is both with the sum itself as the value; ``broadcast`` is
``init`` then ``pull``. The optimizer's states save and load in the
JAX package's pickle layout, so either package reads the other's file.

``row_sparse_pull`` gathers only the requested rows of a stored table.

The ``dist_*`` types (``dist_sync``, ``dist_async``, ``dist_sync_device``,
``dist_async_device``) span the workers of a ``torch.distributed``
process group (``parallel.initialize``): ``rank`` and ``num_workers`` are
the group's, and a push or pushpull sums the workers' values through
``parallel.collectives.host_allreduce`` after the in-process sum. There
are no server processes: ``dist_async`` reduces synchronously, and the
store's optimizer runs on every worker after the reduction (the
reference's sync server update, the same numbers).
``set_gradient_compression({"type": "2bit", "threshold": t})`` ships
each worker's contribution as packed 2-bit codes with a per-key
error-feedback residual (``host_allreduce_2bit``; in one process the push
still quantizes), ``{"type": "bf16"}`` rounds each contribution to bf16
and sends bf16 across workers.
"""

from __future__ import annotations

import pickle
from typing import Dict

import torch

from ..base import MXNetError
from ..ndarray import NDArray
from . import base as _base

__all__ = ["KVStore", "create"]

_TYPES = ("local", "device", "nccl", "dist_sync", "dist_async",
          "dist_sync_device", "dist_async_device", "horovod", "byteps")


def _is_list(v) -> bool:
    return isinstance(v, (list, tuple))


def _tensor(v) -> torch.Tensor:
    return v._data if isinstance(v, NDArray) else v


class KVStore(_base.KVStoreBase):
    """A key-value store of one worker (parity: ``mx.kv.create``)."""

    def __init__(self, kv_type: str = "local"):
        from ..parallel import mesh as _mesh
        self._type = kv_type
        self._data: Dict = {}
        self._updater = None
        self._optimizer = None
        self._compression_params = None
        self._residuals: Dict = {}   # per-key 2-bit error feedback
        self._distributed = kv_type.startswith("dist")
        self._rank = _mesh.rank() if self._distributed else 0
        self._num_workers = _mesh.world_size() if self._distributed else 1

    @property
    def type(self) -> str:
        return self._type

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def num_workers(self) -> int:
        return self._num_workers

    # -- init / push / pull -------------------------------------------- #
    def init(self, key, value):
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            v0 = v[0] if _is_list(v) else v
            self._data[k] = NDArray(_tensor(v0).detach().clone())
            # a (re)initialized key starts a fresh compression stream
            self._residuals.pop(k, None)

    def _normalize(self, key, value):
        if _is_list(key):
            return list(key), list(value)
        return [key], [value]

    def _reduce(self, vals, key=None) -> NDArray:
        """The sum of the arrays (on the first one's device), then across
        the workers. Compression sits where the reference puts it: the
        in-process sum is exact, the worker hop compresses ('2bit': the
        key's residual carried to its next push; 'bf16': each
        contribution rounded to bf16)."""
        from ..parallel import collectives as _coll
        if not _is_list(vals):
            vals = [vals]
        params = self._compression_params
        ctype = (params or {}).get("type", "2bit")
        tensors = [_tensor(v).detach() for v in vals]
        if params is not None and ctype == "bf16":
            tensors = [t.to(torch.bfloat16).to(t.dtype) for t in tensors]
        total = tensors[0].clone()
        for t in tensors[1:]:
            total += t.to(total.device)
        if params is not None and ctype == "2bit":
            total, self._residuals[key] = _coll.host_allreduce_2bit(
                total, self._residuals.get(key),
                params.get("threshold", 0.5))
        elif self._distributed:
            total = _coll.host_allreduce(
                total, compression="bf16" if params is not None else None)
        return NDArray(total)

    def push(self, key, value, priority=0):
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            reduced = self._reduce(v, key=k)
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
            self._copy_into(o, self._reduce(v, key=k)._data)

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
        """'2bit' (packed codes with an error-feedback residual a key) or
        'bf16' (bf16 contributions); a new setting starts every key's
        stream afresh."""
        params = dict(compression_params)
        ctype = params.get("type", "2bit")
        if ctype not in ("2bit", "bf16"):
            raise MXNetError(
                f"unsupported gradient compression type {ctype!r}; "
                f"supported: '2bit' (packed 2-bit codes + error-feedback "
                f"residual on the worker hop), 'bf16' (bf16 contributions)")
        self._compression_params = params
        self._residuals.clear()

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
        """Every queued device write to the stored values done, then (a
        ``dist_*`` store) every worker here (reference: ps-lite
        ``Barrier``)."""
        for v in self._data.values():
            if v._data.is_cuda:
                torch.cuda.synchronize(v._data.device)
                break
        if self._distributed:
            from ..parallel.collectives import host_barrier
            host_barrier()

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


for _t in _TYPES:
    _base.register(_t)(KVStore)


def create(name: str = "local") -> KVStore:
    """A KVStore (parity: ``mx.kv.create``); every reference type string
    is accepted (see the module's docstring)."""
    if not isinstance(name, str):
        raise MXNetError("kvstore name must be a string")
    return _base.get(name)(name)
