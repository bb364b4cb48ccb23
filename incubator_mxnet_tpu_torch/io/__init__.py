"""Data iterators: the port of the JAX package's
``incubator_mxnet_tpu/io/__init__.py`` (``DataDesc``, ``DataBatch``,
``DataIter``, ``NDArrayIter``, ``CSVIter``, ``ResizeIter``,
``PrefetchingIter``).

Batches stay where the data lies: arrays given as numpy (or lists) are
held on the host, so a batch is a host ``NDArray`` until ``Module``
copies it into its bound arrays on the device. Every iterator exports
its position (``tell`` / ``set_position``) for the checkpoint capsule. A
shuffled ``NDArrayIter`` draws each epoch's seed from ``mx.random``'s
host stream (``np_rng``), where the JAX package draws it from its
threefry key, so a shuffled epoch is another permutation in each
package; unshuffled batches are equal.

``ImageRecordIter``, ``ImageDetRecordIter``, ``MNISTIter`` and
``LibSVMIter`` raise ``MXNetError``: the record and image readers and
sparse inputs are not ported.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time
from typing import List

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "ImageRecordIter", "ImageDetRecordIter",
           "MNISTIter", "ResizeIter", "PrefetchingIter"]


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape", "dtype",
                                                   "layout"])):
    def __new__(cls, name, shape, dtype="float32", layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)


class DataBatch:
    """(parity: ``mx.io.DataBatch``)"""

    def __init__(self, data, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None, bucket_key=None):
        self.data = data if isinstance(data, (list, tuple)) else [data]
        self.label = label if label is None or isinstance(
            label, (list, tuple)) else [label]
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label
        if bucket_key is not None:      # BucketingModule's routing
            self.bucket_key = bucket_key


class DataIter:
    """An epoch-based iterator (parity: ``mx.io.DataIter``) with the
    position contract of the checkpoint capsule: ``tell()`` returns a
    JSON-able dict and ``set_position(state)`` restores it, so a resumed
    run replays the same remaining batches."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def tell(self) -> dict:
        raise MXNetError(
            f"{type(self).__name__} does not support position export; "
            f"wrap data in NDArrayIter or add tell()/set_position()")

    def set_position(self, state: dict):
        raise MXNetError(
            f"{type(self).__name__} does not support position restore")

    def __next__(self):
        return self.next()

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _draw_shuffle_seed() -> int:
    """One int from ``mx.random``'s host stream: the epoch's order is a
    function of it, so ``tell()`` carries the order in O(1)."""
    from .. import random as _random
    return int(_random.np_rng().randint(0, 0x7FFFFFFF))


def _to_nd_list(arrs) -> List[NDArray]:
    """NDArrays stay where they lie; anything else goes to the host
    (float64 / int64 entering as float32 / int32)."""
    from ..ndarray import array
    if arrs is None:
        return []
    if isinstance(arrs, (np.ndarray, NDArray)):
        arrs = [arrs]
    if isinstance(arrs, dict):
        arrs = list(arrs.values())
    return [a if isinstance(a, NDArray) else array(a, ctx="cpu")
            for a in arrs]


class NDArrayIter(DataIter):
    """Batches over in-memory arrays (parity: ``mx.io.NDArrayIter``),
    with ``last_batch_handle`` "pad", "discard" or "roll_over"."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError(
                f"last_batch_handle {last_batch_handle!r}: expected "
                f"'pad', 'discard' or 'roll_over'")
        self._data = _to_nd_list(data)
        self._label = _to_nd_list(label)
        self._names = [data_name] if len(self._data) == 1 else \
            [f"{data_name}{i}" for i in range(len(self._data))]
        self._label_names = [label_name] if len(self._label) == 1 else \
            [f"{label_name}{i}" for i in range(len(self._label))]
        self._shuffle = shuffle
        self._last = last_batch_handle
        self.num_data = self._data[0].shape[0] if self._data else 0
        self._order = np.arange(self.num_data)
        self._shuffle_seed = None
        self._cursor = -batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(n, (self.batch_size,) + d.shape[1:], str(d.dtype))
                for n, d in zip(self._names, self._data)]

    @property
    def provide_label(self):
        return [DataDesc(n, (self.batch_size,) + d.shape[1:], str(d.dtype))
                for n, d in zip(self._label_names, self._label)]

    def _shuffled(self, seed: int):
        self._shuffle_seed = seed
        self._order = np.arange(self.num_data)
        np.random.RandomState(seed).shuffle(self._order)

    def reset(self):
        if self._shuffle:
            self._shuffled(_draw_shuffle_seed())
        # roll_over: a short tail is not emitted at the epoch's end; its
        # samples lead the next epoch's first batch
        leftover = self.num_data - self._cursor
        if self._last == "roll_over" and 0 < leftover < self.batch_size:
            self._cursor = -leftover - self.batch_size
        else:
            self._cursor = -self.batch_size

    def iter_next(self):
        self._cursor += self.batch_size
        if self._last in ("discard", "roll_over"):
            return self._cursor + self.batch_size <= self.num_data
        return self._cursor < self.num_data

    def _slice(self, arrs):
        start = max(self._cursor, 0)
        end = min(self._cursor + self.batch_size, self.num_data)
        idx = self._order[start:end]
        if self._cursor < 0:            # roll_over: last epoch's tail first
            idx = np.concatenate([self._order[self._cursor:], idx])
        pad = self.batch_size - len(idx)
        if pad > 0 and self._last == "pad":
            idx = np.concatenate([idx, self._order[:pad]])
        if len(idx) and (np.diff(idx) == 1).all():
            # in order: a slice of the arrays (a view, as MXNet's is)
            return [NDArray(a._data[int(idx[0]):int(idx[-1]) + 1])
                    for a in arrs]
        out = []
        for a in arrs:
            t = torch.as_tensor(idx, dtype=torch.long, device=a._data.device)
            out.append(NDArray(a._data.index_select(0, t)))
        return out

    def getdata(self):
        return self._slice(self._data)

    def getlabel(self):
        return self._slice(self._label)

    def getpad(self):
        end = self._cursor + self.batch_size
        if self._last == "pad" and end > self.num_data:
            return end - self.num_data
        return 0

    def tell(self) -> dict:
        return {"cursor": int(self._cursor), "num_data": self.num_data,
                "shuffle_seed": self._shuffle_seed}

    def set_position(self, state: dict):
        if state.get("num_data") is not None and \
                int(state["num_data"]) != self.num_data:
            raise MXNetError(
                f"iterator position is for {state['num_data']} samples, "
                f"this iterator has {self.num_data}")
        if state.get("shuffle_seed") is not None:
            self._shuffled(int(state["shuffle_seed"]))
        self._cursor = int(state["cursor"])


class CSVIter(DataIter):
    """Batches from CSV files (parity: ``mx.io.CSVIter``); a missing
    label file gives zero labels."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
        else:
            label = np.zeros((data.shape[0], 1), np.float32)
        self._inner = NDArrayIter(
            data, label, batch_size,
            last_batch_handle="pad" if round_batch else "discard")

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()

    def tell(self) -> dict:
        return self._inner.tell()

    def set_position(self, state: dict):
        self._inner.set_position(state)


def _not_ported(name, what):
    def refuse(*args, **kwargs):
        raise MXNetError(f"mx.io.{name}: {what} is not ported (ROADMAP "
                         f"Queue 1 item 13)")
    refuse.__name__ = name
    return refuse


LibSVMIter = _not_ported("LibSVMIter", "sparse (CSR) input")
ImageRecordIter = _not_ported("ImageRecordIter", "the RecordIO image reader")
ImageDetRecordIter = _not_ported("ImageDetRecordIter",
                                 "the RecordIO detection reader")
MNISTIter = _not_ported("MNISTIter", "the MNIST file reader")


class ResizeIter(DataIter):
    """An iterator cut or extended to ``size`` batches a epoch (parity:
    ``mx.io.ResizeIter``)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self._iter = data_iter
        self._size = size
        self._reset_internal = reset_internal
        self._cur = 0

    def reset(self):
        self._cur = 0
        if self._reset_internal:
            self._iter.reset()

    def next(self):
        if self._cur >= self._size:
            raise StopIteration
        self._cur += 1
        try:
            return self._iter.next()
        except StopIteration:
            self._iter.reset()
            return self._iter.next()

    def tell(self) -> dict:
        return {"cur": int(self._cur), "inner": self._iter.tell()}

    def set_position(self, state: dict):
        self._cur = int(state["cur"])
        if state.get("inner") is not None:
            self._iter.set_position(state["inner"])


def _env_float(name, default):
    return float(os.environ.get(name, "") or default)


class PrefetchingIter(DataIter):
    """Reads the inner iterator ahead on a thread (parity:
    ``mx.io.PrefetchingIter``).

    The position is the number of batches delivered: ``set_position``
    restores the inner iterator's epoch start and replays that many
    batches before the thread starts again. Any error of the thread
    (``BaseException`` included, and its silent death) reaches the
    consumer. A transient read error (``OSError``) is retried with
    doubling backoff (``MXTPU_IO_RETRY_ATTEMPTS``, default 3 attempts;
    ``MXTPU_IO_RETRY_BACKOFF``, default 0.05 s) before it propagates;
    ``MXTPU_IO_FAIL_READS=n`` injects n transient failures. ``reset``
    waits at most ``MXTPU_IO_JOIN_TIMEOUT`` (default 30 s) for the thread
    to stop."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        it = iters[0] if isinstance(iters, (list, tuple)) else iters
        super().__init__(it.batch_size)
        self._iter = it
        self._queue: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = object()
        self._thread = None
        self._cancel = None
        self._exhausted = False
        self._delivered = 0
        self._lock = threading.Lock()
        self.read_retries = 0
        self._injected_failures = 0
        self._epoch_start = self._try_tell()
        self._start()

    def _try_tell(self):
        try:
            return self._iter.tell()
        except MXNetError:
            return None

    def _maybe_inject_read_failure(self):
        budget = int(os.environ.get("MXTPU_IO_FAIL_READS", "0") or 0)
        with self._lock:
            if self._injected_failures >= budget:
                return
            self._injected_failures += 1
            count = self._injected_failures
        raise OSError(f"injected transient data-iterator read failure "
                      f"({count}/{budget})")

    def _next_inner(self):
        attempts = max(1, int(os.environ.get("MXTPU_IO_RETRY_ATTEMPTS", "3")
                              or 3))
        backoff = _env_float("MXTPU_IO_RETRY_BACKOFF", 0.05)
        for attempt in range(attempts):
            try:
                self._maybe_inject_read_failure()
                return self._iter.next()
            except StopIteration:
                raise
            except OSError:
                if attempt + 1 >= attempts:
                    raise
                with self._lock:
                    self.read_retries += 1
                if self._cancel.wait(backoff * (2 ** attempt)):
                    raise

    def _safe_put(self, item, cancel) -> bool:
        while not cancel.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _start(self):
        cancel = threading.Event()

        def run():
            while not cancel.is_set():
                try:
                    batch = self._next_inner()
                except StopIteration:
                    break
                except BaseException as e:   # noqa: B036 (every death)
                    self._safe_put(e, cancel)
                    self._safe_put(self._stop, cancel)
                    return
                if not self._safe_put(batch, cancel):
                    return
            self._safe_put(self._stop, cancel)

        self._cancel = cancel
        self._exhausted = False
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _stop_producer(self):
        self._cancel.set()
        limit = _env_float("MXTPU_IO_JOIN_TIMEOUT", 30)
        deadline = time.monotonic() + limit
        while self._thread.is_alive():
            if time.monotonic() > deadline:
                raise MXNetError(
                    f"PrefetchingIter producer thread did not stop within "
                    f"{limit:g} s (MXTPU_IO_JOIN_TIMEOUT) — inner iterator "
                    f"wedged; cannot safely reuse it")
            try:
                self._queue.get(timeout=0.1)
            except queue.Empty:
                pass
        self._thread.join()
        while not self._queue.empty():
            self._queue.get_nowait()

    def reset(self):
        self._stop_producer()
        self._iter.reset()
        self._delivered = 0
        self._epoch_start = self._try_tell()
        self._start()

    def next(self):
        if self._exhausted:
            raise StopIteration
        while True:
            try:
                item = self._queue.get(timeout=0.2)
                break
            except queue.Empty:
                if self._thread is not None and self._thread.is_alive():
                    continue
                try:                 # died after a final put: drain it
                    item = self._queue.get_nowait()
                    break
                except queue.Empty:
                    self._exhausted = True
                    raise MXNetError(
                        "PrefetchingIter producer thread died without "
                        "delivering a batch, an error, or end-of-stream "
                        "— propagating instead of hanging the consumer")
        if item is self._stop:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._exhausted = True
            raise item
        self._delivered += 1
        return item

    def tell(self) -> dict:
        if self._epoch_start is None:
            raise MXNetError(
                f"PrefetchingIter over {type(self._iter).__name__} is not "
                f"resumable: the inner iterator does not support tell()")
        return {"delivered": int(self._delivered),
                "epoch_start": self._epoch_start}

    def set_position(self, state: dict):
        n = int(state["delivered"])
        self._stop_producer()
        self._iter.set_position(state["epoch_start"])
        self._epoch_start = state["epoch_start"]
        for _ in range(n):
            try:
                self._iter.next()
            except StopIteration:
                raise MXNetError(
                    f"cannot restore PrefetchingIter position {n}: inner "
                    f"iterator exhausted early") from None
        self._delivered = n
        self._exhausted = False
        self._start()
