"""DataLoader: the port of the JAX package's
``incubator_mxnet_tpu/gluon/data/dataloader.py``.

Batches are built on the host as numpy arrays (by the batchify function,
in the calling process, in a thread pool or in a process pool) and
become ``NDArray``s in the parent, on the context that was current when
the iteration began (the card unless the caller asks for the CPU). The
single-process path builds them in a prefetch thread, one batch ahead.
Process workers start with ``forkserver`` (``spawn`` where it is
missing), never ``fork``: a forked child of a parent that has
initialised CUDA cannot use CUDA, and forking a multithreaded parent can
leave a worker in a copied lock. Workers return numpy only; a training
loop moves the batch where it trains with ``gluon.utils.split_and_load``.
As with every spawn-family start method, a script that builds a
process-worker DataLoader needs the ``if __name__ == "__main__":`` idiom,
and the dataset and batchify function must pickle;
``MXTPU_WORKER_CONTEXT`` names another start method, ``thread_pool=True``
takes threads.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ...base import MXNetError
from ...context import current_context
from ...ndarray import NDArray
from ...ndarray import array as _array
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, SequentialSampler, Sampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(samples):
    """Stack samples into a batch: ``NDArray``s into one ``NDArray``,
    tuples field by field, anything else into a numpy array (float64 as
    float32)."""
    elem = samples[0]
    if isinstance(elem, NDArray):
        return NDArray(torch.stack([s._data for s in samples]))
    if isinstance(elem, (tuple, list)):
        return tuple(default_batchify_fn(list(s)) for s in zip(*samples))
    arr = np.asarray(samples)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return arr


def _as_device_batch(batch, ctx):
    """numpy -> ``NDArray`` on ``ctx`` (the transfer point)."""
    if isinstance(batch, (tuple, list)):
        return tuple(_as_device_batch(b, ctx) for b in batch)
    if isinstance(batch, NDArray):
        return batch
    return _array(batch, ctx=ctx)


_worker_dataset = None


def _worker_init(dataset):
    global _worker_dataset
    _worker_dataset = dataset


def _worker_fn(indices, batchify_fn):
    return batchify_fn([_worker_dataset[i] for i in indices])


def _process_context():
    name = os.environ.get("MXTPU_WORKER_CONTEXT")
    if name is not None:
        try:
            return multiprocessing.get_context(name)
        except ValueError:
            raise MXNetError(
                f"MXTPU_WORKER_CONTEXT={name!r} is not a start method on "
                f"this platform (want fork / forkserver / spawn)") from None
    try:
        return multiprocessing.get_context("forkserver")
    except ValueError:
        return multiprocessing.get_context("spawn")


class DataLoader:
    """Iterate a ``Dataset`` in batches.

    Parameters follow the reference: ``batch_size``, ``shuffle``,
    ``sampler``, ``last_batch`` ('keep', 'discard', 'rollover'),
    ``batch_sampler``, ``batchify_fn``, ``num_workers`` (0: batches are
    built in a prefetch thread), ``prefetch`` (batches in flight; default
    twice the workers, at least 2), ``thread_pool`` and ``timeout`` (the
    seconds to wait for one batch)."""

    def __init__(self, dataset: Dataset, batch_size=None, shuffle=False,
                 sampler: Optional[Sampler] = None, last_batch=None,
                 batch_sampler: Optional[BatchSampler] = None,
                 batchify_fn: Optional[Callable] = None, num_workers=0,
                 pin_memory=False, prefetch: Optional[int] = None,
                 thread_pool: bool = False, timeout=120):
        self._dataset = dataset
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError(
                    "batch_size is required when batch_sampler is not given")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise MXNetError(
                "batch_size/shuffle/sampler/last_batch incompatible with "
                "batch_sampler")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers or 2)
        self._pool = None
        if self._num_workers > 0:
            if thread_pool:
                from multiprocessing.pool import ThreadPool
                self._pool = ThreadPool(self._num_workers,
                                        initializer=_worker_init,
                                        initargs=(dataset,))
            else:
                self._pool = _process_context().Pool(
                    self._num_workers, initializer=_worker_init,
                    initargs=(dataset,))

    def __len__(self):
        return len(self._batch_sampler)

    def __iter__(self):
        ctx = current_context()
        if self._pool is not None:
            yield from self._iter_workers(ctx)
        else:
            yield from self._iter_prefetch(ctx)

    def _iter_prefetch(self, ctx):
        """The single-process path: a thread builds and transfers the next
        batch while the caller consumes this one."""
        q: "queue.Queue" = queue.Queue(maxsize=max(self._prefetch, 1))
        stop = object()

        def producer():
            try:
                for indices in self._batch_sampler:
                    batch = self._batchify_fn(
                        [self._dataset[i] for i in indices])
                    q.put(_as_device_batch(batch, ctx))
            except Exception as e:  # raised in the consumer
                q.put(e)
            q.put(stop)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get(timeout=self._timeout)
            if item is stop:
                break
            if isinstance(item, Exception):
                raise item
            yield item

    def _iter_workers(self, ctx):
        """The worker-pool path: a rolling window of ``prefetch`` batches
        in flight (at least one, so ``prefetch=0`` still yields)."""
        results = []
        it = iter(self._batch_sampler)

        def submit():
            try:
                indices = next(it)
            except StopIteration:
                return False
            results.append(self._pool.apply_async(
                _worker_fn, (indices, self._batchify_fn)))
            return True

        for _ in range(max(self._prefetch, 1)):
            if not submit():
                break
        while results:
            batch = results.pop(0).get(self._timeout)
            submit()
            yield _as_device_batch(batch, ctx)

    def __del__(self):
        if getattr(self, "_pool", None) is not None:
            self._pool.terminate()
