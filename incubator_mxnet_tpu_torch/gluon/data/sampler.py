"""Samplers: the port of the JAX package's
``incubator_mxnet_tpu/gluon/data/sampler.py``. ``RandomSampler`` shuffles
with ``mx.random.np_rng()``, a host stream that ``mx.random.seed``
restarts (not the JAX package's threefry-derived one: a shuffled epoch
is another permutation in each package)."""

from __future__ import annotations

import numpy as np

from ...base import MXNetError

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler", "IntervalSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        from ... import random as _random
        indices = np.arange(self._length)
        _random.np_rng().shuffle(indices)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class FilterSampler(Sampler):
    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class IntervalSampler(Sampler):
    def __init__(self, length, interval, rollover=True):
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        starts = range(self._interval) if self._rollover else [0]
        for start in starts:
            yield from range(start, self._length, self._interval)

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))


class BatchSampler(Sampler):
    """A sampler's indices in batches; ``last_batch`` 'keep', 'discard'
    or 'rollover' (a short last batch starts the next epoch)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in ("keep", "discard", "rollover"):
            raise MXNetError(f"invalid last_batch {last_batch!r}")
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        n = len(self._sampler) + len(self._prev)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        return n // self._batch_size
