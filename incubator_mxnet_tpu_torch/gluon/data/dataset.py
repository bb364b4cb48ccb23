"""Datasets: the port of the JAX package's
``incubator_mxnet_tpu/gluon/data/dataset.py``."""

from __future__ import annotations

from typing import Callable

from ...base import MXNetError

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset"]


class Dataset:
    """Abstract random-access dataset."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn: Callable, lazy: bool = True):
        """A dataset with ``fn(*sample)`` applied to each sample (on
        access when ``lazy``, else all at once)."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn: Callable, lazy: bool = True):
        """Apply ``fn`` to the first element of each sample only."""
        return self.transform(_first_only(fn), lazy)

    def filter(self, fn: Callable):
        return SimpleDataset(
            [self[i] for i in range(len(self))
             if fn(self[i])])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def shard(self, num_shards, index):
        """Every ``num_shards``-th sample starting at ``index`` (the
        reference's part_index / num_parts contract)."""
        if not 0 <= index < num_shards:
            raise MXNetError(f"shard index {index} out of range")
        return SimpleDataset(
            [self[i] for i in range(index, len(self), num_shards)])


class _first_only:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    """Wrap any sized indexable (list, numpy array…)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Zip of equal-length arrays."""

    def __init__(self, *args):
        if not args:
            raise MXNetError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        for i, a in enumerate(args):
            if len(a) != self._length:
                raise MXNetError(
                    f"all arrays must have the same length; arg {i} has "
                    f"{len(a)} != {self._length}")
        self._data = args

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(a[idx] for a in self._data)


class RecordFileDataset(Dataset):
    """The records of an indexed RecordIO file (``name.rec`` beside
    ``name.idx``) by position, as bytes (parity:
    ``gluon.data.RecordFileDataset``)."""

    def __init__(self, filename):
        from ...io.recordio import IndexedRecordIO
        self._filename = filename
        idx_file = filename[:filename.rfind(".")] + ".idx"
        self._record = IndexedRecordIO(idx_file, filename, "r")

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])
