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

``ImageRecordIter`` reads a ``.rec`` of images (``recordio``, the
native reader where it builds), decodes and crops on
``preprocess_threads`` threads and normalizes on the device the batch
lands on (the context current at construction); ``ImageDetRecordIter``
is ``image.ImageDetIter``'s reader; ``MNISTIter`` reads
``gluon.data.vision.MNIST``; ``LibSVMIter`` reads LibSVM text into CSR
batches (``ndarray.sparse.CSRNDArray``).
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
from ..context import current_context, resolve_device
from ..ndarray import NDArray
from . import recordio
from .recordio import (IRHeader, IndexedRecordIO, MXIndexedRecordIO,
                       MXRecordIO, pack, pack_img, unpack, unpack_img)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "ImageRecordIter", "ImageDetRecordIter",
           "MNISTIter", "ResizeIter", "PrefetchingIter", "recordio",
           "MXRecordIO", "IndexedRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img"]


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


class LibSVMIter(DataIter):
    """LibSVM text-format reader emitting CSR data batches (parity:
    ``mx.io.LibSVMIter``). Lines are ``label idx:val idx:val ...``
    (0-based indices); ``label_libsvm`` names a second file whose lines'
    ``idx:val`` pairs fill dense label rows of ``label_shape``. The
    dataset is held on the host as one CSR triple and sliced per batch;
    a short last batch pads with empty rows under ``round_batch``.
    Batches are host arrays (a ``CSRNDArray`` and an ``NDArray``), as
    ``NDArrayIter``'s over numpy are; ``Module`` makes the data dense at
    its graph's boundary."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=None, batch_size=1, round_batch=True,
                 **kwargs):
        super().__init__(batch_size)
        self._feat_dim = int(data_shape[0] if isinstance(
            data_shape, (tuple, list)) else data_shape)
        labels, data, indices, indptr = [], [], [], [0]
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                for p in parts[1:]:
                    k, v = p.split(":")
                    indices.append(int(k))
                    data.append(float(v))
                indptr.append(len(data))
        self._data = np.asarray(data, np.float32)
        self._indices = np.asarray(indices, np.int32)
        self._indptr = np.asarray(indptr, np.int64)
        self._num = len(labels)
        label = np.asarray(labels, np.float32).reshape(-1, 1)
        if label_libsvm is not None:
            ldim = int(label_shape[0] if isinstance(
                label_shape, (tuple, list)) else (label_shape or 1))
            rows = []
            with open(label_libsvm) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    row = np.zeros(ldim, np.float32)
                    for p in parts[1:]:
                        k, v = p.split(":")
                        row[int(k)] = float(v)
                    rows.append(row)
            label = np.asarray(rows, np.float32)
        self._label = label
        self._round = round_batch
        self._cursor = 0

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._feat_dim),
                         np.float32)]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label",
                         (self.batch_size,) + self._label.shape[1:],
                         np.float32)]

    def reset(self):
        self._cursor = 0

    def iter_next(self):
        return self._cursor < self._num

    def tell(self) -> dict:
        return {"cursor": int(self._cursor)}

    def set_position(self, state: dict):
        self._cursor = int(state["cursor"])

    def _rows(self, lo, hi):
        from ..ndarray.sparse import CSRNDArray
        sl = slice(self._indptr[lo], self._indptr[hi])
        indptr = self._indptr[lo:hi + 1] - self._indptr[lo]
        pad = self.batch_size - (hi - lo)
        if pad:
            indptr = np.concatenate(
                [indptr, np.full(pad, indptr[-1], np.int64)])
        return CSRNDArray(self._data[sl], self._indices[sl], indptr,
                          (self.batch_size, self._feat_dim), device="cpu")

    def next(self):
        if not self.iter_next():
            raise StopIteration
        lo = self._cursor
        hi = min(lo + self.batch_size, self._num)
        if not self._round and hi - lo < self.batch_size:
            raise StopIteration
        self._cursor = hi
        lab = self._label[lo:hi]
        pad = self.batch_size - (hi - lo)
        if pad:
            lab = np.concatenate(
                [lab, np.zeros((pad,) + lab.shape[1:], np.float32)])
        return DataBatch(data=[self._rows(lo, hi)],
                         label=[NDArray(torch.from_numpy(lab.copy()))],
                         pad=pad)


class MNISTIter(DataIter):
    """MNIST batches (parity: ``mx.io.MNISTIter``) over
    ``gluon.data.vision.MNIST``: the IDX files next to ``image``, else the
    synthetic stand-in (nothing is downloaded); images scaled to [0, 1],
    NCHW or ``flat``; ``num_parts`` / ``part_index`` take every
    ``num_parts``-th image. Batches are host ``NDArray``s, as
    ``NDArrayIter``'s over numpy are."""

    def __init__(self, image=None, label=None, batch_size=128, shuffle=True,
                 flat=False, seed=0, silent=False, num_parts=1, part_index=0,
                 **kwargs):
        super().__init__(batch_size)
        from ..gluon.data.vision.datasets import MNIST
        root = os.path.dirname(image) if image else "~/.mxnet/datasets/mnist"
        train = image is None or "train" in os.path.basename(image)
        try:
            ds = MNIST(root=root, train=train)
        except MXNetError:
            ds = MNIST(root=root, train=train, synthetic=True)
        imgs = ds._data.astype(np.float32) / 255.0
        labels = ds._label
        imgs = imgs.reshape(len(imgs), -1) if flat \
            else imgs.transpose(0, 3, 1, 2)
        if num_parts > 1:
            imgs = imgs[part_index::num_parts]
            labels = labels[part_index::num_parts]
        self._inner = NDArrayIter(imgs, labels.astype(np.float32),
                                  batch_size, shuffle=shuffle,
                                  last_batch_handle="discard")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

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


_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}


def normalize_batch(u8, mean, std, dtype=torch.float32):
    """A uint8 NHWC batch as NCHW ``(x - mean) / std`` in ``dtype`` (f32
    arithmetic, IEEE subtract and divide by per-channel tensors, so it is
    bitwise numpy's ``(x.astype(float32) - mean) / std`` on any device);
    one channel is only cast, as the JAX iterator does."""
    n, h, w, c = u8.shape
    x = torch.empty((n, c, h, w), dtype=torch.float32, device=u8.device)
    x.copy_(u8.permute(0, 3, 1, 2))
    if c >= 3:
        x.sub_(mean.view(1, -1, 1, 1)).div_(std.view(1, -1, 1, 1))
    return x if dtype == torch.float32 else x.to(dtype)


class ImageRecordIter(DataIter):
    """Image batches from a RecordIO file (parity: ``mx.io.
    ImageRecordIter``, MXNet's ``iter_image_recordio_2.cc``), as the JAX
    package's iterator makes them: records in file order or shuffled by a
    drawn seed (``tell`` / ``set_position`` carry it), ``num_parts`` /
    ``part_index``, each image decoded by the codec chain
    (``image.decode_to_numpy``), cut to ``data_shape`` (a random window
    with ``rand_crop`` on an image larger than it, else the centre, and
    edge padding where it is smaller), flipped with ``rand_mirror``, then
    ``(x - mean) / std`` per channel and NCHW, in ``dtype``;
    ``round_batch`` fills the last batch from the epoch's start (``pad``
    says how many).

    The records are read by the native reader where it builds (``reader``
    says which), decoded and cut on ``preprocess_threads`` threads; every
    random draw is made on the calling thread in record order, so a batch
    is bitwise the same at any thread count for one ``mx.random.seed``.
    The uint8 batch goes to the device through pinned memory on a stream
    of the iterator's own and is normalized there (a quarter of the f32
    bytes cross the bus); the stream current where ``next`` runs (the
    default stream under ``PrefetchingIter``) waits for it. Batches land
    on the context current at construction."""

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, num_parts=1, part_index=0, preprocess_threads=4,
                 round_batch=True, seed=0, dtype="float32", **kwargs):
        super().__init__(batch_size)
        if str(dtype) not in _DTYPES:
            raise MXNetError(f"ImageRecordIter: dtype {dtype!r} is not one "
                             f"of {sorted(_DTYPES)}")
        self._path = path_imgrec
        self._shape = tuple(data_shape)
        self._label_width = label_width
        self._shuffle = shuffle
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._round = round_batch
        self._dtype = _DTYPES[str(dtype)]
        self._threads = max(1, int(preprocess_threads))
        self._pool = None
        self._stream = None
        self._device = resolve_device(current_context())
        self._mean = torch.tensor([mean_r, mean_g, mean_b],
                                  dtype=torch.float32, device=self._device)
        self._std = torch.tensor([std_r, std_g, std_b],
                                 dtype=torch.float32, device=self._device)
        from ._native import NativeRecordReader
        try:
            self._native = NativeRecordReader(path_imgrec,
                                              n_threads=self._threads)
            n = len(self._native)
            self.reader = "native"
        except RuntimeError:
            self._native = None
            self._plain = MXRecordIO(path_imgrec, "r")
            self._offsets = []
            while True:
                pos = self._plain.tell()
                if self._plain.read() is None:
                    break
                self._offsets.append(pos)
            n = len(self._offsets)
            self.reader = "python"
        idx = np.arange(n)
        if num_parts > 1:
            idx = idx[part_index::num_parts]
        self._indices = idx
        self._order = np.array(idx)
        self._shuffle_seed = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self._shape,
                         str(self._dtype).replace("torch.", ""))]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self._label_width == 1 else \
            (self.batch_size, self._label_width)
        return [DataDesc("softmax_label", shape)]

    def _shuffled(self, seed: int):
        self._shuffle_seed = seed
        self._order = np.array(self._indices)
        np.random.RandomState(seed).shuffle(self._order)

    def reset(self):
        if self._shuffle:
            self._shuffled(_draw_shuffle_seed())
        self._cursor = 0

    def iter_next(self):
        return self._cursor < len(self._order)

    def tell(self) -> dict:
        return {"cursor": int(self._cursor),
                "num_records": len(self._indices),
                "shuffle_seed": self._shuffle_seed}

    def set_position(self, state: dict):
        if state.get("num_records") is not None and \
                int(state["num_records"]) != len(self._indices):
            raise MXNetError(
                f"iterator position is for {state['num_records']} "
                f"records, this record set has {len(self._indices)}")
        if state.get("shuffle_seed") is not None:
            self._shuffled(int(state["shuffle_seed"]))
        self._cursor = int(state["cursor"])

    def _map(self, fn, items):
        if self._threads == 1:
            return list(map(fn, items))
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                self._threads, thread_name_prefix="ImageRecordIter")
        return list(self._pool.map(fn, items))

    def _read_records(self, ids):
        if self._native is not None:
            return self._native.read_batch(ids)
        out = []
        for i in ids:
            self._plain.seek(self._offsets[i])
            out.append(self._plain.read())
        return out

    def _window(self, rng, h, w):
        """``(y0, x0, mirror)`` of one image of ``h`` x ``w``: the draws of
        the JAX iterator, in its order."""
        _, H, W = self._shape
        if self._rand_crop and (h > H or w > W):
            y0 = rng.randint(0, max(h - H, 0) + 1)
            x0 = rng.randint(0, max(w - W, 0) + 1)
        else:
            y0, x0 = max((h - H) // 2, 0), max((w - W) // 2, 0)
        return y0, x0, bool(self._rand_mirror and rng.rand() < 0.5)

    def _cut(self, img, window, out):
        """The window of ``img``, edge-padded to the data shape and
        flipped when asked, written into ``out`` (H, W, C)."""
        _, H, W = self._shape
        y0, x0, mirror = window
        img = img[y0:y0 + H, x0:x0 + W]
        h, w = img.shape[:2]
        if h < H or w < W:
            img = np.pad(img, ((0, H - h), (0, W - w), (0, 0)), mode="edge")
        out[...] = img[:, ::-1] if mirror else img

    def next(self):
        if not self.iter_next():
            raise StopIteration
        from ..image import decode_to_numpy
        from .. import random as _random
        end = self._cursor + self.batch_size
        ids = self._order[self._cursor:end].tolist()
        pad = 0
        if len(ids) < self.batch_size:
            if not self._round:
                self._cursor = len(self._order)
                if not ids:
                    raise StopIteration
            else:
                pad = self.batch_size - len(ids)
                ids = ids + self._order[:pad].tolist()
        self._cursor = end
        records = [unpack(p) for p in self._read_records(ids)]
        imgs = self._map(decode_to_numpy, [payload for _, payload in records])
        rng = _random.np_rng() if (self._rand_crop or self._rand_mirror) \
            else None
        windows = [self._window(rng, *img.shape[:2]) for img in imgs]
        _, H, W = self._shape
        shape = (len(imgs), H, W, imgs[0].shape[2])
        cuda = self._device.type == "cuda"
        host = torch.empty(shape, dtype=torch.uint8, pin_memory=cuda)
        u8 = host.numpy()
        self._map(lambda i: self._cut(imgs[i], windows[i], u8[i]),
                  range(len(imgs)))
        labels = np.stack([np.atleast_1d(np.asarray(h.label, np.float32))
                           [:self._label_width] for h, _ in records])
        if self._label_width == 1:
            labels = labels.squeeze(-1)
        lab = torch.empty(labels.shape, dtype=torch.float32, pin_memory=cuda)
        lab.numpy()[...] = labels
        data, label = self._to_device(host, lab)
        return DataBatch([NDArray(data)], [NDArray(label)], pad=pad)

    def _to_device(self, host, lab):
        if self._device.type != "cuda":
            return normalize_batch(host, self._mean, self._std,
                                   self._dtype), lab
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
        consumer = torch.cuda.current_stream(self._device)
        with torch.cuda.stream(self._stream):
            u8 = host.to(self._device, non_blocking=True)
            label = lab.to(self._device, non_blocking=True)
            data = normalize_batch(u8, self._mean, self._std, self._dtype)
        consumer.wait_stream(self._stream)
        data.record_stream(consumer)
        label.record_stream(consumer)
        return data, label

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)


def ImageDetRecordIter(**kwargs):
    """Detection batches from a RecordIO file (parity surface:
    ``mx.io.ImageDetRecordIter``): ``image.ImageDetIter`` with MXNet's
    keyword arguments translated (``mean_r`` / ``_g`` / ``_b`` and
    ``std_*`` to ``mean`` / ``std``); its tuning knobs
    (``preprocess_threads``, ``label_pad_width``, ...) are accepted and
    have no effect."""
    from ..image.detection import ImageDetIter
    mean = tuple(kwargs.pop(f"mean_{c}", 0.0) for c in "rgb")
    std = tuple(kwargs.pop(f"std_{c}", 1.0) for c in "rgb")
    passthrough = {k: kwargs.pop(k) for k in (
        "batch_size", "data_shape", "path_imgrec", "shuffle", "max_objects",
        "aug_list", "resize", "rand_crop", "rand_mirror")
        if k in kwargs}
    if any(mean):
        passthrough["mean"] = mean
    if std != (1.0, 1.0, 1.0):
        passthrough["std"] = std
    return ImageDetIter(**passthrough)


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
