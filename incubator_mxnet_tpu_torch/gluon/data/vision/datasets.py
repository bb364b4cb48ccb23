"""Vision datasets: the port of the JAX package's
``incubator_mxnet_tpu/gluon/data/vision/datasets.py``.

``MNIST`` / ``FashionMNIST`` read the IDX files and ``CIFAR10`` /
``CIFAR100`` the python pickle batches under ``root`` when they are
there; without them ``synthetic=True`` makes the JAX package's
deterministic class-structured stand-in (the same seeds, so the same
images and labels), and without either the dataset raises: nothing is
downloaded. Images are HWC uint8 numpy arrays, labels int32.
``ImageFolderDataset`` (a class per subfolder) and ``ImageRecordDataset``
(an ``im2rec`` pack) decode through ``mx.image``'s codec chain and give
HWC uint8 numpy images too, where the JAX package's give ``NDArray``s: a
DataLoader worker then returns host arrays, as with every dataset here.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from ....base import MXNetError
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "ImageRecordDataset"]


def _synthetic_images(n, shape, classes, seed):
    """Deterministic class-separable images: class-keyed gaussian blobs."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n).astype(np.int32)
    protos = rng.rand(classes, *shape).astype(np.float32)
    imgs = protos[labels] * 0.8 + rng.rand(n, *shape).astype(np.float32) * 0.2
    return (imgs * 255).astype(np.uint8), labels


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform, synthetic, n_synth, shape,
                 classes, seed):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        if self._files_exist():
            self._get_data()
        elif synthetic:
            self._data, self._label = _synthetic_images(
                n_synth if train else max(n_synth // 6, 1),
                shape, classes, seed + (0 if train else 1))
        else:
            raise MXNetError(
                f"{type(self).__name__}: files not found under "
                f"{self._root!r} and nothing is downloaded; "
                f"place the standard files there or pass synthetic=True")

    def _files_exist(self) -> bool:
        raise NotImplementedError

    def _get_data(self):
        raise NotImplementedError

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        img = self._data[idx]
        label = self._label[idx]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class MNIST(_DownloadedDataset):
    """MNIST from IDX files (train-images-idx3-ubyte[.gz] etc.)."""

    _TRAIN = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _TEST = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None, synthetic=False, synthetic_size=6000):
        super().__init__(root, train, transform, synthetic, synthetic_size,
                         (28, 28, 1), 10, seed=42)

    def _names(self):
        return self._TRAIN if self._train else self._TEST

    def _find(self, name):
        for suffix in ("", ".gz"):
            p = os.path.join(self._root, name + suffix)
            if os.path.exists(p):
                return p
        return None

    def _files_exist(self):
        return all(self._find(n) is not None for n in self._names())

    @staticmethod
    def _read_idx(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            raw = f.read()
        zero, dtype_code, ndim = struct.unpack(">HBB", raw[:4])
        dims = struct.unpack(">" + "I" * ndim, raw[4:4 + 4 * ndim])
        return np.frombuffer(raw, dtype=np.uint8,
                             offset=4 + 4 * ndim).reshape(dims)

    def _get_data(self):
        img_name, lbl_name = self._names()
        imgs = self._read_idx(self._find(img_name))
        self._data = imgs.reshape(-1, 28, 28, 1)
        self._label = self._read_idx(self._find(lbl_name)).astype(np.int32)


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None, synthetic=False, synthetic_size=6000):
        super().__init__(root=root, train=train, transform=transform,
                         synthetic=synthetic, synthetic_size=synthetic_size)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the python pickle batches."""

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None, synthetic=False, synthetic_size=6000):
        super().__init__(root, train, transform, synthetic, synthetic_size,
                         (32, 32, 3), 10, seed=7)

    def _batch_files(self):
        if self._train:
            return [f"data_batch_{i}" for i in range(1, 6)]
        return ["test_batch"]

    def _files_exist(self):
        base = os.path.join(self._root, "cifar-10-batches-py")
        return all(os.path.exists(os.path.join(base, f))
                   for f in self._batch_files())

    def _get_data(self):
        base = os.path.join(self._root, "cifar-10-batches-py")
        data, labels = [], []
        for fname in self._batch_files():
            with open(os.path.join(base, fname), "rb") as f:
                batch = pickle.load(f, encoding="latin1")
            data.append(batch["data"])
            labels.extend(batch["labels"])
        arr = np.concatenate(data).reshape(-1, 3, 32, 32)
        self._data = arr.transpose(0, 2, 3, 1).astype(np.uint8)
        self._label = np.asarray(labels, np.int32)


class CIFAR100(_DownloadedDataset):
    """CIFAR-100 from the python pickle batches. ``fine_label`` selects
    the 100-way fine labels (True, default) or the 20 coarse
    superclasses."""

    def __init__(self, root="~/.mxnet/datasets/cifar100", train=True,
                 transform=None, fine_label=True, synthetic=False,
                 synthetic_size=6000):
        self._fine = fine_label
        super().__init__(root, train, transform, synthetic, synthetic_size,
                         (32, 32, 3), 100 if fine_label else 20, seed=9)

    def _files_exist(self):
        base = os.path.join(self._root, "cifar-100-python")
        fname = "train" if self._train else "test"
        return os.path.exists(os.path.join(base, fname))

    def _get_data(self):
        base = os.path.join(self._root, "cifar-100-python")
        fname = "train" if self._train else "test"
        with open(os.path.join(base, fname), "rb") as f:
            batch = pickle.load(f, encoding="latin1")
        arr = np.asarray(batch["data"]).reshape(-1, 3, 32, 32)
        self._data = arr.transpose(0, 2, 3, 1).astype(np.uint8)
        key = "fine_labels" if self._fine else "coarse_labels"
        self._label = np.asarray(batch[key], np.int32)


class ImageFolderDataset(Dataset):
    """Images in a class per subfolder of ``root`` (parity:
    ``gluon.data.vision.ImageFolderDataset``): ``synsets`` are the
    subfolders in sorted order, ``items`` the ``(path, label)`` pairs;
    an item is ``(HWC uint8 image, label)``, ``flag=0`` for one gray
    channel."""

    _EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if os.path.splitext(fname)[1].lower() in self._EXTS:
                    self.items.append((os.path.join(path, fname), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from ....image import decode_to_numpy
        path, label = self.items[idx]
        with open(path, "rb") as f:
            img = decode_to_numpy(f.read(), self._flag,
                                  to_rgb=bool(self._flag))
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageRecordDataset(RecordFileDataset):
    """``(HWC uint8 image, label)`` pairs of an ``im2rec`` pack (parity:
    ``gluon.data.vision.ImageRecordDataset``): each record an
    ``IRHeader``-packed label and image."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ....io.recordio import unpack
        from ....image import decode_to_numpy
        header, img_bytes = unpack(super().__getitem__(idx))
        img = decode_to_numpy(img_bytes, self._flag, to_rgb=bool(self._flag))
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label
