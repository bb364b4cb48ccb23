"""Vision transforms: the port of the JAX package's
``incubator_mxnet_tpu/gluon/data/vision/transforms.py``. Transforms take
HWC uint8 / float numpy arrays or ``NDArray``s (read to the host) and
return numpy arrays, so they run in data-loader workers; ``Compose``
chains them. Random ones draw from ``mx.random.np_rng()``."""

from __future__ import annotations

import numpy as np

from .... import random as _random
from ....ndarray import NDArray

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomCrop",
           "RandomFlipLeftRight", "RandomFlipTopBottom", "Lambda"]


def _to_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return np.asarray(x)


class _Transform:
    def __call__(self, x, *args):
        out = self.apply(_to_np(x))
        if args:
            return (out,) + args
        return out

    def apply(self, x):
        raise NotImplementedError


class Compose(_Transform):
    def __init__(self, transforms):
        self._transforms = transforms

    def __call__(self, x, *args):
        for t in self._transforms:
            x = t(x)
        if args:
            return (x,) + args
        return x


class Lambda(_Transform):
    def __init__(self, fn):
        self._fn = fn

    def apply(self, x):
        return self._fn(x)


class Cast(_Transform):
    def __init__(self, dtype="float32"):
        self._dtype = dtype

    def apply(self, x):
        return x.astype(self._dtype)


class ToTensor(_Transform):
    """HWC uint8 [0, 255] -> CHW float32 [0, 1]."""

    def apply(self, x):
        x = x.astype(np.float32) / 255.0
        if x.ndim == 3:
            return np.ascontiguousarray(x.transpose(2, 0, 1))
        return x

    def __call__(self, x, *args):
        out = self.apply(_to_np(x))
        if args:
            return (out,) + args
        return out


class Normalize(_Transform):
    def __init__(self, mean=0.0, std=1.0):
        self._mean = np.asarray(mean, np.float32)
        self._std = np.asarray(std, np.float32)

    def apply(self, x):
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return (x - mean) / std


def _resize_np(x, size):
    """Nearest-neighbour resize of an HWC array."""
    h, w = x.shape[:2]
    out_w, out_h = (size, size) if isinstance(size, int) else size
    rows = (np.arange(out_h) * h / out_h).astype(np.int32)
    cols = (np.arange(out_w) * w / out_w).astype(np.int32)
    return x[rows][:, cols]


class Resize(_Transform):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        self._size = size

    def apply(self, x):
        return _resize_np(x, self._size)


class CenterCrop(_Transform):
    def __init__(self, size):
        self._size = (size, size) if isinstance(size, int) else size

    def apply(self, x):
        w, h = self._size
        H, W = x.shape[:2]
        y0 = max((H - h) // 2, 0)
        x0 = max((W - w) // 2, 0)
        return x[y0:y0 + h, x0:x0 + w]


class RandomCrop(_Transform):
    def __init__(self, size, pad=None):
        self._size = (size, size) if isinstance(size, int) else size
        self._pad = pad

    def apply(self, x):
        if self._pad:
            p = self._pad
            x = np.pad(x, ((p, p), (p, p)) + ((0, 0),) * (x.ndim - 2))
        w, h = self._size
        H, W = x.shape[:2]
        rng = _random.np_rng()
        y0 = rng.randint(0, max(H - h, 0) + 1)
        x0 = rng.randint(0, max(W - w, 0) + 1)
        return x[y0:y0 + h, x0:x0 + w]


class RandomResizedCrop(_Transform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def apply(self, x):
        H, W = x.shape[:2]
        rng = _random.np_rng()
        for _ in range(10):
            area = H * W * rng.uniform(*self._scale)
            ratio = rng.uniform(*self._ratio)
            w = int(round(np.sqrt(area * ratio)))
            h = int(round(np.sqrt(area / ratio)))
            if w <= W and h <= H:
                x0 = rng.randint(0, W - w + 1)
                y0 = rng.randint(0, H - h + 1)
                return _resize_np(x[y0:y0 + h, x0:x0 + w], self._size)
        return _resize_np(x, self._size)


class RandomFlipLeftRight(_Transform):
    def apply(self, x):
        if _random.np_rng().rand() < 0.5:
            return x[:, ::-1]
        return x


class RandomFlipTopBottom(_Transform):
    def apply(self, x):
        if _random.np_rng().rand() < 0.5:
            return x[::-1]
        return x
