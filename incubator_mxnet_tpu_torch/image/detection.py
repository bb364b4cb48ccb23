"""The detection image pipeline (parity: ``mx.image`` detection's
``DetAugmenter`` classes, ``CreateDetAugmenter`` and ``ImageDetIter``):
the port of the JAX package's ``incubator_mxnet_tpu/image/detection.py``.

Labels travel with their images as ``(num_obj, 5)`` float arrays ``[class,
x1, y1, x2, y2]`` with corners normalized to [0, 1]; the augmenters move
image and boxes together, and the iterator pads every image's objects to
``max_objects`` rows of -1, the layout ``MultiBoxTarget`` (and
``models.ssd``'s ``training_targets``) reads, so batches keep one shape.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..base import MXNetError
from ..context import current_context
from ..io import DataBatch, DataDesc, DataIter
from ..ndarray import NDArray
from ..ndarray import array as _array
from . import (IMAGENET_MEAN, IMAGENET_STD, Augmenter, _nd, _rng, imresize,
               resize_short)

__all__ = ["DetAugmenter", "DetForceResizeAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "DetRandomSelectAug", "DetResizeShortAug",
           "DetNormalizeAug", "CreateDetAugmenter", "ImageDetIter"]


def _np_img(src):
    return np.asarray(src.asnumpy() if isinstance(src, NDArray) else src)


class DetAugmenter(Augmenter):
    """``aug(img, label) -> (img, label)``."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetForceResizeAug(DetAugmenter):
    """Resize to exactly ``size = (w, h)``; normalized boxes stay."""

    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size = tuple(size)
        self.interp = interp

    def __call__(self, src, label):
        return imresize(src, self.size[0], self.size[1], self.interp), label


class DetHorizontalFlipAug(DetAugmenter):
    """Flip the image and mirror the boxes' x with probability ``p``."""

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if _rng().rand() < self.p:
            img = _np_img(src)[:, ::-1]
            lab = np.array(label, np.float32, copy=True)
            valid = lab[:, 0] >= 0
            x1 = lab[valid, 1].copy()
            lab[valid, 1] = 1.0 - lab[valid, 3]
            lab[valid, 3] = 1.0 - x1
            return _nd(img), lab
        return src, label


class DetRandomCropAug(DetAugmenter):
    """A random window that keeps enough of the objects: boxes whose
    centre is inside it are kept and clipped to it; up to
    ``max_attempts`` draws, else the image unchanged."""

    def __init__(self, min_object_covered=0.3, area_range=(0.5, 1.0),
                 max_attempts=10):
        super().__init__(min_object_covered=min_object_covered,
                         area_range=area_range, max_attempts=max_attempts)
        self.min_cov = float(min_object_covered)
        self.area_range = tuple(area_range)
        self.max_attempts = int(max_attempts)

    def __call__(self, src, label):
        rng = _rng()
        img = _np_img(src)
        H, W = img.shape[:2]
        lab = np.array(label, np.float32, copy=True)
        valid = lab[:, 0] >= 0
        for _ in range(self.max_attempts):
            side = np.sqrt(rng.uniform(*self.area_range))
            cw, ch = max(int(W * side), 1), max(int(H * side), 1)
            x0 = rng.randint(0, W - cw + 1)
            y0 = rng.randint(0, H - ch + 1)
            wx0, wy0 = x0 / W, y0 / H
            wx1, wy1 = (x0 + cw) / W, (y0 + ch) / H
            cx = (lab[:, 1] + lab[:, 3]) / 2
            cy = (lab[:, 2] + lab[:, 4]) / 2
            keep = valid & (cx >= wx0) & (cx <= wx1) & \
                (cy >= wy0) & (cy <= wy1)
            if valid.any() and keep.sum() < max(
                    1, int(np.ceil(self.min_cov * valid.sum()))):
                continue
            out = np.full_like(lab, -1.0)
            sw, sh = wx1 - wx0, wy1 - wy0
            for k, row in enumerate(lab[keep]):
                out[k] = [row[0],
                          (max(row[1], wx0) - wx0) / sw,
                          (max(row[2], wy0) - wy0) / sh,
                          (min(row[3], wx1) - wx0) / sw,
                          (min(row[4], wy1) - wy0) / sh]
            return _nd(img[y0:y0 + ch, x0:x0 + cw]), out
        return src, lab


class DetRandomSelectAug(DetAugmenter):
    """``aug`` with probability ``p``, else nothing."""

    def __init__(self, aug: DetAugmenter, p: float):
        super().__init__(p=p)
        self.aug, self.p = aug, float(p)

    def __call__(self, src, label):
        if _rng().rand() < self.p:
            return self.aug(src, label)
        return src, label


class DetResizeShortAug(DetAugmenter):
    """The shorter side resized to ``size``; normalized boxes stay."""

    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = int(size), interp

    def __call__(self, src, label):
        return resize_short(src, self.size, self.interp), label


class DetNormalizeAug(DetAugmenter):
    """``(img - mean) / std`` on the HWC float image."""

    def __init__(self, mean, std=None):
        super().__init__()
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32) if std is not None else None

    def __call__(self, src, label):
        arr = _np_img(src).astype(np.float32) - self.mean
        if self.std is not None:
            arr = arr / self.std
        return _nd(arr), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0.0,
                       rand_mirror=False, mean=None, std=None,
                       min_object_covered=0.3,
                       area_range=(0.5, 1.0)) -> List[DetAugmenter]:
    """The standard detection augmenters (parity:
    ``mx.image.CreateDetAugmenter``): ``rand_crop`` is the probability of
    the random crop; ``mean`` / ``std`` (``True``: ImageNet's) add a
    normalization."""
    augs: List[DetAugmenter] = []
    if resize > 0:
        augs.append(DetResizeShortAug(resize))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered=min_object_covered,
                                area_range=area_range)
        augs.append(crop if rand_crop >= 1.0
                    else DetRandomSelectAug(crop, rand_crop))
    if rand_mirror:
        augs.append(DetHorizontalFlipAug(0.5))
    augs.append(DetForceResizeAug((data_shape[2], data_shape[1])))
    if mean is True:
        mean = np.array(IMAGENET_MEAN, np.float32)
    if std is True:
        std = np.array(IMAGENET_STD, np.float32)
    if mean is not None:
        augs.append(DetNormalizeAug(mean, std))
    return augs


class ImageDetIter(DataIter):
    """Detection batches (parity: ``mx.image.ImageDetIter``) from a
    ``path_imgrec`` whose headers carry MXNet's detection labels
    (``[header_width, object_width, ..., objects]``) or from in-memory
    ``imgs`` and ``labels``: ``data`` (B, C, H, W) float32 and ``label``
    (B, max_objects, 5), on the context current at construction."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 imgs: Optional[Sequence] = None,
                 labels: Optional[Sequence] = None, shuffle=False,
                 max_objects=None, mean=None, std=None,
                 aug_list: Optional[List[DetAugmenter]] = None, **kwargs):
        super().__init__(batch_size)
        self._shape = tuple(data_shape)
        self._ctx = current_context()
        if path_imgrec is not None:
            imgs, labels = _read_det_records(path_imgrec)
        if imgs is None or labels is None:
            raise MXNetError("ImageDetIter needs path_imgrec or "
                             "imgs+labels")
        if len(imgs) != len(labels):
            raise MXNetError("imgs and labels length mismatch")
        self._imgs = list(imgs)
        self._labels = [np.asarray(lab, np.float32).reshape(-1, 5)
                        for lab in labels]
        self._max_obj = max_objects or max(
            (lab.shape[0] for lab in self._labels), default=1)
        self._shuffle = shuffle
        self._mean = np.asarray(mean, np.float32) if mean is not None \
            else None
        self._std = np.asarray(std, np.float32) if std is not None else None
        self._augs = aug_list if aug_list is not None else \
            CreateDetAugmenter(self._shape, **kwargs)
        self._order = np.arange(len(self._imgs))
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self._shape)]

    @property
    def provide_label(self):
        return [DataDesc("label", (self.batch_size, self._max_obj, 5))]

    def reset(self):
        if self._shuffle:
            _rng().shuffle(self._order)
        self._cursor = 0

    def iter_next(self):
        return self._cursor < len(self._order)

    def _prep(self, i):
        img = self._imgs[i]
        lab = np.full((self._max_obj, 5), -1.0, np.float32)
        n = min(len(self._labels[i]), self._max_obj)
        lab[:n] = self._labels[i][:n]
        for aug in self._augs:
            img, lab = aug(img, lab)
        arr = _np_img(img).astype(np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self._mean is not None:
            arr = arr - self._mean
        if self._std is not None:
            arr = arr / self._std
        return arr.transpose(2, 0, 1), lab

    def next(self):
        if not self.iter_next():
            raise StopIteration
        end = self._cursor + self.batch_size
        ids = self._order[self._cursor:end].tolist()
        pad = 0
        if len(ids) < self.batch_size:
            pad = self.batch_size - len(ids)
            ids = ids + np.resize(self._order, pad).tolist()
        self._cursor = end
        data, labs = zip(*(self._prep(i) for i in ids))
        return DataBatch([_array(np.stack(data), ctx=self._ctx)],
                         [_array(np.stack(labs), ctx=self._ctx)], pad=pad)


def _read_det_records(path):
    """Every image of a detection ``.rec`` and its ``(n, 5)`` objects."""
    from ..io.recordio import MXRecordIO, unpack_img
    rec = MXRecordIO(path, "r")
    imgs, labels = [], []
    try:
        while True:
            payload = rec.read()
            if payload is None:
                break
            header, img = unpack_img(payload)
            flat = np.asarray(header.label, np.float32).ravel()
            hw, ow = int(flat[0]), int(flat[1])
            imgs.append(img)
            labels.append(flat[hw:].reshape(-1, ow)[:, :5])
    finally:
        rec.close()
    return imgs, labels
