"""Image decoding and augmentation (parity: ``mx.image``): the port of the
JAX package's ``incubator_mxnet_tpu/image/__init__.py``.

Host work stays in numpy, as in the JAX package; what returns an
``NDArray`` puts it on the current context. The codec chain
(``decode_to_numpy``) is the one the record readers use: a raw ``NPY0``
payload, else cv2, else PIL, else the native libjpeg decoder
(``io/_native_image.py``, where it builds); ``decoder()`` names the link
that decodes here.
"""

from __future__ import annotations

import io as _io
import json

import numpy as np

from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray import array as _array

__all__ = ["imread", "imdecode", "decode_to_numpy", "decoder", "imresize",
           "resize_short", "fixed_crop", "center_crop", "random_crop",
           "random_size_crop", "copyMakeBorder", "imrotate",
           "random_rotate", "color_normalize", "ImageIter",
           "imdecode_resize_batch", "Augmenter", "ResizeAug",
           "ForceResizeAug", "RandomCropAug", "CenterCropAug",
           "HorizontalFlipAug", "CastAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
           "ColorJitterAug", "LightingAug", "ColorNormalizeAug",
           "RandomGrayAug", "CreateAugmenter"]


def _nd(x) -> NDArray:
    """A host array as an NDArray on the current context."""
    return _array(np.ascontiguousarray(x))


def _np(img):
    return img.asnumpy() if isinstance(img, NDArray) else np.asarray(img)


def _rng():
    from .. import random as _random
    return _random.np_rng()


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def decoder() -> str:
    """The link of the codec chain that decodes a JPEG here: ``"cv2
    <version>"``, ``"PIL <version>"``, ``"libjpeg (native)"`` or
    ``"none"``."""
    cv2 = _cv2()
    if cv2 is not None:
        return f"cv2 {cv2.__version__}"
    pil = _pil_image()
    if pil is not None:
        import PIL
        return f"PIL {PIL.__version__}"
    from ..io import _native_image
    return "libjpeg (native)" if _native_image.lib() is not None \
        else "none"


def decode_to_numpy(buf: bytes, flag=1, to_rgb=True) -> np.ndarray:
    """An encoded image as an HWC uint8 numpy array, through the codec
    chain (``NPY0``, cv2, PIL, native libjpeg); raises ``MXNetError`` when
    no link decodes it."""
    if bytes(buf[:4]) == b"NPY0":
        arr = np.load(_io.BytesIO(bytes(buf[4:])))
    else:
        arr = _decode_encoded(buf, flag, to_rgb)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _decode_encoded(buf, flag, to_rgb):
    cv2 = _cv2()
    if cv2 is not None:
        arr = cv2.imdecode(np.frombuffer(buf, np.uint8), flag)
        if arr is None:
            raise MXNetError("image decode failed")
        if to_rgb and arr.ndim == 3:
            arr = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
        return arr
    pil = _pil_image()
    if pil is not None:
        try:
            return np.asarray(pil.open(_io.BytesIO(bytes(buf))))
        except OSError as e:
            raise MXNetError(f"image decode failed: {e}") from None
    from ..io import _native_image
    try:
        arr = _native_image.decode(buf, gray=flag == 0)
    except ValueError as e:
        raise MXNetError(f"image decode failed: {e}") from None
    if arr is None:
        raise MXNetError(
            f"no image decoder available (cv2, PIL, or the native libjpeg "
            f"decoder: {_native_image.build_error('mxtpu_image')})")
    return arr if to_rgb or arr.shape[2] == 1 else arr[:, :, ::-1]


def _resize_bilinear_np(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Pixel-centre bilinear resize of an HWC image (cv2's INTER_LINEAR
    convention, as the native decoder's resize)."""
    sh, sw = img.shape[:2]
    if (sh, sw) == (h, w):
        return img
    fy = np.clip((np.arange(h) + 0.5) * (sh / h) - 0.5, 0, sh - 1)
    fx = np.clip((np.arange(w) + 0.5) * (sw / w) - 0.5, 0, sw - 1)
    y0 = fy.astype(np.int64)
    x0 = fx.astype(np.int64)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    wy = (fy - y0)[:, None, None]
    wx = (fx - x0)[None, :, None]
    im = img.astype(np.float32)
    out = (im[y0][:, x0] * (1 - wy) * (1 - wx)
           + im[y0][:, x1] * (1 - wy) * wx
           + im[y1][:, x0] * wy * (1 - wx)
           + im[y1][:, x1] * wy * wx)
    return (out + 0.5).astype(img.dtype)


def _decode_resize_py(payload: bytes, h: int, w: int) -> np.ndarray:
    """One image through the codec chain and a bilinear resize, as
    ``(h, w, 3)`` uint8."""
    img = decode_to_numpy(payload)
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    elif img.shape[2] > 3:
        img = img[:, :, :3]
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        if img.ndim == 2:
            img = img[:, :, None].repeat(3, axis=2)
    else:
        img = _resize_bilinear_np(img, h, w)
    return np.ascontiguousarray(img[:, :, :3]).astype(np.uint8)


def imdecode_resize_batch(payloads, h: int, w: int, n_threads: int = 0):
    """JPEGs decoded and resized (bilinear) to ``(N, h, w, 3)`` uint8 RGB
    on the native decoder's thread pool; a batch it refuses (``NPY0``,
    PNG, CMYK) or a missing library takes the codec chain image by
    image. Returns a host numpy array."""
    from ..io import _native_image
    try:
        out = _native_image.decode_batch(payloads, h, w,
                                         n_threads=n_threads)
        if out is not None:
            return out
    except ValueError:
        pass
    res = np.empty((len(payloads), h, w, 3), np.uint8)
    for i, p in enumerate(payloads):
        res[i] = _decode_resize_py(p, h, w)
    return res


def imdecode(buf: bytes, flag=1, to_rgb=True) -> NDArray:
    """An encoded image as an HWC uint8 NDArray (parity:
    ``mx.image.imdecode``)."""
    return _nd(decode_to_numpy(buf, flag, to_rgb))


def imread(filename: str, flag=1, to_rgb=True) -> NDArray:
    if filename.endswith(".npy"):
        arr = np.load(filename)
        return _nd(arr[:, :, None] if arr.ndim == 2 else arr)
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb)


def imresize(src, w, h, interp=1) -> NDArray:
    """Nearest-row / nearest-column resize to ``(h, w)``."""
    x = _np(src)
    rows = (np.arange(h) * x.shape[0] / h).astype(np.int32)
    cols = (np.arange(w) * x.shape[1] / w).astype(np.int32)
    return _nd(x[rows][:, cols])


def resize_short(src, size, interp=1) -> NDArray:
    x = _np(src)
    H, W = x.shape[:2]
    if H < W:
        h, w = size, int(W * size / H)
    else:
        h, w = int(H * size / W), size
    return imresize(x, w, h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=1) -> NDArray:
    """The ``(w, h)`` window at ``(x0, y0)``, resized to ``size = (w, h)``
    when given."""
    x = _np(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != tuple(size):
        return imresize(x, size[0], size[1], interp)
    return _nd(x)


def center_crop(src, size, interp=1):
    x = _np(src)
    H, W = x.shape[:2]
    w, h = size
    x0 = max((W - w) // 2, 0)
    y0 = max((H - h) // 2, 0)
    return fixed_crop(x, x0, y0, w, h), (x0, y0, w, h)


def random_crop(src, size, interp=1):
    x = _np(src)
    H, W = x.shape[:2]
    w, h = size
    rng = _rng()
    x0 = rng.randint(0, max(W - w, 0) + 1)
    y0 = rng.randint(0, max(H - h, 0) + 1)
    return fixed_crop(x, x0, y0, w, h), (x0, y0, w, h)


def random_size_crop(src, size, area, ratio, interp=1, **kwargs):
    """A random area / aspect crop resized to ``size`` (the Inception
    training crop); ``area`` a (min, max) fraction or a scalar min; a
    centre crop when 10 draws find no box that fits."""
    x = _np(src)
    H, W = x.shape[:2]
    src_area = H * W
    if np.isscalar(area):
        area = (area, 1.0)
    rng = _rng()
    for _ in range(10):
        target_area = rng.uniform(area[0], area[1]) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(rng.uniform(*log_ratio))
        w = int(round(np.sqrt(target_area * new_ratio)))
        h = int(round(np.sqrt(target_area / new_ratio)))
        if w <= W and h <= H:
            x0 = rng.randint(0, W - w + 1)
            y0 = rng.randint(0, H - h + 1)
            return fixed_crop(x, x0, y0, w, h, size, interp), (x0, y0, w, h)
    cw, ch = min(size[0], W), min(size[1], H)
    x0 = max((W - cw) // 2, 0)
    y0 = max((H - ch) // 2, 0)
    return fixed_crop(x, x0, y0, cw, ch, size, interp), (x0, y0, cw, ch)


def copyMakeBorder(src, top, bot, left, right, type=0, values=0.0):
    """A constant border (``cv2.BORDER_CONSTANT``, ``type=0``, only)."""
    if type != 0:
        raise MXNetError(f"copyMakeBorder: only BORDER_CONSTANT (type=0) "
                         f"is implemented, got type={type}")
    x = _np(src)
    pads = [(top, bot), (left, right)] + [(0, 0)] * (x.ndim - 2)
    return _nd(np.pad(x, pads, mode="constant", constant_values=values))


def imrotate(src, rotation_degrees, zoom_in=False, zoom_out=False):
    """Rotation about the centre with bilinear sampling, zero outside;
    ``zoom_in`` scales so no padding shows, ``zoom_out`` so nothing is
    lost."""
    if zoom_in and zoom_out:
        raise MXNetError("imrotate: zoom_in and zoom_out are exclusive")
    x = _np(src).astype(np.float32)
    H, W = x.shape[:2]
    theta = np.deg2rad(float(rotation_degrees))
    c, s = np.cos(theta), np.sin(theta)
    scale = 1.0
    if zoom_in:
        scale = min(W / (abs(W * c) + abs(H * s)),
                    H / (abs(W * s) + abs(H * c)))
    elif zoom_out:
        scale = max((abs(W * c) + abs(H * s)) / W,
                    (abs(W * s) + abs(H * c)) / H)
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    xs = (xx - cx) * scale
    ys = (yy - cy) * scale
    xsrc = c * xs + s * ys + cx
    ysrc = -s * xs + c * ys + cy
    x0 = np.floor(xsrc).astype(np.int32)
    y0 = np.floor(ysrc).astype(np.int32)
    fx = (xsrc - x0)[..., None]
    fy = (ysrc - y0)[..., None]

    def _at(yi, xi):
        valid = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W))[..., None]
        samp = x[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
        return np.where(valid, samp, 0.0)

    out = ((1 - fy) * ((1 - fx) * _at(y0, x0) + fx * _at(y0, x0 + 1))
           + fy * ((1 - fx) * _at(y0 + 1, x0) + fx * _at(y0 + 1, x0 + 1)))
    return _nd(out.astype(np.float32))


def random_rotate(src, angle_limits, zoom_in=False, zoom_out=False):
    lo, hi = angle_limits
    angle = float(_rng().uniform(lo, hi))
    return imrotate(src, angle, zoom_in=zoom_in, zoom_out=zoom_out)


def color_normalize(src, mean, std=None) -> NDArray:
    x = _np(src).astype(np.float32) - np.asarray(mean, np.float32)
    if std is not None:
        x = x / np.asarray(std, np.float32)
    return _nd(x)


class ImageIter:
    """Image iterator over a ``.rec`` (parity surface:
    ``mx.image.ImageIter``): ``io.ImageRecordIter`` underneath."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 shuffle=False, **kwargs):
        if path_imgrec is None:
            raise MXNetError("ImageIter requires path_imgrec")
        from ..io import ImageRecordIter
        self._inner = ImageRecordIter(
            path_imgrec=path_imgrec, data_shape=data_shape,
            batch_size=batch_size, shuffle=shuffle, **kwargs)

    def __iter__(self):
        return iter(self._inner)

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


# ------------------------------------------------------------------ #
# augmenters (parity: mx.image's Augmenter classes and CreateAugmenter)
# ------------------------------------------------------------------ #
_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


class Augmenter:
    """``aug(src) -> NDArray``; ``dumps()`` is its JSON description."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([type(self).__name__, self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size = size  # (w, h)
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _rng().rand() < self.p:
            return _nd(_np(src)[:, ::-1])
        return src if isinstance(src, NDArray) else _nd(src)


class CastAug(Augmenter):
    def __init__(self, dtype="float32"):
        super().__init__(dtype=dtype)
        self.dtype = dtype

    def __call__(self, src):
        return _nd(_np(src).astype(self.dtype))


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + (_rng().rand() * 2 - 1) * self.brightness
        return _nd(_np(src).astype(np.float32) * alpha)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        x = _np(src).astype(np.float32)
        alpha = 1.0 + (_rng().rand() * 2 - 1) * self.contrast
        gray = (x * _GRAY).sum(axis=-1, keepdims=True)
        return _nd(x * alpha + gray.mean() * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        x = _np(src).astype(np.float32)
        alpha = 1.0 + (_rng().rand() * 2 - 1) * self.saturation
        gray = (x * _GRAY).sum(axis=-1, keepdims=True)
        return _nd(x * alpha + gray * (1.0 - alpha))


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        x = _np(src).astype(np.float32)
        alpha = (_rng().rand() * 2 - 1) * self.hue
        # a rotation in YIQ space (MXNet's approximation)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        t_yiq = np.array([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]], np.float32)
        t_rgb = np.array([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]], np.float32)
        rot = np.array([[1, 0, 0], [0, u, -w], [0, w, u]], np.float32)
        m = t_rgb @ rot @ t_yiq
        return _nd(x @ m.T)


class ColorJitterAug(Augmenter):
    """Brightness, contrast and saturation jitter in a random order."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        self._augs = []
        if brightness:
            self._augs.append(BrightnessJitterAug(brightness))
        if contrast:
            self._augs.append(ContrastJitterAug(contrast))
        if saturation:
            self._augs.append(SaturationJitterAug(saturation))

    def __call__(self, src):
        augs = list(self._augs)
        _rng().shuffle(augs)
        for a in augs:
            src = a(src)
        return src if isinstance(src, NDArray) else _nd(src)


class LightingAug(Augmenter):
    """AlexNet's PCA lighting noise."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = _rng().normal(0, self.alphastd, size=(3,)).astype(np.float32)
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return _nd(_np(src).astype(np.float32) + rgb)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        x = _np(src).astype(np.float32)
        if _rng().rand() < self.p:
            x = np.repeat((x * _GRAY).sum(-1, keepdims=True), 3, -1)
        return _nd(x)


IMAGENET_MEAN = (123.68, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=1):
    """The standard augmenter list (parity: ``mx.image.CreateAugmenter``);
    ``mean=True`` / ``std=True`` are ImageNet's."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.814],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array(IMAGENET_MEAN)
    if std is True:
        std = np.array(IMAGENET_STD)
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


from . import detection  # noqa: E402,F401
from .detection import (DetAugmenter, DetForceResizeAug,  # noqa: E402,F401
                        DetHorizontalFlipAug, DetRandomCropAug,
                        DetRandomSelectAug, DetResizeShortAug,
                        DetNormalizeAug, CreateDetAugmenter, ImageDetIter)
