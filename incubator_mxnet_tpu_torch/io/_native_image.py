"""The native JPEG decoder (``csrc/io/image_decode_native.cc``) through
ctypes: the port of the JAX package's
``incubator_mxnet_tpu/io/_native_image.py``, with ``decode`` (one image at
its full size, the last link of ``mx.image``'s codec chain) added.

Built with ``g++ ... -ljpeg`` on first use, as ``_native.build_library``
builds; where libjpeg's headers are missing it does not build, ``lib()``
is None and every function here returns None (``build_error
("mxtpu_image")`` says why). The calls run without the interpreter lock,
so threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

from ._native import build_error, build_library

__all__ = ["lib", "decode", "decode_batch", "image_dims", "build_error"]


def lib() -> Optional[ctypes.CDLL]:
    lib_ = build_library("mxtpu_image", "image_decode_native.cc",
                         libs=("-ljpeg",))
    if lib_ is None or hasattr(lib_, "_declared"):
        return lib_
    c = ctypes
    lib_.mxtpu_img_dims.restype = c.c_int
    lib_.mxtpu_img_dims.argtypes = [c.c_char_p, c.c_int64,
                                    c.POINTER(c.c_int), c.POINTER(c.c_int)]
    lib_.mxtpu_img_decode.restype = c.c_int
    lib_.mxtpu_img_decode.argtypes = [
        c.c_char_p, c.c_int64, c.c_int, c.c_void_p, c.c_int64,
        c.POINTER(c.c_int), c.POINTER(c.c_int)]
    lib_.mxtpu_img_decode_batch.restype = c.c_int
    lib_.mxtpu_img_decode_batch.argtypes = [
        c.c_char_p, c.c_void_p, c.c_void_p, c.c_int64, c.c_int, c.c_int,
        c.c_void_p, c.c_int]
    lib_._declared = True
    return lib_


def image_dims(payload: bytes):
    """``(width, height)`` of a JPEG from its header; None without the
    library; ``ValueError`` when the header does not parse."""
    lib_ = lib()
    if lib_ is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib_.mxtpu_img_dims(payload, len(payload), ctypes.byref(w),
                           ctypes.byref(h)) != 0:
        raise ValueError("native JPEG header parse failed")
    return w.value, h.value


def decode(payload: bytes, gray: bool = False) -> Optional[np.ndarray]:
    """One JPEG at its full size: ``(h, w, 3)`` uint8 RGB, or ``(h, w, 1)``
    with ``gray``; None without the library; ``ValueError`` when it does
    not decode (a PNG, a CMYK JPEG, bad bytes)."""
    lib_ = lib()
    if lib_ is None:
        return None
    payload = bytes(payload)
    width, height = image_dims(payload)
    c = 1 if gray else 3
    out = np.empty((height, width, c), np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib_.mxtpu_img_decode(payload, len(payload), int(gray),
                               out.ctypes.data, out.nbytes, ctypes.byref(w),
                               ctypes.byref(h))
    if rc != 0 or (h.value, w.value) != (height, width):
        raise ValueError(f"native JPEG decode failed (code {rc})")
    return out


def decode_batch(payloads: Sequence[bytes], out_h: int, out_w: int,
                 n_threads: int = 0) -> Optional[np.ndarray]:
    """JPEGs to ``(N, out_h, out_w, 3)`` uint8 RGB with a bilinear resize,
    on a C++ thread pool; None without the library; ``ValueError`` on a
    payload that does not decode."""
    lib_ = lib()
    if lib_ is None:
        return None
    if not payloads:
        return np.zeros((0, out_h, out_w, 3), np.uint8)
    blob = b"".join(payloads)
    lengths = np.array([len(p) for p in payloads], np.int64)
    offsets = np.zeros(len(payloads), np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    out = np.empty((len(payloads), out_h, out_w, 3), np.uint8)
    if n_threads <= 0:
        n_threads = min(len(payloads), os.cpu_count() or 4)
    rc = lib_.mxtpu_img_decode_batch(
        blob, offsets.ctypes.data, lengths.ctypes.data, len(payloads),
        out_h, out_w, out.ctypes.data, n_threads)
    if rc != 0:
        raise ValueError(
            f"native JPEG decode failed for batch item {-rc - 1}")
    return out
