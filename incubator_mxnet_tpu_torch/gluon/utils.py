"""Gluon utilities: the port of the JAX package's
``incubator_mxnet_tpu/gluon/utils.py`` (``split_data``,
``split_and_load``, ``clip_global_norm``, ``check_sha1``, ``download``).
"""

from __future__ import annotations

import hashlib
import os
import urllib.request
import warnings
from typing import List, Sequence

import torch

from ..base import MXNetError
from ..context import Context
from ..ndarray import NDArray
from ..ndarray import array as _array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data: NDArray, num_slice: int, batch_axis: int = 0,
               even_split: bool = True) -> List[NDArray]:
    """``data`` in ``num_slice`` slices along ``batch_axis`` (the last
    takes the remainder unless ``even_split`` refuses one)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}")
    step = size // num_slice
    return [data._op("slice_axis", axis=batch_axis, begin=i * step,
                     end=(i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list: Sequence[Context], batch_axis: int = 0,
                   even_split: bool = True) -> List[NDArray]:
    """A batch split across ``ctx_list``, one slice on each context; an
    array-like that is not an ``NDArray`` is made one on the first
    context."""
    if not isinstance(data, NDArray):
        data = _array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays: Sequence[NDArray], max_norm: float,
                     check_isfinite: bool = True) -> float:
    """Rescale ``arrays`` in place so their joint L2 norm (summed in f32)
    is at most ``max_norm``; returns the norm before clipping (one
    readback)."""
    with torch.no_grad():
        norm = torch.sqrt(sum(a._data.float().square().sum()
                              for a in arrays))
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        for a in arrays:
            a._data.copy_(a._data.float() * scale.to(a._data.device))
    norm_val = float(norm)
    if check_isfinite and not (norm_val == norm_val
                               and abs(norm_val) != float("inf")):
        warnings.warn(f"nan or inf is detected. Clipping results will be "
                      f"undefined: norm={norm_val}")
    return norm_val


def check_sha1(filename, sha1_hash) -> bool:
    """True iff the file's SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1048576), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None,
             retries=5, verify_ssl=True):
    """Fetch ``url`` to ``path`` (a file or a directory; default the
    URL's file name), unless a file with the right SHA-1 is there. Without
    a network the underlying ``URLError`` is raised after ``retries``
    tries."""
    fname = path or url.split("/")[-1]
    if os.path.isdir(fname):
        fname = os.path.join(fname, url.split("/")[-1])
    if not overwrite and os.path.exists(fname) and (
            sha1_hash is None or check_sha1(fname, sha1_hash)):
        return fname
    d = os.path.dirname(os.path.abspath(fname))
    os.makedirs(d, exist_ok=True)
    last = None
    for _ in range(max(1, retries)):
        try:
            urllib.request.urlretrieve(url, fname)
            if sha1_hash and not check_sha1(fname, sha1_hash):
                raise OSError(f"sha1 mismatch for {fname}")
            return fname
        except Exception as e:  # retry transient network errors
            last = e
    raise last
