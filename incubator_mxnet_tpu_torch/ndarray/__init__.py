"""``mx.nd``: the imperative NDArray front end (the port of the JAX
package's ``incubator_mxnet_tpu/ndarray/__init__.py``).

Every registered op is surfaced as a generated function (``nd.<op>``, its
aliases included). The creation functions place their result on ``ctx``,
or on the current context (``gpu(0)`` unless a ``with mx.cpu():`` block
says otherwise; without CUDA that raises ``MXNetError``). Python lists
and float64 / int64 numpy arrays enter as float32 / int32, the JAX
package's 32-bit defaults. ``waitall`` waits for the device, ``save`` /
``load`` use ``utils.serialization`` (the JAX package's two formats),
``nd.random`` maps onto the registered samplers (``mx.random``'s
generator for the device), ``nd.linalg`` and ``nd.contrib`` surface the
``linalg_*`` and ``_contrib_*`` ops (with ``foreach`` / ``while_loop`` /
``cond``), ``nd.sparse`` the row-sparse and CSR storage types
(``cast_storage`` too) and ``nd.Custom`` the operators of
``mx.operator``.
"""

from __future__ import annotations

import sys as _sys

import numpy as _onp
import torch as _torch

from .. import ops as _ops  # noqa: F401  (registers the ops)
from ..base import MXNetError
from ..context import Context, current_context
from ..ops import registry as _registry
from . import ndarray
from .ndarray import NDArray, from_host, to_torch_dtype
from .register import imperative_invoke, invoke_by_name, make_op_function

_THIS = _sys.modules[__name__]

for _name in _registry.list_all_names():
    if not hasattr(_THIS, _name):
        setattr(_THIS, _name, make_op_function(_registry.get(_name), _name))


def _device(ctx):
    if ctx is None:
        ctx = current_context()
    if not isinstance(ctx, Context):
        ctx = Context(ctx)
    return ctx.torch_device


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def array(source_array, ctx=None, dtype=None) -> NDArray:
    """An NDArray from any array-like (parity: ``mx.nd.array``)."""
    dev = _device(ctx)
    if isinstance(source_array, NDArray):
        t = source_array._data.detach()
        if dtype is not None:
            t = t.to(to_torch_dtype(dtype))
        return NDArray(t.to(dev, copy=True))
    if _torch.is_tensor(source_array):
        t = source_array.detach()
    else:
        is_np = isinstance(source_array, _onp.ndarray)
        a = _onp.asarray(source_array)
        if dtype is None:
            if a.dtype == _onp.float64 or (
                    not is_np and a.dtype.kind in "fiu"):
                a = a.astype(_onp.float32)
            elif a.dtype == _onp.int64:
                a = a.astype(_onp.int32)
        t = from_host(a)
    if dtype is not None:
        t = t.to(to_torch_dtype(dtype))
    return NDArray(t.to(dev))


def zeros(shape, ctx=None, dtype="float32") -> NDArray:
    return NDArray(_torch.zeros(_shape(shape), dtype=to_torch_dtype(dtype),
                                device=_device(ctx)))


def ones(shape, ctx=None, dtype="float32") -> NDArray:
    return NDArray(_torch.ones(_shape(shape), dtype=to_torch_dtype(dtype),
                               device=_device(ctx)))


def full(shape, val, ctx=None, dtype="float32") -> NDArray:
    return NDArray(_torch.full(_shape(shape), val,
                               dtype=to_torch_dtype(dtype),
                               device=_device(ctx)))


def empty(shape, ctx=None, dtype="float32") -> NDArray:
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype="float32") -> NDArray:
    """``[start, stop)`` by ``step``, each value ``repeat`` times (made on
    the device: no host copy)."""
    if stop is None:
        start, stop = 0, start
    out = _torch.arange(start, stop, step, dtype=_torch.float64,
                        device=_device(ctx)).to(to_torch_dtype(dtype))
    if repeat > 1:
        out = out.repeat_interleave(repeat)
    return NDArray(out)


def linspace(start, stop, num, endpoint=True, ctx=None,
             dtype="float32") -> NDArray:
    """``num`` evenly spaced values over [start, stop] (``stop``
    excluded unless ``endpoint``)."""
    if endpoint:
        out = _torch.linspace(start, stop, num, dtype=_torch.float64,
                              device=_device(ctx))
    else:
        out = _torch.linspace(start, stop, num + 1, dtype=_torch.float64,
                              device=_device(ctx))[:num]
    return NDArray(out.to(to_torch_dtype(dtype)))


def eye(N, M=0, k=0, ctx=None, dtype="float32") -> NDArray:
    """An N x M (N x N when M is 0) array with ones on diagonal ``k``."""
    dev = _device(ctx)
    r = _torch.arange(N, device=dev)[:, None]
    c = _torch.arange(M or N, device=dev)[None, :]
    return NDArray((c - r == k).to(to_torch_dtype(dtype)))


def from_numpy(arr, zero_copy=False) -> NDArray:
    return array(arr)


def from_dlpack(capsule) -> NDArray:
    """An NDArray sharing the memory of a DLPack capsule (or of an object
    with ``__dlpack__``)."""
    return NDArray(_torch.from_dlpack(capsule))


def to_dlpack_for_read(data: NDArray):
    """A DLPack capsule of ``data``'s memory."""
    return _torch.utils.dlpack.to_dlpack(data._data.detach())


def moveaxis(data: NDArray, source, destination) -> NDArray:
    return NDArray(_torch.movedim(data._data, source, destination))


def concatenate(arrays, axis=0, always_copy=True) -> NDArray:
    return invoke_by_name("concat", list(arrays), dim=axis)


def waitall():
    """Wait until every queued device computation has finished (parity:
    ``mx.nd.waitall``)."""
    if _torch.cuda.is_available() and _torch.cuda.is_initialized():
        _torch.cuda.synchronize()


def save(fname: str, data, format: str = "mxtpu"):
    """Save a list or dict of NDArrays (``format="mxnet"`` writes MXNet
    1.x's ``.params`` layout; ``load`` reads either)."""
    from ..utils import serialization
    serialization.save_ndarrays(fname, data, format=format)


def load(fname: str, ctx=None):
    """The arrays of a ``save`` file (either format), on ``ctx`` (the
    current context when None)."""
    from ..utils import serialization
    return serialization.load_ndarrays(fname, device=_device(ctx))


class _RandomNS:
    """``mx.nd.random``: the registered samplers under their short names
    (``nd.random.uniform`` is ``random_uniform``), drawing from
    ``mx.random``'s generator for ``ctx`` (the current context when
    None)."""

    def __init__(self):
        for nm, target in [
            ("uniform", "random_uniform"), ("normal", "random_normal"),
            ("gamma", "random_gamma"), ("exponential", "random_exponential"),
            ("poisson", "random_poisson"), ("randint", "random_randint"),
            ("bernoulli", "random_bernoulli"), ("shuffle", "shuffle"),
            ("multinomial", "sample_multinomial"),
            ("laplace", "random_laplace"), ("randn", "random_randn"),
            ("negative_binomial", "random_negative_binomial"),
            ("generalized_negative_binomial",
             "random_generalized_negative_binomial"),
        ]:
            setattr(self, nm, make_op_function(_registry.get(target), nm))

    @staticmethod
    def seed(seed_state, ctx="all"):
        from .. import random as _r
        _r.seed(seed_state)


random = _RandomNS()

from . import contrib  # noqa: E402,F401  (nd.contrib)
from . import linalg  # noqa: E402,F401  (nd.linalg)
from . import sparse  # noqa: E402,F401  (nd.sparse)
from .sparse import cast_storage  # noqa: E402,F401


def Custom(*inputs, op_type=None, **kwargs):
    """A registered custom operator (parity: ``mx.nd.Custom``; see
    ``mx.operator``)."""
    if op_type is None:
        raise MXNetError("Custom requires op_type=")
    from ..operator import custom
    return custom(*inputs, op_type=op_type, **kwargs)


__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "linspace", "eye", "from_numpy", "from_dlpack",
           "to_dlpack_for_read", "moveaxis", "contrib", "linalg",
           "concatenate", "waitall", "save", "load", "random",
           "imperative_invoke", "invoke_by_name", "MXNetError", "sparse",
           "cast_storage", "Custom"]
