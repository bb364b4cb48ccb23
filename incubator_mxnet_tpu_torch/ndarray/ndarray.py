"""NDArray over ``torch.Tensor``: the port of the JAX package's
``incubator_mxnet_tpu/ndarray/ndarray.py``.

An ``NDArray`` holds one tensor (``_data``). Arithmetic, indexing and the
method sugar go through the operator registry (``ndarray.register``), so
``autograd.record()`` sees every op; the dtype a user names is MXNet's
string ('float32', 'bfloat16', ...), ``dtype`` reads back as a numpy
dtype (``ml_dtypes``' for bfloat16). PyTorch's CUDA stream is the
asynchronous engine: ``asnumpy()`` (and ``wait_to_read``) is the sync
point, as MXNet's ``WaitToRead`` is.

Autograd state lives on the array: ``_ag_grad`` (the gradient buffer of a
marked variable, an ``NDArray`` written in place by ``backward``),
``_ag_grad_req`` ('write', 'add' or 'null') and ``_fresh`` (on a gradient
buffer: written by a backward since the Trainer's last step).

In-place operators keep MXNet's semantics under both modes: while
recording, the array takes the recorded result (its history moves on, as
the JAX array's tape node does); otherwise the result is written into the
array's own storage, so a marked variable or a parameter stays the same
tensor (CUDA graphs hold parameters by address).
"""

from __future__ import annotations

from typing import Optional

import numpy as _np
import torch

from ..base import MXNetError
from ..context import Context, context_of

__all__ = ["NDArray", "to_torch_dtype", "np_dtype", "host_array",
           "from_host"]

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def to_torch_dtype(dtype) -> Optional[torch.dtype]:
    """A ``torch.dtype`` from MXNet's dtype string, a numpy dtype or type
    (``ml_dtypes.bfloat16`` included) or a ``torch.dtype``; an unknown
    name raises ``MXNetError``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype
    else:
        try:
            name = _np.dtype(dtype).name
        except TypeError:
            raise MXNetError(f"unknown dtype {dtype!r}") from None
    if name not in _DTYPES:
        raise MXNetError(f"unknown dtype {dtype!r}")
    return _DTYPES[name]


def np_dtype(dtype: torch.dtype):
    """The numpy dtype of a ``torch.dtype`` (``ml_dtypes``' bfloat16)."""
    if dtype == torch.bfloat16:
        import ml_dtypes
        return _np.dtype(ml_dtypes.bfloat16)
    return _np.dtype(_NAMES[dtype])


def host_array(t: torch.Tensor) -> _np.ndarray:
    """A numpy copy of a tensor on the host; bfloat16 keeps its bits (an
    ``ml_dtypes.bfloat16`` array)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).cpu().numpy()
        if not t.is_cuda:        # numpy() of a host tensor shares it
            bits = bits.copy()
        return bits.view(np_dtype(torch.bfloat16))
    return t.cpu().numpy() if t.is_cuda else t.numpy().copy()


def from_host(a) -> torch.Tensor:
    """A CPU tensor of its own from a numpy array (``ml_dtypes``'
    bfloat16 from its bits)."""
    a = _np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(_np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(_np.array(a, copy=True))


def _invoke(name, *args, **kwargs):
    from .register import invoke_by_name
    return invoke_by_name(name, *args, **kwargs)


class NDArray:
    """An n-dimensional array on a device, over one ``torch.Tensor``.

    Made by the factories (``mx.nd.array``, ``mx.nd.zeros``, ...); the
    constructor takes a tensor (or another ``NDArray``, whose tensor it
    shares)."""

    __slots__ = ("_data", "_ag_grad", "_ag_grad_req", "_fresh", "_hooked",
                 "__weakref__")

    def __init__(self, data):
        if isinstance(data, NDArray):
            data = data._data
        self._data = data
        self._ag_grad = None
        self._ag_grad_req = "write"
        self._hooked = None

    # ------------------------------------------------------------------ #
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def size(self) -> int:
        return int(self._data.numel())

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        return context_of(self._data.device)

    ctx = context

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._ag_grad

    @property
    def stype(self) -> str:
        return "default"

    # ------------------------------------------------------------------ #
    def asnumpy(self) -> _np.ndarray:
        """Copy to the host (the sync point)."""
        return host_array(self._data)

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(()).item()

    def item(self):
        return self.asscalar()

    def wait_to_read(self):
        """Wait until the value is computed."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of 0-d NDArray")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        shape = "x".join(map(str, self.shape)) or "scalar"
        return f"\n{self.asnumpy()!r}\n<NDArray {shape} @{self.context}>"

    # ------------------------------------------------------------------ #
    # autograd
    # ------------------------------------------------------------------ #
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Allocate a gradient buffer and mark this array as a variable
        (its recorded history, if any, is cut, as MXNet does)."""
        from .. import autograd
        buf = NDArray(torch.zeros_like(self._data.detach()))
        autograd.mark_variables([self], [buf], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach())

    # ------------------------------------------------------------------ #
    def as_in_context(self, context: Context) -> "NDArray":
        if not isinstance(context, Context):
            raise MXNetError("as_in_context expects a Context")
        from .. import autograd
        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._data.to(context.torch_device))

    as_in_ctx = as_in_context

    def copyto(self, other):
        if isinstance(other, Context):
            return self.as_in_context(other)
        with torch.no_grad():
            other._data.copy_(self._data)
        return other

    def copy(self) -> "NDArray":
        return _invoke("_copy", self)

    def astype(self, dtype, copy=True) -> "NDArray":
        """Cast; under ``record()`` the cast is on the tape."""
        d = to_torch_dtype(dtype)
        if not copy and self._data.dtype == d:
            return self
        return _invoke("cast", self, dtype=d)

    def tostype(self, stype: str) -> "NDArray":
        """This array in storage type ``stype`` ('default', 'row_sparse'
        or 'csr'; ``ndarray.sparse.cast_storage``)."""
        if stype == "default":
            return self
        from . import sparse as _sp
        return _sp.cast_storage(self, stype)

    # ------------------------------------------------------------------ #
    # indexing
    # ------------------------------------------------------------------ #
    @staticmethod
    def _index_leaf(k):
        """Array indexers: float dtypes are positions (cast to int64);
        boolean masks are refused (their output shape depends on the
        data)."""
        if isinstance(k, NDArray):
            k = k._data
        if isinstance(k, _np.ndarray):
            k = from_host(k)
        if torch.is_tensor(k):
            if k.dtype == torch.bool:
                raise MXNetError(
                    "boolean-mask indexing has a data-dependent shape; "
                    "use nd.where instead")
            if k.is_floating_point():
                k = k.long()
        return k

    def _index(self, key):
        if isinstance(key, tuple):
            return tuple(self._index_leaf(k) for k in key)
        return self._index_leaf(key)

    def __getitem__(self, key):
        return _invoke("_slice_index", self, index=self._index(key))

    def __setitem__(self, key, value):
        val = value._data if isinstance(value, NDArray) else value
        if isinstance(val, _np.ndarray):
            val = from_host(val)
        with torch.no_grad():
            self._data[self._index(key)] = val

    # ------------------------------------------------------------------ #
    # arithmetic through the op registry (so autograd records it)
    # ------------------------------------------------------------------ #
    def _scalar(self, other):
        """A python / numpy scalar or array-like as an array in this
        array's dtype and device (the JAX package's conversion)."""
        if isinstance(other, NDArray):
            return other
        dev, dt = self._data.device, self._data.dtype
        if isinstance(other, (bool, int, float, _np.generic)):
            # a fill on the device: no host copy (legal in a CUDA graph)
            return NDArray(torch.full((), other, dtype=dt, device=dev))
        return NDArray(from_host(_np.asarray(other)).to(device=dev, dtype=dt))

    def _binop(self, name, other, reverse=False):
        other = self._scalar(other)
        a, b = (other, self) if reverse else (self, other)
        return _invoke(name, a, b)

    def __add__(self, o):
        return self._binop("broadcast_add", o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop("broadcast_sub", o)

    def __rsub__(self, o):
        return self._binop("broadcast_sub", o, reverse=True)

    def __mul__(self, o):
        return self._binop("broadcast_mul", o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop("broadcast_div", o)

    def __rtruediv__(self, o):
        return self._binop("broadcast_div", o, reverse=True)

    def __mod__(self, o):
        return self._binop("broadcast_mod", o)

    def __rmod__(self, o):
        return self._binop("broadcast_mod", o, reverse=True)

    def __pow__(self, o):
        return self._binop("broadcast_power", o)

    def __rpow__(self, o):
        return self._binop("broadcast_power", o, reverse=True)

    def __neg__(self):
        return _invoke("negative", self)

    def __abs__(self):
        return _invoke("abs", self)

    def _inplace_binop(self, name, o):
        """While recording, the array takes the recorded result (its
        history moves on; a marked variable keeps its gradient buffer,
        whose hook sits on the old leaf). Otherwise the result is written
        into the array's own storage."""
        from .. import autograd
        out = self._binop(name, o)
        if autograd.is_recording():
            self._data = out._data
        else:
            with torch.no_grad():
                self._data.copy_(out._data)
        return self

    def __iadd__(self, o):
        return self._inplace_binop("broadcast_add", o)

    def __isub__(self, o):
        return self._inplace_binop("broadcast_sub", o)

    def __imul__(self, o):
        return self._inplace_binop("broadcast_mul", o)

    def __itruediv__(self, o):
        return self._inplace_binop("broadcast_div", o)

    def __eq__(self, o):
        return self._binop("broadcast_equal", o)

    def __ne__(self, o):
        return self._binop("broadcast_not_equal", o)

    def __gt__(self, o):
        return self._binop("broadcast_greater", o)

    def __ge__(self, o):
        return self._binop("broadcast_greater_equal", o)

    def __lt__(self, o):
        return self._binop("broadcast_lesser", o)

    def __le__(self, o):
        return self._binop("broadcast_lesser_equal", o)

    __hash__ = object.__hash__

    def __matmul__(self, o):
        return _invoke("dot", self, o)

    # ------------------------------------------------------------------ #
    # method sugar over the registered ops
    # ------------------------------------------------------------------ #
    def _op(self, name, *args, **kwargs):
        return _invoke(name, self, *args, **kwargs)

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.pop("shape", shape)
        return self._op("reshape", shape=tuple(shape), **kwargs)

    def reshape_like(self, other):
        return self._op("reshape_like", other)

    def transpose(self, axes=None):
        return self._op("transpose", axes=axes)

    @property
    def T(self):
        return self.transpose()

    def flatten(self):
        return self._op("flatten")

    def expand_dims(self, axis):
        return self._op("expand_dims", axis=axis)

    def squeeze(self, axis=None):
        return self._op("squeeze", axis=axis)

    def swapaxes(self, dim1, dim2):
        return self._op("swapaxes", dim1=dim1, dim2=dim2)

    def flip(self, axis):
        return self._op("flip", axis=axis)

    def tile(self, reps):
        return self._op("tile", reps=reps)

    def repeat(self, repeats, axis=None):
        return self._op("repeat", repeats=repeats, axis=axis)

    def broadcast_to(self, shape):
        return self._op("broadcast_to", shape=tuple(shape))

    def broadcast_like(self, other):
        return self._op("broadcast_like", other)

    def sum(self, axis=None, keepdims=False, exclude=False):
        return self._op("sum", axis=axis, keepdims=keepdims,
                        exclude=exclude)

    def mean(self, axis=None, keepdims=False, exclude=False):
        return self._op("mean", axis=axis, keepdims=keepdims,
                        exclude=exclude)

    def prod(self, axis=None, keepdims=False):
        return self._op("prod", axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return self._op("max", axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return self._op("min", axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._op("norm", ord=ord, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._op("argmax", axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._op("argmin", axis=axis, keepdims=keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        return self._op("argsort", axis=axis, is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return self._op("sort", axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return self._op("topk", axis=axis, k=k, ret_typ=ret_typ,
                        is_ascend=is_ascend)

    def pad(self, mode="constant", pad_width=None, constant_value=0.0):
        return self._op("pad", mode=mode, pad_width=pad_width,
                        constant_value=constant_value)

    def clip(self, a_min, a_max):
        return self._op("clip", a_min=a_min, a_max=a_max)

    def abs(self):
        return self._op("abs")

    def sign(self):
        return self._op("sign")

    def sqrt(self):
        return self._op("sqrt")

    def square(self):
        return self._op("square")

    def exp(self):
        return self._op("exp")

    def log(self):
        return self._op("log")

    def relu(self):
        return self._op("relu")

    def sigmoid(self):
        return self._op("sigmoid")

    def tanh(self):
        return self._op("tanh")

    def softmax(self, axis=-1):
        return self._op("softmax", axis=axis)

    def log_softmax(self, axis=-1):
        return self._op("log_softmax", axis=axis)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return self._op("dot", other, transpose_a=transpose_a,
                        transpose_b=transpose_b)

    def take(self, indices, axis=0, mode="clip"):
        return self._op("take", indices, axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False):
        return self._op("pick", index, axis=axis, keepdims=keepdims)

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        return self._op("one_hot", depth=depth, on_value=on_value,
                        off_value=off_value)

    def slice(self, begin, end, step=None):
        return self._op("slice", begin=begin, end=end, step=step)

    def slice_axis(self, axis, begin, end):
        return self._op("slice_axis", axis=axis, begin=begin, end=end)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return self._op("split", num_outputs=num_outputs, axis=axis,
                        squeeze_axis=squeeze_axis)

    def zeros_like(self):
        return self._op("zeros_like")

    def ones_like(self):
        return self._op("ones_like")
