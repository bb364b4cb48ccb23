"""Custom operators in Python (``mx.operator``): the port of the JAX
package's ``incubator_mxnet_tpu/operator.py`` (parity:
``python/mxnet/operator.py``, ``CustomOp`` / ``CustomOpProp`` and
``mx.nd.Custom``).

A Custom op is a ``torch.autograd.Function`` whose forward and backward
copy their inputs to the host, run the user's numpy ``forward`` /
``backward`` there and copy the results back to the inputs' device, so
it records under ``autograd.record()`` like any registered op (the JAX
package runs the same callbacks through ``jax.pure_callback`` under a
``custom_vjp``; its backward recomputes the forward's outputs, as this
one does).

A host callback cannot run inside a CUDA graph capture, where the JAX
``pure_callback`` works under ``jit``: called while the current stream
is capturing, ``nd.Custom`` raises ``MXNetError`` naming the capture (a
departure by design, ROADMAP), before any CUDA call could fail.
"""

from __future__ import annotations

from typing import Dict, List, Type

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray
from .ndarray.ndarray import from_host, host_array, np_dtype

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered",
           "custom"]

_CUSTOM_REGISTRY: Dict[str, Type["CustomOpProp"]] = {}


class CustomOp:
    """User op: override ``forward`` / ``backward`` (numpy arrays); use
    ``assign`` to honor the write / add / null request (parity:
    mx.operator.CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise MXNetError(
            f"{type(self).__name__}.backward not implemented")

    @staticmethod
    def assign(dst, req, src):
        if req == "null":
            return
        src = np.asarray(src, dtype=dst.dtype)
        if req == "add":
            dst += src
        else:  # write / inplace
            dst[...] = src


class CustomOpProp:
    """Shape/type inference + operator factory
    (parity: mx.operator.CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError


def register(reg_name: str):
    """Class decorator registering a CustomOpProp under ``op_type``
    (parity: mx.operator.register)."""

    def _deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls

    return _deco


def get_all_registered() -> List[str]:
    return sorted(_CUSTOM_REGISTRY)


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class _CustomFunction(torch.autograd.Function):
    """The user's numpy forward / backward on the host."""

    @staticmethod
    def forward(fctx, call, *xs):
        fctx.call = call
        fctx.save_for_backward(*xs)
        outs = call.forward_np([host_array(x) for x in xs])
        dev = xs[0].device
        return tuple(from_host(o).to(dev) for o in outs)

    @staticmethod
    def backward(fctx, *cots):
        if _capturing():
            raise MXNetError("nd.Custom: the backward of a custom op runs "
                             "on the host and cannot run inside a CUDA "
                             "graph capture")
        xs = fctx.saved_tensors
        grads = fctx.call.backward_np([host_array(x) for x in xs],
                                      [host_array(c) for c in cots])
        dev = xs[0].device
        return (None,) + tuple(from_host(g).to(dev) for g in grads)


class _Call:
    """One invocation's operator, shapes and dtypes."""

    def __init__(self, op, in_shapes, in_types, out_shapes, out_types):
        self.op = op
        self.in_shapes, self.in_types = in_shapes, in_types
        self.out_shapes, self.out_types = out_shapes, out_types

    def forward_np(self, in_data):
        out_data = [np.zeros(s, t)
                    for s, t in zip(self.out_shapes, self.out_types)]
        self.op.forward(True, ["write"] * len(out_data), in_data, out_data,
                        [])
        return out_data

    def backward_np(self, in_data, cots):
        out_data = self.forward_np(in_data)
        in_grad = [np.zeros(s, t)
                   for s, t in zip(self.in_shapes, self.in_types)]
        self.op.backward(["write"] * len(in_data), cots, in_data, out_data,
                         in_grad, [])
        return in_grad


def custom(*inputs, op_type: str, **kwargs):
    """Invoke a registered custom op (parity: ``mx.nd.Custom``);
    differentiable through the user's ``CustomOp.backward``."""
    if op_type not in _CUSTOM_REGISTRY:
        raise MXNetError(
            f"custom op {op_type!r} not registered; known: "
            f"{get_all_registered()}")
    if _capturing():
        raise MXNetError(
            f"nd.Custom({op_type!r}) runs its operator on the host and "
            f"cannot run inside a CUDA graph capture (a CUDA graph "
            f"replays device work only)")
    from . import autograd
    from .context import current_context
    prop = _CUSTOM_REGISTRY[op_type](**kwargs)
    dev = next((x._data.device for x in inputs if isinstance(x, NDArray)),
               None) or current_context().torch_device
    arrs = [x._data if isinstance(x, NDArray)
            else from_host(np.asarray(x)).to(dev) for x in inputs]
    in_shapes = [tuple(a.shape) for a in arrs]
    in_types = [np_dtype(a.dtype) for a in arrs]
    shapes = prop.infer_shape(list(map(list, in_shapes)))
    out_shapes = [tuple(s) for s in shapes[1]]
    out_types = list(prop.infer_type(list(in_types))[1])
    op = prop.create_operator(None, in_shapes, in_types)
    call = _Call(op, in_shapes, in_types, out_shapes, out_types)
    with torch.set_grad_enabled(autograd.is_recording()):
        outs = _CustomFunction.apply(call, *arrs)
    outs = [NDArray(o) for o in outs]
    return outs if len(outs) > 1 else outs[0]
