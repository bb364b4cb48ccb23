"""Imperative op dispatch: the port of the JAX package's
``incubator_mxnet_tpu/ndarray/register.py``.

``imperative_invoke`` runs a registered op on ``NDArray`` inputs: it
resolves ``training=`` from ``autograd.is_training()`` for
training-aware ops, passes ``mx.random``'s generator for the input's
device (``ctx``'s, or the current context's, for a sampler without array
inputs, which then draws on that device) to ops that draw random numbers, unwraps the arrays (positional,
keyword, and inside lists), and calls the op under
``torch.set_grad_enabled(autograd.is_recording())``: MXNet records only
inside ``autograd.record()``, so outside it no op builds a graph, even on
a parameter. A shape or type error of the op surfaces as ``MXNetError``;
under ``engine.set_sync(True)`` each op waits for its device.
``make_op_function`` builds the ``mx.nd.<op>`` functions.
"""

from __future__ import annotations

import torch

from .. import autograd, engine as _engine, random as _random
from ..base import MXNetError
from ..context import current_context
from ..ops import registry as _reg
from .ndarray import NDArray

__all__ = ["imperative_invoke", "invoke_by_name", "make_op_function"]


def _unwrap(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    return x


def _first_device(args):
    for a in args:
        if isinstance(a, NDArray):
            return a._data.device
        if isinstance(a, (list, tuple)):
            d = _first_device(a)
            if d is not None:
                return d
    return None


def imperative_invoke(spec: _reg.OpSpec, *args, out=None, ctx=None,
                      **kwargs):
    """Run a registered op eagerly on ``NDArray`` inputs; returns an
    ``NDArray`` (a list for several outputs), or writes into ``out``."""
    if spec.training_aware and kwargs.get("training") is None:
        kwargs["training"] = autograd.is_training()
    if spec.needs_key and kwargs.get("generator") is None and not (
            spec.training_aware and not kwargs["training"]
            and kwargs.get("mode", "training") != "always"):
        dev = _first_device(args) or _first_device(kwargs.values())
        if dev is None:          # a sampler without array inputs
            dev = (ctx or current_context()).torch_device
        kwargs["generator"] = _random.generator(dev)
    call_args = [_unwrap(a) for a in args]
    call_kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
    try:
        with torch.set_grad_enabled(autograd.is_recording()):
            result = spec.fn(*call_args, **call_kwargs)
            if ctx is not None:
                result = _unwrap(_to_ctx(result, ctx))
    except MXNetError:
        raise
    except (TypeError, ValueError, IndexError, RuntimeError) as e:
        raise MXNetError(f"operator {spec.name} failed: {e}") from e
    multi = isinstance(result, (tuple, list))
    outs = [NDArray(r) for r in (result if multi else (result,))]
    if _engine.is_sync():
        _engine._maybe_sync(outs)
    if out is not None:
        targets = out if isinstance(out, (tuple, list)) else (out,)
        with torch.no_grad():
            for t, o in zip(targets, outs):
                t._data.copy_(o._data)
        return out
    return outs if multi else outs[0]


def _to_ctx(result, ctx):
    dev = ctx.torch_device
    if isinstance(result, (tuple, list)):
        return type(result)(r.to(dev) for r in result)
    return result.to(dev)


def invoke_by_name(name: str, *args, **kwargs):
    return imperative_invoke(_reg.get(name), *args, **kwargs)


def make_op_function(spec: _reg.OpSpec, public_name: str):
    """The module-level function surfaced as ``mx.nd.<name>``."""

    def op_function(*args, **kwargs):
        return imperative_invoke(spec, *args, **kwargs)

    op_function.__name__ = public_name
    op_function.__qualname__ = public_name
    op_function.__doc__ = _reg.describe_op(spec.name)
    return op_function
