"""Control flow: the port of the JAX package's
``incubator_mxnet_tpu/ops/control_flow.py`` (``nd.contrib.foreach`` /
``while_loop`` / ``cond``), as eager Python over NDArrays.

The JAX package runs these as ``lax.scan`` / ``lax.while_loop`` /
``lax.cond`` outside ``autograd.record()`` and as this same eager loop
inside it; the port always runs the loop, so every op of the body lands
on the autograd graph. The contracts are the JAX package's:

  - ``foreach(body, data, init_states)``: body(slice, states) ->
    (step output, new states) over axis 0 of ``data`` (an NDArray or a
    list of them); returns (the outputs stacked, the final states);
  - ``while_loop(cond, func, loop_vars, max_iterations)``: at most
    ``max_iterations`` steps while ``cond(*loop_vars)`` holds (read on
    the host each step); the outputs stacked into a fixed
    (max_iterations, ...) buffer, zeros past the last step, and the final
    loop variables;
  - ``cond(pred, then_func, else_func)``: the branch ``pred`` (read on
    the host) selects, called with no arguments.

A loop that runs no step learns its outputs' shapes from one call of the
body on meta tensors (no data, no device work), as the JAX package's
``eval_shape`` does.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..base import MXNetError

__all__ = ["foreach", "while_loop", "cond"]


def _nd():
    from .. import ndarray
    return ndarray


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _host_true(c) -> bool:
    t = c._data if hasattr(c, "_data") else torch.as_tensor(c)
    return bool(t.bool().all())


def _meta(x, drop_first=False):
    """NDArrays (nested in lists) as meta NDArrays of the same dtype and
    shape (without the first axis when ``drop_first``)."""
    if isinstance(x, (list, tuple)):
        return [_meta(v, drop_first) for v in x]
    shape = x.shape[1:] if drop_first else x.shape
    return _nd().NDArray(torch.empty(shape, dtype=x._data.dtype,
                                     device="meta"))


def _stack(rows):
    return _nd().stack(*rows, axis=0)


def _zeros(shape, dtype, device, rows):
    return _nd().NDArray(torch.zeros((rows,) + tuple(shape), dtype=dtype,
                                     device=device))


def foreach(body: Callable, data, init_states):
    """Run ``body`` over axis 0 of ``data``; returns (stacked outputs,
    final states), lists where the body returns lists."""
    multi = isinstance(data, (list, tuple))
    first = data[0] if multi else data
    states, outs = init_states, []
    for i in range(first.shape[0]):
        out, states = body([d[i] for d in data] if multi else data[i],
                           states)
        outs.append(_as_list(out))
    if outs:
        stacked = [_stack([o[k] for o in outs]) for k in range(len(outs[0]))]
    else:
        out, _ = body(_meta(data, drop_first=True), _meta(init_states))
        stacked = [_zeros(o.shape, o._data.dtype, first._data.device, 0)
                   for o in _as_list(out)]
    if len(stacked) == 1 and not isinstance(out, (list, tuple)):
        stacked = stacked[0]
    return stacked, (list(states) if isinstance(states, tuple) else states)


def while_loop(cond_fn: Callable, func: Callable, loop_vars,
               max_iterations: int):
    """Returns (outputs (max_iterations, ...) zero-padded, final
    loop_vars)."""
    if max_iterations is None or int(max_iterations) <= 0:
        raise MXNetError("while_loop needs a positive max_iterations")
    M = int(max_iterations)
    single = not isinstance(loop_vars, (list, tuple))
    vars_ = _as_list(loop_vars)
    outs = []
    while len(outs) < M and _host_true(cond_fn(*vars_)):
        out, new_vars = func(*vars_)
        vars_ = _as_list(new_vars)
        outs.append(_as_list(out))
    if outs:
        cols = [[o[j] for o in outs] for j in range(len(outs[0]))]
        bufs = [_stack(rows + [rows[0].zeros_like()] * (M - len(rows)))
                for rows in cols]
    else:
        out, _ = func(*_meta(vars_))
        bufs = [_zeros(o.shape, o._data.dtype, vars_[0]._data.device, M)
                for o in _as_list(out)]
    return (bufs[0] if len(bufs) == 1 else bufs), \
        (vars_[0] if single else vars_)


def cond(pred, then_func: Callable, else_func: Callable):
    """``then_func()`` where ``pred`` holds, else ``else_func()``."""
    return then_func() if _host_true(pred) else else_func()
