"""Test utilities: the port of the JAX package's
``incubator_mxnet_tpu/test_utils.py`` (parity: ``python/mxnet/test_utils.py``):
``assert_almost_equal`` with per-dtype tolerances,
``check_numeric_gradient`` (central finite differences against autograd),
``check_consistency`` (the same computation on several contexts; by
default ``cpu()`` against ``gpu(0)``), ``default_context``, ``rand_ndarray``,
``with_seed`` and ``environment``.
"""

from __future__ import annotations

import functools
import os
import random as _pyrandom
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from . import autograd
from . import context as _ctx
from . import random as _random
from .base import MXNetError
from .ndarray import NDArray, array as nd_array
from . import ndarray as nd

__all__ = ["assert_almost_equal", "check_numeric_gradient", "check_consistency",
           "default_context", "with_seed", "rand_ndarray", "same",
           "almost_equal", "environment"]

_DTYPE_RTOL = {np.dtype(np.float16): 1e-2, np.dtype(np.float32): 1e-4,
               np.dtype(np.float64): 1e-6}
_DTYPE_ATOL = {np.dtype(np.float16): 1e-2, np.dtype(np.float32): 1e-5,
               np.dtype(np.float64): 1e-7}


def default_context() -> _ctx.Context:
    return _ctx.current_context()


def _to_np(a):
    if isinstance(a, NDArray):
        return a.asnumpy()
    return np.asarray(a)


def same(a, b) -> bool:
    return np.array_equal(_to_np(a), _to_np(b))


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False) -> bool:
    a, b = _to_np(a), _to_np(b)
    rtol = rtol or _DTYPE_RTOL.get(a.dtype, 1e-4)
    atol = atol or _DTYPE_ATOL.get(a.dtype, 1e-5)
    return np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    a_np, b_np = _to_np(a), _to_np(b)
    rtol = rtol if rtol is not None else _DTYPE_RTOL.get(np.dtype(a_np.dtype), 1e-4)
    atol = atol if atol is not None else _DTYPE_ATOL.get(np.dtype(a_np.dtype), 1e-5)
    if not np.allclose(a_np.astype(np.float64), b_np.astype(np.float64),
                       rtol=rtol, atol=atol, equal_nan=equal_nan):
        diff = np.abs(a_np.astype(np.float64) - b_np.astype(np.float64))
        rel = diff / (np.abs(b_np.astype(np.float64)) + atol)
        raise AssertionError(
            f"{names[0]} and {names[1]} differ: max abs {diff.max():.3e}, "
            f"max rel {rel.max():.3e} (rtol={rtol}, atol={atol})\n"
            f"{names[0]}: {a_np.ravel()[:8]}...\n{names[1]}: {b_np.ravel()[:8]}...")


def rand_ndarray(shape, dtype="float32", ctx=None, low=-1.0, high=1.0) -> NDArray:
    data = np.random.uniform(low, high, size=shape).astype(dtype)
    return nd_array(data, ctx=ctx)


def check_numeric_gradient(fn: Callable, inputs: Sequence[NDArray],
                           eps: float = 1e-3, rtol: float = 1e-2,
                           atol: float = 1e-3,
                           grad_nodes: Optional[Sequence[int]] = None):
    """Validate autograd gradients of ``fn`` against central finite
    differences (parity: ``check_numeric_gradient``).

    ``fn(*inputs) -> NDArray`` must return a scalar-reducible output; we
    reduce with ``sum()`` internally (matching the reference, which uses a
    random projection head — sum is the deterministic variant).
    """
    inputs = [x if isinstance(x, NDArray) else nd_array(x) for x in inputs]
    grad_nodes = list(range(len(inputs))) if grad_nodes is None else list(grad_nodes)

    # analytic gradients (float32 path)
    for i in grad_nodes:
        inputs[i].attach_grad()
    with autograd.record():
        out = fn(*inputs)
        head = out.sum() if out.shape != () else out
    head.backward()
    analytic = [inputs[i].grad.asnumpy().astype(np.float64) for i in grad_nodes]

    # numeric gradients via central differences on float64 host copies
    # (perturbed in place)
    host = [np.ascontiguousarray(x.asnumpy(), dtype=np.float64) for x in inputs]

    def eval_sum(arrs) -> float:
        nds = [nd_array(a.astype(inputs[j].dtype), ctx=inputs[j].context)
               for j, a in enumerate(arrs)]
        with autograd.pause():
            o = fn(*nds)
        return float(o.sum().asscalar() if o.shape != () else o.asscalar())

    for gi, i in enumerate(grad_nodes):
        base = host[i]
        num = np.zeros_like(base)
        for idx in np.ndindex(*base.shape):
            orig = base[idx]
            base[idx] = orig + eps
            f_plus = eval_sum(host)
            base[idx] = orig - eps
            f_minus = eval_sum(host)
            base[idx] = orig
            num[idx] = (f_plus - f_minus) / (2 * eps)
        assert_almost_equal(analytic[gi], num, rtol=rtol, atol=atol,
                            names=(f"analytic_grad[{i}]", f"numeric_grad[{i}]"))


def _check_consistency_sym(sym, ctx_list, rtol=None, atol=None):
    """The reference calling form: ``check_consistency(sym, ctx_list)``
    with ctx_list entries like ``{"ctx": mx.cpu(), "data": (2, 3),
    "type_dict": {"data": np.float16}}`` — the fp16-vs-fp32 idiom of
    tests/python/unittest/test_operator.py. One canonical set of
    random inputs/params is generated in float64 and cast per entry;
    outputs AND input gradients must agree within the loosest entry
    dtype's tolerance."""
    from .symbol.executor import Executor

    if not ctx_list:
        raise MXNetError(
            "check_consistency(sym, ctx_list): ctx_list must be a "
            "non-empty list of dicts like {'ctx': mx.cpu(), 'data': "
            "(2, 3), 'type_dict': {'data': np.float16}}")
    rng = np.random.RandomState(0)
    canonical: dict = {}
    runs = []
    worst = np.dtype(np.float64)
    for spec in ctx_list:
        spec = dict(spec)
        ctx = spec.pop("ctx", None)
        type_dict = spec.pop("type_dict", {}) or {}
        grad_req = spec.pop("grad_req", "write")
        probe = Executor.simple_bind(sym, ctx, grad_req="null", **spec)
        # MXNet's type inference: arguments the entry does not type take
        # its floating dtype (torch does not promote mixed operands)
        fdt = next((np.dtype(t) for t in type_dict.values()
                    if np.dtype(t).kind == "f"), np.dtype(np.float32))
        args = {}
        for name, arr in probe.arg_dict.items():
            dt = np.dtype(type_dict.get(name, fdt))
            if name not in canonical:
                canonical[name] = (
                    rng.randint(0, 4, arr.shape).astype(np.int64)
                    if np.issubdtype(dt, np.integer)
                    else rng.uniform(-1.0, 1.0, arr.shape))
            elif canonical[name].shape != tuple(arr.shape):
                raise MXNetError(
                    f"check_consistency: arg {name!r} has shape "
                    f"{tuple(arr.shape)} in one entry but "
                    f"{canonical[name].shape} in another — entries "
                    f"must agree on shapes")
            if np.issubdtype(dt, np.floating) and \
                    worst.itemsize > dt.itemsize:
                worst = dt
            args[name] = nd_array(canonical[name].astype(dt), ctx=ctx)
        # integer arguments (indices) take no gradient
        req = {n: grad_req if a._data.is_floating_point() else "null"
               for n, a in args.items()}
        ex = Executor(sym, ctx, args, None, req, probe.aux_dict)
        out = ex.forward(is_train=(grad_req != "null"))
        raw = [o.asnumpy() for o in out]
        outs = [r.astype(np.float64) for r in raw]
        grads = {}
        if grad_req != "null":
            # synthesized unit head gradients (in each output's own
            # dtype) make multi-output symbols comparable (the
            # reference projects with random heads)
            ex.backward([nd_array(np.ones_like(r)) for r in raw])
            grads = {n: g.asnumpy().astype(np.float64)
                     for n, g in ex.grad_dict.items()
                     if g is not None and g._data.is_floating_point()}
        runs.append((ctx, type_dict, outs, grads))
    trtol = rtol if rtol is not None else _DTYPE_RTOL.get(worst, 1e-4)
    tatol = atol if atol is not None else _DTYPE_ATOL.get(worst, 1e-5)
    ref_ctx, _, ref_outs, ref_grads = runs[0]
    for ctx, _, outs, grads in runs[1:]:
        for r0, r1 in zip(ref_outs, outs):
            assert_almost_equal(r0, r1, rtol=trtol, atol=tatol,
                                names=(f"{ref_ctx}", f"{ctx}"))
        for name in ref_grads:
            if name in grads:
                assert_almost_equal(ref_grads[name], grads[name],
                                    rtol=trtol, atol=tatol,
                                    names=(f"grad({name})@{ref_ctx}",
                                           f"grad({name})@{ctx}"))
    return [r[2] for r in runs]


def check_consistency(fn, inputs_np=None,
                      ctx_list: Optional[Sequence] = None,
                      rtol=None, atol=None):
    """Cross-context / dtype consistency (parity: ``check_consistency``).
    Two calling forms:

    - reference form: ``check_consistency(sym, [{"ctx": ..., "data":
      shape, "type_dict": {...}}, ...])`` — inputs synthesized once,
      outputs and gradients compared across entries;
    - function form: ``check_consistency(fn, inputs_np, ctx_list=
      [Context, ...])`` — the same arrays run through ``fn`` per
      context (default ``[cpu(0), gpu(0)]``)."""
    from .symbol.symbol import Symbol

    if isinstance(fn, Symbol):
        return _check_consistency_sym(fn, inputs_np or ctx_list,
                                      rtol=rtol, atol=atol)
    rtol = 1e-4 if rtol is None else rtol
    atol = 1e-5 if atol is None else atol
    if ctx_list is None:
        ctx_list = [_ctx.cpu(0), _ctx.gpu(0)]
    results = []
    for ctx in ctx_list:
        ins = [nd_array(a, ctx=ctx) for a in inputs_np]
        out = fn(*ins)
        outs = out if isinstance(out, (list, tuple)) else [out]
        results.append([o.asnumpy() for o in outs])
    ref = results[0]
    for ctx, res in zip(ctx_list[1:], results[1:]):
        for r0, r1 in zip(ref, res):
            assert_almost_equal(r0, r1, rtol=rtol, atol=atol,
                                names=(f"{ctx_list[0]}", f"{ctx}"))


def with_seed(seed: Optional[int] = None):
    """Decorator: seed mx / np / python RNGs per test and print the seed
    on failure (parity: tests/python/unittest/common.py @with_seed)."""

    def decorator(test_fn):
        @functools.wraps(test_fn)
        def wrapper(*args, **kwargs):
            actual = seed if seed is not None else np.random.randint(0, 2**31)
            np.random.seed(actual)
            _pyrandom.seed(actual)
            _random.seed(actual)
            try:
                return test_fn(*args, **kwargs)
            except Exception:
                print(f"[with_seed] test failed with seed={actual}; "
                      f"reproduce via @with_seed({actual})")
                raise

        return wrapper

    return decorator


class environment:
    """Context manager to scope env vars (parity:
    ``mx.util.environment`` / test_utils.environment)."""

    def __init__(self, *args):
        if len(args) == 2:
            self._env = {args[0]: args[1]}
        else:
            self._env = dict(args[0])

    def __enter__(self):
        self._saved = {k: os.environ.get(k) for k in self._env}
        for k, v in self._env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self._saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
