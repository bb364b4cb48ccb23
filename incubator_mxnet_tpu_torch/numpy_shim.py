"""``mx.np`` / ``mx.numpy``: the NumPy-style array namespace, the port of
the JAX package's ``incubator_mxnet_tpu/numpy_shim.py``.

The JAX namespace forwards any ``jax.numpy`` name. Torch is not a NumPy
clone (``torch.std`` is unbiased, ``torch.split`` takes sizes,
``torch.median`` keeps the lower middle, ``torch.transpose`` swaps two
axes), so the port forwards an explicit list of names: each resolves to
the torch function of the same name, or to a short adapter over torch
where only the spelling differs (``axis`` / ``keepdims`` / ``ddof``), with
NumPy's semantics. A name off the list raises ``MXNetError`` naming it;
nothing computes in numpy on the host.

A call runs through the imperative dispatcher as op ``np.<name>``, so
``autograd.record()`` records it, and returns an ``NDArray``. Inputs
decide the device; a function with no array input (``arange``,
``zeros``, ...) creates on ``ctx=`` or the current context (the card by
default). Integer and float results follow the JAX package's 32-bit
defaults: a creation function without ``dtype`` gives int32 or float32.

Supported names:

- elementwise, one array: ``abs absolute negative positive exp expm1 exp2
  log log1p log2 log10 sqrt cbrt square reciprocal sin cos tan arcsin
  arccos arctan sinh cosh tanh arcsinh arccosh arctanh sign floor ceil
  trunc rint fix round around isnan isinf isfinite logical_not signbit
  deg2rad rad2deg degrees radians``;
- elementwise, two arrays (or an array and a scalar): ``add subtract
  multiply divide true_divide floor_divide power float_power remainder
  mod fmod maximum minimum fmax fmin arctan2 hypot copysign logaddexp
  equal not_equal greater greater_equal less less_equal logical_and
  logical_or logical_xor``;
- reductions, with axis and keepdims: ``sum prod mean max min amax amin
  argmax argmin std var all any cumsum cumprod count_nonzero ptp``;
- shape and selection: ``reshape transpose swapaxes moveaxis
  expand_dims squeeze ravel flip fliplr flipud roll tile repeat
  broadcast_to concatenate stack vstack hstack split array_split where
  clip sort argsort diag diagonal tril triu trace take``;
- linear algebra: ``dot matmul inner outer tensordot einsum kron``;
- creation: ``arange linspace zeros ones full eye identity zeros_like
  ones_like full_like empty_like array asarray``;
- comparison helpers: ``isclose``;
- host values (no tape node, as the JAX package's passthrough set):
  ``shape ndim
  size result_type promote_types can_cast issubdtype isscalar iterable
  broadcast_shapes``;
- constants and dtypes: ``pi e inf nan newaxis float16 float32 float64
  bfloat16 int8 int32 int64 uint8 bool_``, ``ndarray`` (the ``NDArray``
  type);
- ``mx.np.random``: ``seed rand randn uniform normal randint gamma
  exponential laplace beta choice shuffle permutation`` over the port's
  seeded samplers.
"""

from __future__ import annotations

import numpy as _onp
import torch

from .base import MXNetError
from .ndarray import NDArray
from .ndarray.register import imperative_invoke
from .ops.registry import OpSpec

pi = _onp.pi
e = _onp.e
inf = _onp.inf
nan = _onp.nan
newaxis = None
float32 = "float32"
float64 = "float64"
float16 = "float16"
bfloat16 = "bfloat16"
int8 = "int8"
int32 = "int32"
int64 = "int64"
uint8 = "uint8"
bool_ = "bool"

ndarray = NDArray  # parity: mx.np.ndarray is the array type

_TORCH_DTYPES = {"float16": torch.float16, "float32": torch.float32,
                 "float64": torch.float64, "bfloat16": torch.bfloat16,
                 "int8": torch.int8, "int32": torch.int32,
                 "int64": torch.int64, "uint8": torch.uint8,
                 "bool": torch.bool}


def _tdtype(dtype):
    """A dtype spelled as a string, a numpy dtype or a torch dtype, as a
    torch dtype (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = _onp.dtype(dtype).name if not isinstance(dtype, str) else dtype
    if name == "bool_":
        name = "bool"
    if name not in _TORCH_DTYPES:
        raise MXNetError(f"mx.np: unsupported dtype {dtype!r}")
    return _TORCH_DTYPES[name]


def _default_device():
    from .context import current_context
    return current_context().torch_device


def _as32(t):
    """The JAX package's 32-bit default for a creation function called
    without ``dtype``."""
    if t.dtype == torch.int64:
        return t.to(torch.int32)
    if t.dtype == torch.float64:
        return t.to(torch.float32)
    return t


def _tensor_like(v, ref):
    """A Python scalar operand as a 0-d tensor beside ``ref``, weakly
    typed as jax.numpy's scalars are: it takes ``ref``'s dtype where its
    kind fits it (an int beside an int array, a float beside a float
    array) and the 32-bit default of its own kind where it does not (an
    int beside a bool array is int32, a float beside an int array is
    float32)."""
    if torch.is_tensor(v):
        return v
    dtype = _int32(torch.result_type(ref, v))
    return torch.tensor(v, dtype=dtype, device=ref.device)


def _int32(dtype):
    """torch's default integer (int64) as the JAX package's (int32)."""
    return torch.int32 if dtype == torch.int64 else dtype


def _narrow(out, *inputs):
    """An int64 result as int32 unless an input was int64 (torch widens
    integer reductions and indices to int64, jax.numpy keeps 32 bits)."""
    if torch.is_tensor(out) and out.dtype == torch.int64 and not any(
            torch.is_tensor(t) and t.dtype == torch.int64 for t in inputs):
        return out.to(torch.int32)
    return out


def _bool_as(x, dtype=torch.int32):
    """A bool array as ``dtype`` (jax.numpy's arithmetic on bools runs
    on their integer values); any other array as it is."""
    return x.to(dtype) if x.dtype == torch.bool else x


def _binary(fn, ints=False):
    """A binary function of two arrays or an array and a Python scalar;
    ``ints``: bool operands enter as int32 (arithmetic, not logic)."""
    def op(a, b, **kw):
        if not torch.is_tensor(a):
            a = _tensor_like(a, b)
        if not torch.is_tensor(b):
            b = _tensor_like(b, a)
        if ints and a.dtype == torch.bool and b.dtype == torch.bool:
            a, b = _bool_as(a), _bool_as(b)
        return fn(a, b, **kw)
    return op


def _float_binary(fn):
    """A binary function jax.numpy computes in floating point: integer
    and bool operands promote to float32."""
    def op(a, b):
        if not torch.is_tensor(a):
            a = _tensor_like(a, b)
        if not torch.is_tensor(b):
            b = _tensor_like(b, a)
        if not (a.is_floating_point() or b.is_floating_point()):
            a = a.to(torch.float32)
        return fn(a, b)
    return op


def _sum_dtype(x):
    """jax.numpy's accumulator for ``sum`` / ``prod`` / ``trace``: bool
    and signed ints as int32, uint8 as uint32, floats as they are."""
    if x.dtype == torch.uint8:
        return torch.uint32
    if x.dtype in (torch.bool, torch.int8, torch.int16):
        return torch.int32
    return None


def _sum_like(fn):
    """``sum`` / ``prod`` with NumPy's axis / keepdims / dtype and
    jax.numpy's accumulator widths."""
    def op(x, axis=None, keepdims=False, dtype=None):
        want = _tdtype(dtype) or _sum_dtype(x)
        # torch accumulates uint8 in int64; the narrowing cast wraps as
        # jax.numpy's uint32 sum does
        out = _reduce(fn)(x, axis, keepdims, dtype=torch.int64
                          if want == torch.uint32 else want)
        return out.to(want) if want is not None else _narrow(out, x)
    return op


def _index_result(fn):
    """An index-valued function (argmax, argsort, nonzero, ...) with
    int32 indices; bool input as uint8 (torch's argmax takes no bool)."""
    def op(x, *args, **kw):
        return _narrow(fn(_bool_as(x, torch.uint8), *args, **kw))
    return op


def _reduce(fn, ret_index=False):
    """A torch reduction with NumPy's ``axis`` / ``keepdims`` (a tuple of
    axes too; None reduces all)."""
    def op(x, axis=None, keepdims=False, **kw):
        if axis is None:
            if keepdims:
                out = fn(x.reshape(-1), dim=0, keepdim=False, **kw)
                return out.reshape((1,) * x.dim())
            return fn(x.reshape(-1), dim=0, **kw) if ret_index \
                else fn(x, **kw)
        return fn(x, dim=axis, keepdim=keepdims, **kw)
    return op


def _minmax(fn):
    def op(x, axis=None, keepdims=False):
        if axis is None:
            out = fn(x)
            return out.reshape((1,) * x.dim()) if keepdims else out
        return fn(x, dim=axis, keepdim=keepdims)
    return op


def _floating(x):
    return x if x.is_floating_point() else x.to(torch.float32)


def _mean(x, dtype=None, **kw):
    return torch.mean(_floating(x), dtype=_tdtype(dtype), **kw)


def _moment(fn):
    def op(x, axis=None, ddof=0, keepdims=False):
        return fn(_floating(x), dim=axis, correction=ddof,
                  keepdim=keepdims)
    return op


def _cumulative(fn):
    """``cumsum`` / ``cumprod``: jax.numpy keeps an unsigned or int32
    input's dtype and counts bools as int32."""
    def op(x, axis=None, dtype=None):
        if axis is None:
            x, axis = x.reshape(-1), 0
        want = _tdtype(dtype) or (torch.int32 if x.dtype == torch.bool
                                  else None if x.is_floating_point()
                                  else x.dtype)
        return fn(x, dim=axis, dtype=want)
    return op


def _ptp(x, axis=None, keepdims=False):
    return _minmax(torch.amax)(x, axis, keepdims) - \
        _minmax(torch.amin)(x, axis, keepdims)


def _count_nonzero(x, axis=None, keepdims=False):
    out = _narrow(torch.count_nonzero(x, dim=axis))
    if keepdims:
        axes = range(x.dim()) if axis is None else \
            ([axis] if isinstance(axis, int) else axis)
        for a in sorted(a % x.dim() for a in axes):
            out = out.unsqueeze(a)
    return out


def _all_any(fn):
    def op(x, axis=None, keepdims=False):
        x = x if x.dtype == torch.bool else x != 0
        if axis is None:
            out = fn(x)
            return out.reshape((1,) * x.dim()) if keepdims else out
        return fn(x, dim=axis, keepdim=keepdims)
    return op


def _transpose(x, axes=None):
    return x.permute(*(axes if axes is not None
                       else range(x.dim() - 1, -1, -1)))


def _squeeze(x, axis=None):
    return x.squeeze() if axis is None else x.squeeze(axis)


def _ravel(x):
    return x.reshape(-1)


def _roll(x, shift, axis=None):
    if axis is None:
        return torch.roll(x.reshape(-1), shift).reshape(x.shape)
    return torch.roll(x, shift, dims=axis)


def _repeat(x, repeats, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.repeat_interleave(x, repeats, dim=axis)


def _concatenate(arrays, axis=0):
    if axis is None:
        return torch.cat([a.reshape(-1) for a in arrays])
    return torch.cat(list(arrays), dim=axis)


def _stack(arrays, axis=0):
    return torch.stack(list(arrays), dim=axis)


def _split(x, indices_or_sections, axis=0):
    if isinstance(indices_or_sections, int) and \
            x.shape[axis] % indices_or_sections:
        raise MXNetError("np.split: array split does not result in an "
                         "equal division")
    return list(torch.tensor_split(x, indices_or_sections, dim=axis))


def _array_split(x, indices_or_sections, axis=0):
    return list(torch.tensor_split(x, indices_or_sections, dim=axis))


def _where(cond, x=None, y=None):
    if cond.dtype != torch.bool:     # MXNet's comparisons give 0 / 1
        cond = cond != 0
    if x is None and y is None:
        return [_narrow(t) for t in torch.where(cond)]
    ref = x if torch.is_tensor(x) else y
    return torch.where(cond, _tensor_like(x, ref), _tensor_like(y, ref))


def _clip(x, a_min=None, a_max=None):
    return torch.clamp(x, a_min, a_max)


def _sort(x, axis=-1):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.sort(x, dim=axis, stable=True).values


def _argsort(x, axis=-1):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.argsort(x, dim=axis, stable=True)


def _diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


def _trace(x, offset=0, axis1=0, axis2=1):
    return _sum_like(torch.sum)(torch.diagonal(x, offset, axis1, axis2),
                                axis=-1)


def _diag(v, k=0):
    return torch.diag(v, diagonal=k)


def _take(x, indices, axis=None):
    idx = indices.long()
    if axis is None:
        return x.reshape(-1)[idx]
    return torch.index_select(x, axis, idx.reshape(-1)).reshape(
        x.shape[:axis % x.dim()] + idx.shape
        + x.shape[axis % x.dim() + 1:])


def _bool_product(fn):
    """A product of arrays; of two bool arrays, the logical one (any of
    the pairwise ands), as jax.numpy computes it."""
    def op(*args, **kw):
        arrays = [a for a in args if torch.is_tensor(a)]
        if arrays and all(a.dtype == torch.bool for a in arrays):
            args = [_bool_as(a) if torch.is_tensor(a) else a for a in args]
            return fn(*args, **kw) != 0
        return fn(*args, **kw)
    return op


def _dot(a, b):
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() == 1 or a.dim() <= 2 and b.dim() <= 2:
        return torch.matmul(a, b)
    # N-d dot: a sum over a's last axis and b's second-to-last
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 2]))


def _outer(a, b):
    return torch.outer(a.reshape(-1), b.reshape(-1))


def _tensordot(a, b, axes=2):
    return torch.tensordot(a, b, dims=axes)


def _einsum(subscripts, *operands):
    return torch.einsum(subscripts, *operands)


def _isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(a, _tensor_like(b, a), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def _round(x, decimals=0):
    if not x.is_floating_point() and decimals >= 0:
        return x.clone()        # integers round to themselves
    return torch.round(x, decimals=decimals)


def _rint(x):
    return torch.round(_floating(x))


def _bool_identity(fn):
    """``fn``, which torch leaves unimplemented on bool; a bool array is
    its own result (jax.numpy's abs, floor, ceil, trunc of a bool)."""
    def op(x):
        return x.clone() if x.dtype == torch.bool else fn(x)
    return op


def _float_power(a, b):
    return torch.float_power(a, b).to(torch.float32) \
        if a.dtype != torch.float64 else torch.float_power(a, b)


_PLAIN = {
    # name: torch function of the same semantics
    "abs": _bool_identity(torch.abs),
    "absolute": _bool_identity(torch.abs), "negative": torch.neg,
    "positive": _bool_identity(torch.positive), "exp": torch.exp, "expm1": torch.expm1,
    "exp2": torch.exp2, "log": torch.log, "log1p": torch.log1p,
    "log2": torch.log2, "log10": torch.log10, "sqrt": torch.sqrt,
    "cbrt": lambda x: torch.sign(_floating(x)) * torch.abs(
        _floating(x)).pow(1.0 / 3.0),
    "square": lambda x: torch.square(_bool_as(x)), "reciprocal": torch.reciprocal,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.arcsin, "arccos": torch.arccos, "arctan": torch.arctan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.arcsinh, "arccosh": torch.arccosh,
    "arctanh": torch.arctanh, "sign": torch.sign, "floor": _bool_identity(torch.floor),
    "ceil": _bool_identity(torch.ceil),
    "trunc": _bool_identity(torch.trunc), "rint": _rint,
    "fix": _bool_identity(torch.trunc), "round": _round, "around": _round,
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
    "logical_not": torch.logical_not, "signbit": torch.signbit,
    "deg2rad": torch.deg2rad, "rad2deg": torch.rad2deg,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "add": _binary(torch.add), "subtract": _binary(
        lambda a, b: torch.sub(_bool_as(a), _bool_as(b))),
    "multiply": _binary(torch.mul), "divide": _binary(torch.true_divide),
    "true_divide": _binary(torch.true_divide),
    "floor_divide": _binary(torch.floor_divide, ints=True),
    "power": _binary(torch.pow, ints=True),
    "float_power": _binary(_float_power),
    "remainder": _binary(torch.remainder, ints=True),
    "mod": _binary(torch.remainder, ints=True),
    "fmod": _binary(torch.fmod, ints=True),
    "maximum": _binary(torch.maximum),
    "minimum": _binary(torch.minimum), "fmax": _binary(torch.fmax),
    "fmin": _binary(torch.fmin), "arctan2": _binary(torch.arctan2),
    "hypot": _float_binary(torch.hypot),
    "copysign": _binary(torch.copysign),
    "logaddexp": _float_binary(torch.logaddexp), "equal": _binary(torch.eq),
    "not_equal": _binary(torch.ne), "greater": _binary(torch.gt),
    "greater_equal": _binary(torch.ge), "less": _binary(torch.lt),
    "less_equal": _binary(torch.le),
    "logical_and": _binary(torch.logical_and),
    "logical_or": _binary(torch.logical_or),
    "logical_xor": _binary(torch.logical_xor),
    "sum": _sum_like(torch.sum), "prod": _sum_like(torch.prod),
    "mean": _reduce(_mean), "max": _minmax(torch.amax),
    "min": _minmax(torch.amin), "amax": _minmax(torch.amax),
    "amin": _minmax(torch.amin), "argmax": _index_result(_reduce(torch.argmax, True)),
    "argmin": _index_result(_reduce(torch.argmin, True)), "std": _moment(torch.std),
    "var": _moment(torch.var), "all": _all_any(torch.all),
    "any": _all_any(torch.any), "cumsum": _cumulative(torch.cumsum),
    "cumprod": _cumulative(torch.cumprod),
    "count_nonzero": _count_nonzero, "ptp": _ptp,
    "reshape": lambda x, newshape: torch.reshape(
        x, (newshape,) if isinstance(newshape, int) else tuple(newshape)),
    "transpose": _transpose, "swapaxes": torch.swapaxes,
    "moveaxis": torch.moveaxis,
    "expand_dims": lambda x, axis: torch.unsqueeze(x, axis),
    "squeeze": _squeeze, "ravel": _ravel,
    "flip": lambda x, axis=None: torch.flip(
        x, tuple(range(x.dim())) if axis is None else
        ((axis,) if isinstance(axis, int) else tuple(axis))),
    "fliplr": torch.fliplr, "flipud": torch.flipud, "roll": _roll,
    "tile": lambda x, reps: torch.tile(
        x, (reps,) if isinstance(reps, int) else tuple(reps)),
    "repeat": _repeat,
    "broadcast_to": lambda x, shape: torch.broadcast_to(x, tuple(shape)),
    "concatenate": _concatenate, "stack": _stack,
    "vstack": lambda arrays: torch.vstack(list(arrays)),
    "hstack": lambda arrays: torch.hstack(list(arrays)),
    "split": _split, "array_split": _array_split, "where": _where,
    "clip": _clip, "sort": _sort, "argsort": _index_result(_argsort),
    "diag": _diag,
    "diagonal": _diagonal, "tril": torch.tril, "triu": torch.triu,
    "trace": _trace,
    "take": _take, "dot": _bool_product(_dot),
    "matmul": _bool_product(torch.matmul),
    "inner": _bool_product(torch.inner),
    "outer": _outer, "tensordot": _bool_product(_tensordot),
    "einsum": _bool_product(_einsum),
    "kron": torch.kron, "isclose": _isclose,
    "zeros_like": lambda x, dtype=None: torch.zeros_like(
        x, dtype=_tdtype(dtype)),
    "ones_like": lambda x, dtype=None: torch.ones_like(
        x, dtype=_tdtype(dtype)),
    "full_like": lambda x, fill_value, dtype=None: torch.full_like(
        x, fill_value, dtype=_tdtype(dtype)),
    "empty_like": lambda x, dtype=None: torch.zeros_like(
        x, dtype=_tdtype(dtype)),
}


def _creation(fn):
    """A creation function on ``ctx`` (or the current context), with the
    32-bit defaults when no ``dtype`` is given."""
    def call(*args, dtype=None, ctx=None, device=None, **kwargs):
        if device is not None:
            ctx = device
        dev = ctx.torch_device if ctx is not None and \
            hasattr(ctx, "torch_device") else \
            (torch.device(ctx) if ctx is not None else _default_device())
        out = fn(*args, dtype=_tdtype(dtype), device=dev, **kwargs)
        return NDArray(out if dtype is not None else _as32(out))
    return call


def _shape_arg(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _arange(start, stop=None, step=1, dtype=None, device=None):
    if stop is None:
        start, stop = 0, start
    if dtype is None and all(isinstance(v, int)
                             for v in (start, stop, step)):
        dtype = torch.int32
    return torch.arange(start, stop, step, dtype=dtype, device=device)


def _linspace(start, stop, num=50, endpoint=True, dtype=None,
              device=None):
    if endpoint:
        return torch.linspace(start, stop, num, dtype=dtype or
                              torch.float32, device=device)
    step = (stop - start) / num
    return start + step * torch.arange(num, dtype=dtype or torch.float32,
                                       device=device)


def _eye(N, M=None, k=0, dtype=None, device=None):
    """NumPy's ``eye``: ones on diagonal ``k`` of an N x M matrix."""
    out = torch.zeros((N, N if M is None else M),
                      dtype=dtype or torch.float32, device=device)
    out.diagonal(k).fill_(1)
    return out


_CREATION = {
    "arange": _creation(_arange),
    "linspace": _creation(_linspace),
    "zeros": _creation(lambda shape, dtype=None, device=None: torch.zeros(
        _shape_arg(shape), dtype=dtype or torch.float32, device=device)),
    "ones": _creation(lambda shape, dtype=None, device=None: torch.ones(
        _shape_arg(shape), dtype=dtype or torch.float32, device=device)),
    "full": _creation(
        lambda shape, fill_value, dtype=None, device=None: torch.full(
            _shape_arg(shape), fill_value, dtype=dtype or (
                torch.bool if isinstance(fill_value, bool) else
                torch.int32 if isinstance(fill_value, int)
                else torch.float32),
            device=device)),
    "eye": _creation(_eye),
    "identity": _creation(lambda n, dtype=None, device=None: _eye(
        n, dtype=dtype, device=device)),
}


def _host_dtype(x):
    """What a host predicate reads of its argument: an array's dtype, a
    dtype spelled any way as a torch dtype, a Python scalar as is."""
    if isinstance(x, NDArray):
        return x._data.dtype
    if torch.is_tensor(x):
        return x.dtype
    if isinstance(x, (bool, int, float)):
        return x
    return _tdtype(x)


def _np_dtype(t: torch.dtype):
    name = str(t).replace("torch.", "")
    if name == "bfloat16":
        return "bfloat16"
    return _onp.dtype(name)


def _result_type(*args):
    """The JAX package's 32-bit lattice, which torch's promotion shares:
    array dtypes promote among themselves, and a Python scalar only
    lifts the kind (int to float) at the default width."""
    dtypes = [_host_dtype(a) for a in args]
    out = None
    for d in dtypes:
        if isinstance(d, torch.dtype):
            out = d if out is None else torch.promote_types(out, d)
    for d in dtypes:
        if isinstance(d, torch.dtype):
            continue
        if out is None:
            out = torch.bool if isinstance(d, bool) else \
                torch.int32 if isinstance(d, int) else torch.float32
        else:
            out = torch.result_type(torch.empty((), dtype=out), d)
    return _np_dtype(out)


def _promote_types(a, b):
    return _np_dtype(torch.promote_types(_tdtype(a), _tdtype(b)))


def _can_cast(from_, to, casting="safe"):
    src = _host_dtype(from_)
    src = _np_dtype(src) if isinstance(src, torch.dtype) else src
    return bool(_onp.can_cast(src, _np_dtype(_tdtype(to)), casting))


def _issubdtype(a, b):
    a = _np_dtype(_tdtype(a)) if not isinstance(a, type) else a
    if isinstance(a, str):     # bfloat16: a floating type
        return _onp.issubdtype(_onp.float16, b)
    return bool(_onp.issubdtype(a, b))


def _shape(x):
    return tuple(x.shape) if hasattr(x, "shape") else _onp.shape(x)


_HOST = {
    "shape": _shape,
    "ndim": lambda x: len(_shape(x)),
    "size": lambda x: int(_onp.prod(_shape(x), dtype=_onp.int64)),
    "result_type": _result_type, "promote_types": _promote_types,
    "can_cast": _can_cast, "issubdtype": _issubdtype,
    "isscalar": lambda x: _onp.isscalar(x),
    "iterable": lambda x: _onp.iterable(x),
    "broadcast_shapes": lambda *shapes: tuple(
        torch.broadcast_shapes(*[tuple(s) for s in shapes])),
}

SUPPORTED = tuple(sorted(set(_PLAIN) | set(_CREATION) | set(_HOST)
                         | {"array", "asarray"}))

_spec_cache = {}


def array(obj, dtype=None, ctx=None):
    """Parity: ``mx.np.array``: an ``NDArray`` on ``ctx`` (the current
    context when None)."""
    from .ndarray import array as _nd_array
    if isinstance(obj, NDArray):
        obj = obj._data
    if torch.is_tensor(obj):
        out = obj.to(device=ctx.torch_device if ctx is not None
                     else obj.device, dtype=_tdtype(dtype), copy=True)
        return NDArray(out)
    return _nd_array(obj, dtype=dtype, ctx=ctx)


asarray = array


def _spec(name: str) -> OpSpec:
    spec = _spec_cache.get(name)
    if spec is None:
        spec = OpSpec("np." + name, _PLAIN[name], num_outputs=None)
        _spec_cache[name] = spec
    return spec


def __getattr__(name: str):
    if name in _HOST:
        fn = _HOST[name]

        def host_value(*args, **kwargs):
            return fn(*args, **kwargs)

        host_value.__name__ = name
        return host_value
    if name in _CREATION:
        return _CREATION[name]
    if name not in _PLAIN:
        if name.startswith("__"):
            raise AttributeError(name)
        raise MXNetError(
            f"mx.np.{name} is not supported by the PyTorch port (torch "
            f"lacks it or its torch semantics differ from NumPy's); the "
            f"supported names are listed in mx.np's docstring")
    spec = _spec(name)

    def np_function(*args, **kwargs):
        return imperative_invoke(spec, *args, **kwargs)

    np_function.__name__ = name
    np_function.__qualname__ = name
    return np_function


class _NpRandom:
    """``mx.np.random``: numpy.random's spelling over the port's seeded
    samplers (``mx.nd.random``), drawing from ``mx.random``'s generator
    for the current context's device. ``size`` is numpy's ``shape``."""

    @staticmethod
    def _nd():
        from .ndarray import random as ndr
        return ndr

    def seed(self, s):
        from . import random as _r
        _r.seed(s)

    def rand(self, *size):
        return self._nd().uniform(0.0, 1.0, shape=size or None)

    def randn(self, *size):
        return self._nd().randn(*size)

    def uniform(self, low=0.0, high=1.0, size=None):
        return self._nd().uniform(low, high, shape=size)

    def normal(self, loc=0.0, scale=1.0, size=None):
        return self._nd().normal(loc, scale, shape=size)

    def randint(self, low, high=None, size=None, dtype="int32"):
        if high is None:
            low, high = 0, low
        return self._nd().randint(low, high, shape=size, dtype=dtype)

    def gamma(self, shape, scale=1.0, size=None):
        return self._nd().gamma(shape, scale, shape=size)

    def exponential(self, scale=1.0, size=None):
        return self._nd().exponential(1.0 / scale, shape=size)

    def laplace(self, loc=0.0, scale=1.0, size=None):
        return self._nd().laplace(loc, scale, shape=size)

    def beta(self, a, b, size=None):
        # Beta(a, b) = G1 / (G1 + G2), G1 ~ Gamma(a), G2 ~ Gamma(b): the
        # registered gamma sampler keeps the draw on the seeded stream
        g1 = self._nd().gamma(a, 1.0, shape=size)
        g2 = self._nd().gamma(b, 1.0, shape=size)
        return g1 / (g1 + g2)

    @staticmethod
    def _size_total(size):
        total = 1
        for d in (size if isinstance(size, tuple)
                  else (size,) if size else ()):
            total *= d
        return total

    def choice(self, a, size=None, replace=True, p=None):
        from .ndarray import log as nd_log, take, topk
        n = int(a) if not hasattr(a, "shape") else a.shape[0]
        if p is not None:
            pa = p if hasattr(p, "shape") else array(p)
            if pa.shape[0] != n:
                raise MXNetError(
                    f"choice: 'a' ({n}) and 'p' ({pa.shape[0]}) must "
                    f"have the same size")
            if replace:
                idx = self._nd().multinomial(pa, shape=size)
            else:
                # weighted sampling without replacement, Gumbel top-k
                total = self._size_total(size)
                if total > n:
                    raise MXNetError(
                        "choice: cannot take more samples than "
                        "population when replace=False")
                u = self._nd().uniform(1e-20, 1.0, shape=(n,),
                                       ctx=pa.context)
                g = -nd_log(-nd_log(u))
                scores = nd_log(pa + 1e-38) + g
                idx = topk(scores, k=total, ret_typ="indices",
                           is_ascend=False)
                idx = idx.reshape(size) if size else idx[0]
        elif not replace:
            total = self._size_total(size)
            if total > n:
                raise MXNetError(
                    "choice: cannot take more samples than population "
                    "when replace=False")
            perm = self._nd().shuffle(__getattr__("arange")(n))
            idx = perm[:total].reshape(size) if size else perm[0]
        else:
            idx = self._nd().randint(0, n, shape=size)
        if hasattr(a, "shape"):
            return take(a, idx, axis=0)
        return idx

    def shuffle(self, x):
        """In place along axis 0; returns None (numpy's contract)."""
        with torch.no_grad():
            x._data.copy_(self._nd().shuffle(x)._data)

    def permutation(self, x):
        if isinstance(x, int):
            return self._nd().shuffle(__getattr__("arange")(x))
        return self._nd().shuffle(x)


random = _NpRandom()
