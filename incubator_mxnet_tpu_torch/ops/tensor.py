"""Tensor operators: the port of the JAX package's
``incubator_mxnet_tpu/ops/tensor.py`` for the ops BERT, gluon's layers
and losses and the imperative front end use.

Each op is one plain function over ``torch.Tensor``s, registered under the
JAX package's name and aliases; ``torch.autograd`` differentiates it. The
MXNet semantics that differ from numpy are kept: reshape's 0 / -1 / -2 /
-3 / -4 codes, the ``exclude`` flag of the reductions, ``dot`` contracting
the last axis of ``lhs`` with the first of ``rhs``, clip-mode ``take`` and
``pick``, comparisons returning the input dtype, and ``broadcast_to``
keeping a dimension where the target says 0. The other registry ops of the
JAX package are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..base import MXNetError
from .registry import register

# --------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------- #


def _norm_axis(axis, ndim, exclude=False):
    """MXNet reduce-axis semantics: None / () -> all axes; int or tuple,
    negative allowed; ``exclude=True`` reduces over the complement."""
    if axis is None or (isinstance(axis, (tuple, list)) and len(axis) == 0):
        return tuple(range(ndim)) if not exclude else ()
    if isinstance(axis, int):
        axis = (axis,)
    axes = tuple(a % ndim for a in axis)
    if exclude:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


def _dtype(dtype):
    from ..ndarray.ndarray import to_torch_dtype
    return to_torch_dtype(dtype)


def _binary(name, fn, aliases=()):
    def op(lhs, rhs):
        return fn(lhs, rhs)

    op.__name__ = name
    op.__doc__ = f"Elementwise broadcasting `{name}`."
    register(name, aliases=aliases)(op)


def _compare(fn):
    return lambda a, b: fn(a, b).to(a.dtype)


def _unary(name, fn, aliases=()):
    def op(data):
        return fn(data)

    op.__name__ = name
    op.__doc__ = f"Elementwise `{name}`."
    register(name, aliases=aliases)(op)


# --------------------------------------------------------------------- #
# broadcasting binary arithmetic / comparison / logic
# --------------------------------------------------------------------- #
_binary("broadcast_add", torch.add,
        aliases=("elemwise_add", "broadcast_plus", "_plus", "_add"))
_binary("broadcast_sub", torch.sub,
        aliases=("elemwise_sub", "broadcast_minus", "_sub", "_minus"))
_binary("broadcast_mul", torch.mul, aliases=("elemwise_mul", "_mul"))
_binary("broadcast_div", torch.div, aliases=("elemwise_div", "_div"))
_binary("broadcast_mod", torch.remainder, aliases=("_mod",))
_binary("broadcast_power", torch.pow, aliases=("_power", "pow"))
_binary("broadcast_maximum", torch.maximum, aliases=("maximum", "_maximum"))
_binary("broadcast_minimum", torch.minimum, aliases=("minimum", "_minimum"))
_binary("broadcast_hypot", torch.hypot, aliases=("hypot",))
_binary("broadcast_equal", _compare(torch.eq), aliases=("_equal",))
_binary("broadcast_not_equal", _compare(torch.ne), aliases=("_not_equal",))
_binary("broadcast_greater", _compare(torch.gt), aliases=("_greater",))
_binary("broadcast_greater_equal", _compare(torch.ge),
        aliases=("_greater_equal",))
_binary("broadcast_lesser", _compare(torch.lt), aliases=("_lesser",))
_binary("broadcast_lesser_equal", _compare(torch.le),
        aliases=("_lesser_equal",))
_binary("broadcast_logical_and", _compare(torch.logical_and))
_binary("broadcast_logical_or", _compare(torch.logical_or))
_binary("broadcast_logical_xor", _compare(torch.logical_xor))

# --------------------------------------------------------------------- #
# unary math
# --------------------------------------------------------------------- #
_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("round", torch.round)
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("square", torch.square)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("log1p", torch.log1p)
_unary("expm1", torch.expm1)
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tanh", torch.tanh)
_unary("reciprocal", torch.reciprocal)
_unary("negative", torch.neg)
_unary("erf", torch.erf)
_unary("sigmoid", torch.sigmoid)
_unary("softsign", torch.nn.functional.softsign)
_unary("relu", torch.relu)
_unary("identity", torch.clone, aliases=("_copy",))


@register("BlockGrad", aliases=("stop_gradient",))
def block_grad(data):
    """Stop gradient."""
    return data.detach()


# --------------------------------------------------------------------- #
# reductions
# --------------------------------------------------------------------- #
def _reduce(name, fn, aliases=()):
    def op(data, axis=None, keepdims=False, exclude=False):
        axes = _norm_axis(axis, data.ndim, exclude)
        if len(axes) == 0:
            return data
        return fn(data, axes, keepdims)

    op.__name__ = name
    op.__doc__ = f"Reduction `{name}` over the given axes."
    register(name, aliases=aliases)(op)


def _amax(x, axes, keepdims):
    return torch.amax(x, dim=axes, keepdim=keepdims)


def _amin(x, axes, keepdims):
    return torch.amin(x, dim=axes, keepdim=keepdims)


def _prod(x, axes, keepdims):
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


_reduce("sum", lambda x, a, k: torch.sum(x, dim=a, keepdim=k),
        aliases=("sum_axis",))
_reduce("mean", lambda x, a, k: torch.mean(x, dim=a, keepdim=k))
_reduce("prod", _prod)
_reduce("max", _amax)
_reduce("min", _amin)


@register("norm")
def norm(data, ord=2, axis=None, keepdims=False):
    """L1 / L2 norm reduction."""
    axes = _norm_axis(axis, data.ndim)
    if ord == 1:
        return torch.sum(torch.abs(data), dim=axes, keepdim=keepdims)
    if ord == 2:
        return torch.sqrt(torch.sum(torch.square(data), dim=axes,
                                    keepdim=keepdims))
    raise MXNetError(f"norm only supports ord in (1, 2), got {ord}")


@register("argmax")
def argmax(data, axis=None, keepdims=False):
    """Indices of the maxima, as float32 (MXNet's dtype)."""
    if axis is None:
        return torch.argmax(data.reshape(-1)).to(torch.float32)
    return torch.argmax(data, dim=axis, keepdim=keepdims).to(torch.float32)


@register("argmin")
def argmin(data, axis=None, keepdims=False):
    """Indices of the minima, as float32 (MXNet's dtype)."""
    if axis is None:
        return torch.argmin(data.reshape(-1)).to(torch.float32)
    return torch.argmin(data, dim=axis, keepdim=keepdims).to(torch.float32)


# --------------------------------------------------------------------- #
# products
# --------------------------------------------------------------------- #
@register("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Tensor product contracting the last axis of ``lhs`` with the first
    axis of ``rhs`` (MXNet semantics)."""
    if transpose_a and lhs.ndim > 1:
        lhs = lhs.permute(tuple(range(1, lhs.ndim)) + (0,))
    if transpose_b and rhs.ndim > 1:
        rhs = rhs.permute((rhs.ndim - 1,) + tuple(range(rhs.ndim - 1)))
    if lhs.shape[-1] != rhs.shape[0]:
        raise MXNetError(f"dot: shape mismatch {tuple(lhs.shape)} x "
                         f"{tuple(rhs.shape)}")
    if lhs.ndim == 1 and rhs.ndim == 1:
        return torch.dot(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=([lhs.ndim - 1], [0]))


@register("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Batched matmul of (B, M, K) by (B, K, N)."""
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


@register("add_n", aliases=("ElementWiseSum", "_sum"), wrap_list=True)
def add_n(*args):
    """Sum of N arrays."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


# --------------------------------------------------------------------- #
# shape manipulation
# --------------------------------------------------------------------- #
def _infer_reshape(src_shape: Tuple[int, ...], target) -> Tuple[int, ...]:
    """MXNet reshape codes: 0 copies a dim, -1 infers one, -2 copies the
    rest, -3 merges the next two, -4 splits one into the next two target
    entries."""
    target = list(target)
    out: list = []
    src_i = 0
    i = 0
    while i < len(target):
        t = target[i]
        if t == 0:
            out.append(src_shape[src_i])
            src_i += 1
        elif t == -1:
            out.append(-1)
            src_i += 1
        elif t == -2:
            out.extend(src_shape[src_i:])
            src_i = len(src_shape)
        elif t == -3:
            out.append(src_shape[src_i] * src_shape[src_i + 1])
            src_i += 2
        elif t == -4:
            d1, d2 = target[i + 1], target[i + 2]
            cur = src_shape[src_i]
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            src_i += 1
            i += 2
        else:
            out.append(t)
            src_i += 1
        i += 1
    if out.count(-1) > 1:
        raise MXNetError("reshape can infer at most one dimension")
    return tuple(out)


@register("reshape", aliases=("Reshape",))
def reshape(data, shape=None, reverse=False):
    """Reshape with MXNet's codes."""
    if shape is None:
        raise MXNetError("reshape requires shape")
    src = tuple(reversed(data.shape)) if reverse else tuple(data.shape)
    tgt = tuple(reversed(tuple(shape))) if reverse else tuple(shape)
    new_shape = _infer_reshape(src, tgt)
    if reverse:
        new_shape = tuple(reversed(new_shape))
    try:
        return data.reshape(new_shape)
    except RuntimeError as e:
        raise MXNetError(f"reshape {tuple(data.shape)} -> {shape}: {e}") \
            from None


@register("reshape_like")
def reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)


@register("transpose")
def transpose(data, axes=None):
    """Permute the axes (reversed when ``axes`` is empty)."""
    if axes is None or (isinstance(axes, (tuple, list)) and len(axes) == 0):
        axes = tuple(reversed(range(data.ndim)))
    return data.permute(tuple(axes))


@register("expand_dims")
def expand_dims(data, axis):
    return data.unsqueeze(axis)


@register("squeeze")
def squeeze(data, axis=None):
    if axis is None:
        return data.squeeze()
    return data.squeeze(axis)


@register("flatten", aliases=("Flatten",))
def flatten(data):
    """Collapse all but the first axis."""
    return data.reshape(data.shape[0], -1)


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(data, dim1=0, dim2=0):
    return data.transpose(dim1, dim2)


_PAD_MODES = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect"}


@register("pad", aliases=("Pad",))
def pad(data, mode="constant", pad_width=None, constant_value=0.0):
    """N-d padding; ``pad_width`` holds (before, after) pairs per axis,
    flat. ``edge`` and ``reflect`` pad only the trailing 1-3 axes of a
    batched (N, C, ...) input."""
    if mode not in _PAD_MODES:
        raise MXNetError(f"pad mode {mode!r}")
    pairs = [(pad_width[2 * i], pad_width[2 * i + 1])
             for i in range(len(pad_width) // 2)]
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    if mode == "constant":
        return torch.nn.functional.pad(data, flat, value=constant_value)
    while flat[-2:] == [0, 0]:
        flat = flat[:-2]
    if len(flat) > 6 or len(flat) // 2 > data.ndim - 2:
        raise MXNetError(f"pad mode {mode!r} pads at most the trailing 3 "
                         f"axes after (N, C)")
    return torch.nn.functional.pad(data, flat, mode=_PAD_MODES[mode])


@register("concat", aliases=("Concat",), wrap_list=True)
def concat(*data, dim=1):
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        data = tuple(data[0])
    return torch.cat(data, dim=dim)


@register("stack", wrap_list=True)
def stack(*data, axis=0):
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        data = tuple(data[0])
    return torch.stack(data, dim=axis)


@register("split", aliases=("SliceChannel",), num_outputs=None)
def split(data, num_outputs, axis=1, squeeze_axis=False):
    """``num_outputs`` equal parts along ``axis``."""
    parts = list(torch.chunk(data, num_outputs, dim=axis))
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


@register("slice", aliases=("crop",))
def slice_op(data, begin, end, step=None):
    """MXNet slice: None entries run to the edge."""
    ndim = data.ndim
    begin = tuple(begin) + (None,) * (ndim - len(begin))
    end = tuple(end) + (None,) * (ndim - len(end))
    step = tuple(step) + (None,) * (ndim - len(step)) \
        if step is not None else (None,) * ndim
    return data[tuple(slice(b, e, s) for b, e, s in zip(begin, end, step))]


@register("slice_axis")
def slice_axis(data, axis, begin, end):
    axis = axis % data.ndim
    if end is None:
        end = data.shape[axis]
    idx = [slice(None)] * data.ndim
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


@register("_slice_index")
def _slice_index(data, index=None):
    """The backend of ``NDArray.__getitem__`` (basic and advanced
    indexing)."""
    return data[index]


@register("broadcast_to")
def broadcast_to(data, shape=None):
    """Broadcast to ``shape``; a 0 there keeps the source dimension."""
    tgt = tuple(s if t == 0 else t for s, t in zip(data.shape, shape)) \
        if len(shape) == data.ndim else tuple(shape)
    return data.expand(tgt)


@register("broadcast_like")
def broadcast_like(lhs, rhs):
    return lhs.expand(rhs.shape)


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)


@register("full_like")
def full_like(data, fill_value=0.0):
    return torch.full_like(data, fill_value)


@register("Cast", aliases=("cast",))
def cast(data, dtype="float32"):
    return data.to(_dtype(dtype))


# --------------------------------------------------------------------- #
# indexing / gather
# --------------------------------------------------------------------- #
@register("take")
def take(data, indices, axis=0, mode="clip"):
    """Rows of ``data`` along ``axis`` at ``indices``; ``clip`` clamps
    out-of-range indices, ``wrap`` wraps them."""
    axis = axis % data.ndim
    n = data.shape[axis]
    idx = indices.long()
    idx = idx.remainder(n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(data, axis, idx.reshape(-1))
    return out.reshape(data.shape[:axis] + idx.shape + data.shape[axis + 1:])


@register("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """One element per row along ``axis`` (indices clipped)."""
    axis = axis % data.ndim
    idx = index.long().clamp(0, data.shape[axis] - 1).unsqueeze(axis)
    picked = torch.gather(data, axis, idx)
    return picked if keepdims else picked.squeeze(axis)


@register("logsumexp")
def logsumexp(data, axis=-1, keepdims=False):
    """Log-sum-exp with f32 accumulation; the max is a constant (no
    gradient) and the (..., vocab) log-probabilities are never written."""
    m = torch.amax(data, dim=axis, keepdim=True).detach()
    s = torch.sum(torch.exp((data - m).float()), dim=axis, keepdim=keepdims)
    mm = m if keepdims else m.squeeze(axis)
    return torch.log(s) + mm.float()


@register("one_hot")
def one_hot(indices, depth=None, on_value=1.0, off_value=0.0,
            dtype="float32"):
    """One-hot rows of ``depth``; an index out of range gives a row of
    ``off_value``."""
    d = _dtype(dtype)
    oh = (indices.long().unsqueeze(-1) ==
          torch.arange(depth, device=indices.device)).to(d)
    return oh * on_value + (1.0 - oh) * off_value


@register("where")
def where(condition, x, y):
    return torch.where(condition.bool(), x, y)


@register("clip")
def clip(data, a_min=None, a_max=None):
    return torch.clamp(data, a_min, a_max)


@register("batch_take")
def batch_take(data, indices):
    """Per-batch row gather: out[b, m] = data[b, indices[b, m]]."""
    idx = indices.long()
    if data.ndim > idx.ndim:
        idx = idx.reshape(idx.shape + (1,) * (data.ndim - idx.ndim)) \
            .expand(idx.shape + data.shape[idx.ndim:])
    return torch.gather(data, 1, idx)


@register("smooth_l1")
def smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(torch.abs(data) < 1.0 / s2,
                       0.5 * s2 * torch.square(data),
                       torch.abs(data) - 0.5 / s2)
