"""Tensor operators: the port of the JAX package's
``incubator_mxnet_tpu/ops/tensor.py`` for the ops BERT, gluon's layers
and losses and the imperative front end use.

Each op is one plain function over ``torch.Tensor``s, registered under the
JAX package's name and aliases; ``torch.autograd`` differentiates it. The
MXNet semantics that differ from numpy are kept: reshape's 0 / -1 / -2 /
-3 / -4 codes, the ``exclude`` flag of the reductions, ``dot`` contracting
the last axis of ``lhs`` with the first of ``rhs``, clip-mode ``take`` and
``pick``, comparisons returning the input dtype, ``broadcast_to``
keeping a dimension where the target says 0, ``topk`` / ``argsort``'s tie
order (``lax.top_k``'s lower index first; a descending ``argsort`` is the
ascending one flipped), index outputs as float32 unless ``dtype`` says
otherwise, floor ``mod``, and ``gamma`` as ``exp(gammaln)`` (the JAX op's
magnitude, positive for negative non-integers). ``boolean_mask`` reads
its mask on the host: its output shape depends on the data, so it is
eager only and never reaches a graph capture. The heads whose backward
ignores the head gradient (``make_loss``, ``LinearRegressionOutput``)
are ``torch.autograd.Function``s with the JAX op's custom VJP.
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


def _fill(value, like):
    """A Python number as a 0-d tensor on ``like``'s device, in the dtype
    the JAX op's weak typing gives the pair (a fill, not a host copy)."""
    return torch.full((), value, dtype=torch.result_type(like, value),
                      device=like.device)


def _binary(name, fn, aliases=()):
    def op(lhs, rhs):
        if not torch.is_tensor(rhs):
            rhs = _fill(rhs, lhs)
        elif not torch.is_tensor(lhs):
            lhs = _fill(lhs, rhs)
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
def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("rint", torch.round)                 # half to even, as jnp.rint
_unary("round", torch.round)
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("trunc", torch.trunc)
_unary("fix", torch.trunc)
_unary("square", torch.square)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("cbrt", _cbrt)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("log10", torch.log10)
_unary("log2", torch.log2)
_unary("log1p", torch.log1p)
_unary("expm1", torch.expm1)
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tan", torch.tan)
_unary("arcsin", torch.arcsin)
_unary("arccos", torch.arccos)
_unary("arctan", torch.arctan)
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("tanh", torch.tanh)
_unary("arcsinh", torch.arcsinh)
_unary("arccosh", torch.arccosh)
_unary("arctanh", torch.arctanh)
_unary("degrees", torch.rad2deg)
_unary("radians", torch.deg2rad)
_unary("reciprocal", torch.reciprocal)
_unary("negative", torch.neg)
_unary("erf", torch.erf)
_unary("erfinv", torch.erfinv)
_unary("gamma", lambda x: torch.exp(torch.lgamma(x)))
_unary("gammaln", torch.lgamma)
_unary("logical_not", lambda x: torch.logical_not(x).to(x.dtype))
_unary("sigmoid", torch.sigmoid)
_unary("softsign", torch.nn.functional.softsign)
_unary("relu", torch.relu)
_unary("hard_sigmoid", lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0))
_unary("identity", torch.clone, aliases=("_copy", "stop_gradient_off"))


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
_reduce("nansum", lambda x, a, k: torch.nansum(x, dim=a, keepdim=k))
_reduce("nanprod", lambda x, a, k: _prod(
    torch.where(torch.isnan(x), torch.ones_like(x), x), a, k))
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


@register("argmax_channel")
def argmax_channel(data):
    return torch.argmax(data, dim=-1).to(torch.float32)


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


# --------------------------------------------------------------------- #
# shape / layout
# --------------------------------------------------------------------- #
@register("shape_array")
def shape_array(data):
    return torch.tensor(tuple(data.shape), dtype=torch.int32,
                        device=data.device)


@register("size_array")
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int32,
                        device=data.device)


@register("flip", aliases=("reverse",))
def flip(data, axis):
    return torch.flip(data, dims=tuple(axis) if isinstance(
        axis, (tuple, list)) else (axis,))


@register("tile")
def tile(data, reps):
    return torch.tile(data, (reps,) if isinstance(reps, int)
                      else tuple(reps))


@register("repeat")
def repeat(data, repeats, axis=None):
    """``repeats`` copies of each element along ``axis`` (of the
    flattened array when None)."""
    return torch.repeat_interleave(data, repeats, dim=axis)


@register("split_v2", num_outputs=None)
def split_v2(data, indices_or_sections, axis=0, squeeze_axis=False):
    """numpy ``split``: equal sections (which must divide the axis) or
    the split indices."""
    if isinstance(indices_or_sections, int) and \
            data.shape[axis] % indices_or_sections:
        raise MXNetError(f"split_v2: {indices_or_sections} sections do "
                         f"not divide axis {axis} of {tuple(data.shape)}")
    sections = indices_or_sections if isinstance(indices_or_sections, int) \
        else list(indices_or_sections)
    parts = torch.tensor_split(data, sections, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("slice_like")
def slice_like(data, shape_like, axes=()):
    axes = axes or tuple(range(shape_like.ndim))
    idx = [slice(None)] * data.ndim
    for a in axes:
        idx[a % data.ndim] = slice(0, shape_like.shape[a % shape_like.ndim])
    return data[tuple(idx)]


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else axis
    size = (size,) if isinstance(size, int) else size
    tgt = list(data.shape)
    for a, s in zip(axis, size):
        tgt[a % data.ndim] = s
    return data.expand(tuple(tgt))


@register("amp_cast")
def amp_cast(data, dtype="float16"):
    return data.to(_dtype(dtype))


@register("diag")
def diag(data, k=0):
    """A 1-d input's diagonal matrix, or the ``k``-th diagonal of the last
    two axes."""
    if data.ndim <= 2:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


@register("tril")
def tril(data, k=0):
    return torch.tril(data, diagonal=k)


@register("triu")
def triu(data, k=0):
    return torch.triu(data, diagonal=k)


@register("meshgrid", num_outputs=None)
def meshgrid(*arrays, indexing="xy"):
    return list(torch.meshgrid(*arrays, indexing=indexing))


@register("depth_to_space")
def depth_to_space(data, block_size):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(n, c // (b * b), h * b,
                                               w * b)


@register("space_to_depth")
def space_to_depth(data, block_size):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, c * b * b, h // b,
                                               w // b)


# --------------------------------------------------------------------- #
# gather / scatter
# --------------------------------------------------------------------- #
def _nd_index(indices):
    idx = indices.long()
    return tuple(idx[i] for i in range(idx.shape[0]))


@register("gather_nd")
def gather_nd(data, indices):
    """``indices`` (M, ...) index the first M axes of ``data``."""
    return data[_nd_index(indices)]


@register("scatter_nd")
def scatter_nd(data, indices, shape=None):
    """A zero array of ``shape`` with ``data`` added at ``indices``."""
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(_nd_index(indices), data, accumulate=True)


def _rows(index, n):
    idx = index.long()
    return torch.where(idx < 0, idx + n, idx)


@register("index_copy", aliases=("_contrib_index_copy",))
def index_copy(old, index, new):
    """``old`` with the rows at ``index`` replaced by ``new``."""
    return old.index_copy(0, _rows(index, old.shape[0]), new)


@register("index_add")
def index_add(old, index, new):
    return old.index_add(0, _rows(index, old.shape[0]), new)


@register("boolean_mask", aliases=("_contrib_boolean_mask",))
def boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero.
    The output's shape depends on the mask, which is read on the host:
    eager only."""
    keep = torch.nonzero(index.reshape(-1) != 0).reshape(-1)
    return torch.index_select(data, axis, keep.to(data.device))


# --------------------------------------------------------------------- #
# sequences: (T, B, ...) for axis=0, (B, T, ...) for axis=1
# --------------------------------------------------------------------- #
@register("SequenceMask", aliases=("sequence_mask",))
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """``value`` at the positions past each sequence's length."""
    if not use_sequence_length or sequence_length is None:
        return data
    pos = torch.arange(data.shape[axis], device=data.device)
    valid = pos[:, None] < sequence_length[None, :].long()      # (T, B)
    if axis == 1:
        valid = valid.T
    valid = valid.reshape(valid.shape + (1,) * (data.ndim - valid.ndim))
    return torch.where(valid, data, torch.tensor(value, dtype=data.dtype,
                                                 device=data.device))


@register("SequenceLast", aliases=("sequence_last",))
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    """Each sequence's last valid step."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    moved = torch.movedim(data, axis, 0)                     # (T, B, ...)
    last = sequence_length.long() - 1
    return moved[last, torch.arange(moved.shape[1], device=data.device)]


@register("SequenceReverse", aliases=("sequence_reverse",))
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Each (T, B, ...) sequence reversed within its length; the steps
    past it stay."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))
    lens = sequence_length.long()
    pos = torch.arange(data.shape[0], device=data.device)[:, None]
    rev = lens[None, :] - 1 - pos                               # (T, B)
    src = torch.where(rev >= 0, rev, pos)
    return data[src, torch.arange(data.shape[1], device=data.device)[None]]


# --------------------------------------------------------------------- #
# ordering
# --------------------------------------------------------------------- #
def top_k(x, k):
    """``lax.top_k`` along the last axis: values descending, the lower
    index first among equal values (a stable descending sort; the order
    ``torch.topk`` does not promise on CUDA)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register("topk", num_outputs=None)
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """Top ``k`` along ``axis``; ``ret_typ`` in {'value', 'indices',
    'mask', 'both'}."""
    axis = axis % data.ndim
    sortable = -data if is_ascend else data
    vals, idxs = top_k(torch.movedim(sortable, axis, -1), k)
    if is_ascend:
        vals = -vals
    if ret_typ == "mask":
        oh = torch.zeros(idxs.shape[:-1] + (data.shape[axis],),
                         dtype=data.dtype, device=data.device)
        oh = oh.scatter_add(-1, idxs, torch.ones_like(idxs, dtype=data.dtype))
        return torch.movedim(oh, -1, axis)
    vals = torch.movedim(vals, -1, axis)
    idxs = torch.movedim(idxs, -1, axis).to(_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idxs
    if ret_typ == "both":
        return vals, idxs
    raise MXNetError(f"unknown ret_typ {ret_typ!r}")


@register("sort")
def sort(data, axis=-1, is_ascend=True):
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, dims=(axis,))


@register("argsort")
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    """Stable ascending order, flipped for ``is_ascend=False`` (equal
    values then come out highest index first, as in the JAX op)."""
    idx = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        idx = torch.flip(idx, dims=(axis,))
    return idx.to(_dtype(dtype))


@register("shuffle", needs_key=True)
def shuffle(data, generator=None):
    """The rows of ``data`` in a random order drawn from ``generator``."""
    perm = torch.randperm(data.shape[0], generator=generator,
                          device=data.device)
    return data[perm]


# --------------------------------------------------------------------- #
# heads whose backward is the loss gradient, not the head gradient's
# product (the JAX ops' custom VJPs)
# --------------------------------------------------------------------- #
class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, scale):
        ctx.scale = scale
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.scale), None


@register("make_loss", aliases=("MakeLoss",))
def make_loss(data, grad_scale=1.0, normalization="null"):
    """Identity forward; the backward is ``grad_scale`` everywhere (over
    the batch for ``batch``, over the size for ``valid``)."""
    scale = grad_scale
    if normalization == "batch":
        scale = scale / data.shape[0]
    elif normalization == "valid":
        scale = scale / data.numel()
    return _MakeLoss.apply(data, scale)


class OutputHead(torch.autograd.Function):
    """``fwd(data)`` forward; backward ``grad(out, label)`` for the data
    and zero for the label, whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, fwd, grad):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.grad = grad
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        return ctx.grad(out, label), torch.zeros_like(label), None, None


def per_sample_outputs(p):
    """The regression heads' ``num_output``: elements a sample (the
    gradient is scaled by grad_scale / num_output, not by the batch)."""
    n = 1
    for s in p.shape[1:]:
        n *= s
    return max(n, 1)


@register("LinearRegressionOutput", aliases=("linear_regression_output",))
def linear_regression_output(data, label, grad_scale=1.0):
    """Identity forward; backward grad_scale * (data - label) /
    num_output."""
    return OutputHead.apply(
        data, label, lambda d: d.view_as(d),
        lambda d, l: grad_scale * (d - l) / per_sample_outputs(d))


# --------------------------------------------------------------------- #
# arithmetic with a Python scalar (the ``sym`` operator sugar's ops)
# --------------------------------------------------------------------- #
def _scalar_op(name, fn):
    def op(data, scalar=1.0):
        return fn(data, scalar)

    op.__name__ = name
    op.__doc__ = f"Elementwise ``{name}`` with a Python scalar."
    register(name)(op)


def _like(x, s):
    return torch.tensor(s, dtype=x.dtype, device=x.device)


_scalar_op("_plus_scalar", lambda x, s: x + s)
_scalar_op("_minus_scalar", lambda x, s: x - s)
_scalar_op("_rminus_scalar", lambda x, s: s - x)
_scalar_op("_mul_scalar", lambda x, s: x * s)
_scalar_op("_div_scalar", lambda x, s: x / s)
_scalar_op("_rdiv_scalar", lambda x, s: s / x)
_scalar_op("_mod_scalar", torch.remainder)          # floor mod (jnp.mod)
_scalar_op("_rmod_scalar", lambda x, s: torch.remainder(_like(x, s), x))
_scalar_op("_power_scalar", torch.pow)
_scalar_op("_rpower_scalar", lambda x, s: torch.pow(s, x))
_scalar_op("_maximum_scalar", lambda x, s: torch.maximum(x, _like(x, s)))
_scalar_op("_minimum_scalar", lambda x, s: torch.minimum(x, _like(x, s)))
_scalar_op("_equal_scalar", lambda x, s: (x == s).to(x.dtype))
_scalar_op("_not_equal_scalar", lambda x, s: (x != s).to(x.dtype))
_scalar_op("_greater_scalar", lambda x, s: (x > s).to(x.dtype))
_scalar_op("_greater_equal_scalar", lambda x, s: (x >= s).to(x.dtype))
_scalar_op("_lesser_scalar", lambda x, s: (x < s).to(x.dtype))
_scalar_op("_lesser_equal_scalar", lambda x, s: (x <= s).to(x.dtype))
