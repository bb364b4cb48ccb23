"""Miscellaneous operators: the port of the JAX package's
``incubator_mxnet_tpu/ops/misc.py``.

``khatri_rao``, ``digamma``, ``cumsum`` / ``cumprod``, ``moments``,
``unravel_index`` / ``ravel_multi_index`` (the JAX op's clipping of
out-of-range flat indices), the legacy ``choose_element_0index`` /
``fill_element_0index``, ``Correlation`` (FlowNet), the legacy ``Crop``,
the ``LogisticRegressionOutput`` / ``MAERegressionOutput`` / ``SVMOutput``
heads (a ``torch.autograd.Function`` each: the JAX custom VJP's loss
gradient, whatever the head gradient), ``amp_multicast``,
``all_finite`` / ``multi_all_finite``, ``BilinearResize2D`` (align
corners), ``index_array``, ``quadratic``, ``allclose``, ``arange_like``,
``histogram`` (the last bin includes its right edge) and ``isnan`` /
``isinf`` / ``isfinite`` (0 / 1 in the input dtype), with their
``_contrib_*`` aliases.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register
from .tensor import OutputHead, per_sample_outputs


# --------------------------------------------------------------------- #
# math
# --------------------------------------------------------------------- #
@register("khatri_rao")
def khatri_rao(*matrices):
    """Column-wise Kronecker product: (n_i, k) inputs -> (prod n_i, k)."""
    if not matrices:
        raise MXNetError("khatri_rao needs at least one matrix")
    out = matrices[0]
    for m in matrices[1:]:
        if m.shape[1] != out.shape[1]:
            raise MXNetError("khatri_rao: column counts must match")
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[1])
    return out


@register("digamma")
def digamma(data):
    return torch.digamma(data)


def _cumulative(fn, data, axis, dtype):
    out = fn(data.reshape(-1), 0) if axis is None else fn(data, axis)
    if dtype:
        from ..ndarray.ndarray import to_torch_dtype
        out = out.to(to_torch_dtype(dtype))
    return out


@register("cumsum")
def cumsum(data, axis=None, dtype=None):
    """Running sum (of the flattened array when ``axis`` is None)."""
    return _cumulative(torch.cumsum, data, axis, dtype)


@register("cumprod")
def cumprod(data, axis=None, dtype=None):
    return _cumulative(torch.cumprod, data, axis, dtype)


@register("moments", num_outputs=2)
def moments(data, axes=None, keepdims=False):
    """Mean and (population) variance over ``axes``."""
    dims = tuple(axes) if axes is not None else None
    mean = torch.mean(data, dim=dims, keepdim=keepdims)
    var = torch.var(data, dim=dims, correction=0, keepdim=keepdims)
    return mean, var


# --------------------------------------------------------------------- #
# index math
# --------------------------------------------------------------------- #
@register("unravel_index", aliases=("unravel",))
def unravel_index(data, shape=None):
    """Flat indices -> a (K, ...) coordinate array for a K-d ``shape``;
    an index outside [-size, size) is clipped to it first."""
    if shape is None:
        raise MXNetError("unravel_index needs shape")
    dims = [int(s) for s in shape]
    cum = [1]
    for d in reversed(dims):
        cum.insert(0, cum[0] * d)
    flat = data.long().reshape(-1).clamp(-cum[0], cum[0] - 1)
    coords = [torch.remainder(flat, cum[k]) // cum[k + 1]
              for k in range(len(dims))]
    return torch.stack([c.to(data.dtype) for c in coords]) \
        .reshape((len(dims),) + tuple(data.shape))


@register("ravel_multi_index", aliases=("ravel",))
def ravel_multi_index(data, shape=None):
    """A (K, N) coordinate array -> (N,) flat indices."""
    if shape is None:
        raise MXNetError("ravel_multi_index needs shape")
    idx = torch.zeros(data.shape[1:], dtype=data.dtype, device=data.device)
    for k, d in enumerate(int(s) for s in shape):
        idx = idx * d + data[k]
    return idx


@register("choose_element_0index")
def choose_element_0index(lhs, rhs):
    """out[i] = lhs[i, rhs[i]]."""
    idx = rhs.long().reshape(-1)
    return torch.gather(lhs, 1, idx[:, None])[:, 0]


@register("fill_element_0index")
def fill_element_0index(lhs, mhs, rhs):
    """lhs with out[i, rhs[i]] = mhs[i]."""
    idx = rhs.long().reshape(-1)
    rows = torch.arange(lhs.shape[0], device=lhs.device)
    return lhs.index_put((rows, idx), mhs.reshape(-1))


# --------------------------------------------------------------------- #
# Correlation (FlowNet) / Crop
# --------------------------------------------------------------------- #
@register("Correlation", aliases=("correlation",))
def correlation(data1, data2, kernel_size=1, max_displacement=1,
                stride1=1, stride2=1, pad_size=0, is_multiply=True):
    """Cross-correlation volume (B, D*D, H', W'), D = 2 *
    (max_displacement // stride2) + 1: one product (or |difference|) a
    displacement, averaged over a k x k window ("SAME" zero padding) and
    the channels, at the centres where window and displacement stay
    inside."""
    pad = int(pad_size)
    if pad:
        data1 = F.pad(data1, (pad, pad, pad, pad))
        data2 = F.pad(data2, (pad, pad, pad, pad))
    d2r = int(max_displacement) // int(stride2)
    disps = [d * int(stride2) for d in range(-d2r, d2r + 1)]
    k = int(kernel_size)
    lo, hi = (k - 1) // 2, k - 1 - (k - 1) // 2
    Hp, Wp = data1.shape[2], data1.shape[3]
    b = k // 2 + max(abs(disps[0]), abs(disps[-1]))
    ys = torch.arange(b, Hp - b, int(stride1), device=data1.device)
    xs = torch.arange(b, Wp - b, int(stride1), device=data1.device)
    maps = []
    for dy in disps:
        for dx in disps:
            shifted = torch.roll(data2, shifts=(-dy, -dx), dims=(2, 3))
            prod = data1 * shifted if is_multiply \
                else torch.abs(data1 - shifted)
            if k > 1:
                prod = F.avg_pool2d(F.pad(prod, (lo, hi, lo, hi)), k,
                                    stride=1)
            m = torch.mean(prod, dim=1)
            maps.append(m[:, ys][:, :, xs])
    return torch.stack(maps, dim=1)


@register("Crop")
def crop_op(*data, num_args=None, offset=(0, 0), h_w=(0, 0),
            center_crop=False):
    """data[0]'s spatial dims cropped to data[1]'s (two inputs) or to
    ``h_w``, at ``offset`` or centred."""
    x = data[0]
    H, W = x.shape[2], x.shape[3]
    if len(data) > 1:
        th, tw = data[1].shape[2], data[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    if th > H or tw > W:
        raise MXNetError("Crop target larger than input")
    if center_crop:
        oy, ox = (H - th) // 2, (W - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    return x[:, :, oy:oy + th, ox:ox + tw]


# --------------------------------------------------------------------- #
# *Output heads
# --------------------------------------------------------------------- #
@register("LogisticRegressionOutput", aliases=("logistic_regression_output",))
def logistic_regression_output(data, label, grad_scale=1.0):
    """sigmoid forward; backward (p - label) * grad_scale / num_output."""
    return OutputHead.apply(
        data, label, torch.sigmoid,
        lambda p, l: (p - l) * (grad_scale / per_sample_outputs(p)))


@register("MAERegressionOutput", aliases=("mae_regression_output",))
def mae_regression_output(data, label, grad_scale=1.0):
    """Identity forward; backward sign(pred - label) * grad_scale /
    num_output."""
    return OutputHead.apply(
        data, label, lambda d: d.view_as(d),
        lambda p, l: torch.sign(p - l) * (grad_scale /
                                          per_sample_outputs(p)))


@register("SVMOutput", aliases=("svm_output",))
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """Identity forward; backward the hinge (``use_linear``) or squared
    hinge gradient on the margin violations."""
    def grad(p, l):
        oh = F.one_hot(l.long(), p.shape[-1]).to(p.dtype)
        sign = 2.0 * oh - 1.0
        viol = (margin - sign * p) > 0
        zero = torch.zeros((), dtype=p.dtype, device=p.device)
        if use_linear:
            g = torch.where(viol, -sign, zero)
        else:
            g = torch.where(viol, -2.0 * sign * (margin - sign * p), zero)
        return g * regularization_coefficient

    return OutputHead.apply(data, label, lambda d: d.view_as(d), grad)


# --------------------------------------------------------------------- #
# AMP helpers
# --------------------------------------------------------------------- #
_WIDTH = {torch.float16: 0, torch.bfloat16: 0, torch.float32: 1,
          torch.float64: 2}


@register("amp_multicast",
          num_outputs=lambda attrs: int(attrs.get("num_outputs", 1)))
def amp_multicast(*data, num_outputs=None, cast_narrow=False):
    """Every input cast to the widest float type among them (the
    narrowest with ``cast_narrow``); the first such input's type wins a
    tie."""
    if num_outputs is not None and int(num_outputs) != len(data):
        raise MXNetError("amp_multicast: num_outputs != #inputs")
    ranked = sorted((d.dtype for d in data),
                    key=lambda t: _WIDTH.get(t, 1))
    target = ranked[0] if cast_narrow else ranked[-1]
    return tuple(d.to(target) for d in data)


@register("all_finite")
def all_finite(data, init_output=True):
    """1.0 when every element is finite, else 0.0."""
    return torch.isfinite(data).all().to(torch.float32)


@register("multi_all_finite", num_outputs=1)
def multi_all_finite(*data, num_arrays=None, init_output=True):
    ok = torch.ones((), dtype=torch.bool, device=data[0].device)
    for d in data:
        ok = ok & torch.isfinite(d).all()
    return ok.to(torch.float32)


@register("BilinearResize2D", aliases=("_contrib_BilinearResize2D",))
def bilinear_resize_2d(data, height=None, width=None, scale_height=None,
                       scale_width=None, like=None, mode="size"):
    """Bilinear resize of (B, C, H, W) with align-corners sampling, to
    ``height`` x ``width``, by both scales, or to ``like``'s spatial
    size."""
    B, C, H, W = data.shape
    if mode == "like" or (like is not None and height is None
                          and scale_height is None):
        if like is None:
            raise MXNetError("BilinearResize2D mode='like' needs `like`")
        height, width = like.shape[2], like.shape[3]
    elif scale_height is not None or scale_width is not None:
        if scale_height is None or scale_width is None:
            raise MXNetError(
                "BilinearResize2D needs BOTH scale_height and scale_width")
        height, width = int(H * scale_height), int(W * scale_width)
    if height is None or width is None:
        raise MXNetError(
            "BilinearResize2D needs height+width, both scales, or like=")
    dev = data.device
    ys = _linspace(0.0, H - 1.0, int(height), dev)
    xs = _linspace(0.0, W - 1.0, int(width), dev)
    y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
    y1, x1 = torch.clamp(y0 + 1, max=H - 1), torch.clamp(x0 + 1, max=W - 1)
    ly = (ys - y0).to(data.dtype)[None, None, :, None]
    lx = (xs - x0).to(data.dtype)[None, None, None, :]
    top = data[:, :, y0][:, :, :, x0] * (1 - ly) + \
        data[:, :, y1][:, :, :, x0] * ly
    bot = data[:, :, y0][:, :, :, x1] * (1 - ly) + \
        data[:, :, y1][:, :, :, x1] * ly
    return top * (1 - lx) + bot * lx


def _linspace(lo, hi, num, device):
    """``jnp.linspace``'s f32 arithmetic: start (1 - i / div) + stop
    (i / div), the last point ``stop`` itself."""
    lo = torch.as_tensor(lo, dtype=torch.float32, device=device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=device)
    if num == 1:
        return lo.reshape(1)
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / \
        float(num - 1)
    return torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])


@register("index_array", aliases=("_contrib_index_array",))
def index_array(data, axes=None):
    """Each element's coordinates along ``axes`` (all by default), as a
    trailing int32 axis."""
    axes = tuple(range(data.ndim)) if axes is None else tuple(axes)
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.int32,
                                          device=data.device)
                             for s in data.shape], indexing="ij")
    return torch.stack([grids[a] for a in axes], dim=-1)


@register("quadratic", aliases=("_contrib_quadratic",))
def quadratic(data, a=0.0, b=0.0, c=0.0):
    """a x^2 + b x + c."""
    return a * data * data + b * data + c


@register("allclose", aliases=("_contrib_allclose",))
def allclose_op(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    """1.0 when |a - b| <= atol + rtol |b| everywhere, else 0.0."""
    return torch.isclose(a, b, rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all().to(torch.float32)


@register("arange_like", aliases=("_contrib_arange_like",))
def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """f32 ``start + step * i`` shaped like ``data`` (along ``axis``
    only, when given), each value ``repeat`` times."""
    if axis is None:
        n = data.numel()
        out = start + step * torch.arange(n, dtype=torch.float32,
                                          device=data.device)
        if repeat != 1:
            out = torch.repeat_interleave(out, repeat)
        return out[:n].reshape(data.shape)
    idx = torch.arange(data.shape[axis], dtype=torch.float32,
                       device=data.device)
    if repeat != 1:
        idx = torch.floor(idx / repeat)
    return start + step * idx


def _counts(flat, edges, nb, inside):
    idx = torch.clamp(torch.searchsorted(edges, flat, right=True) - 1, 0,
                      nb - 1)
    return torch.zeros((nb,), dtype=torch.int32, device=flat.device) \
        .index_add(0, idx, inside.to(torch.int32))


@register("histogram", aliases=("_histogram",), num_outputs=2)
def histogram(data, bins=10, range=None):
    """(hist int32, bin_edges) of the flattened data: ``bins`` equal bins
    over ``range`` (the data's min and max by default; a zero-width range
    widens by 0.5 each way), or the given increasing edges. The last bin
    includes its right edge."""
    flat = data.reshape(-1)
    if torch.is_tensor(bins) or isinstance(bins, (list, tuple)):
        edges = bins if torch.is_tensor(bins) else torch.as_tensor(
            bins, dtype=torch.float32, device=data.device)
        if edges.ndim != 1 or edges.shape[0] < 2:
            raise MXNetError(
                "histogram: bins must be an int or a 1-D array of at "
                f"least 2 edges (got shape {tuple(edges.shape)})")
        if not bool((edges[1:] >= edges[:-1]).all()):
            raise MXNetError("histogram: bins must increase monotonically")
        inside = (flat >= edges[0]) & (flat <= edges[-1])
        return _counts(flat, edges.to(flat.dtype), edges.shape[0] - 1,
                       inside), edges
    if range is not None:
        lo, hi = range
        if hi < lo:
            raise MXNetError("histogram: max must be larger than min "
                             f"(got range=({lo}, {hi}))")
        lo = torch.tensor(float(lo), dtype=torch.float32, device=data.device)
        hi = torch.tensor(float(hi), dtype=torch.float32, device=data.device)
    else:
        lo, hi = torch.min(flat), torch.max(flat)
    same = hi <= lo
    lo = torch.where(same, lo - 0.5, lo)
    hi = torch.where(same, hi + 0.5, hi)
    edges = _linspace(lo, hi, int(bins) + 1, data.device)
    inside = (flat >= lo) & (flat <= hi)
    return _counts(flat, edges, int(bins), inside), edges


@register("isnan", aliases=("_contrib_isnan",))
def isnan_op(data):
    """0 / 1 in the input dtype (so ``1 - mask`` is arithmetic)."""
    return torch.isnan(data).to(data.dtype)


@register("isinf", aliases=("_contrib_isinf",))
def isinf_op(data):
    return torch.isinf(data).to(data.dtype)


@register("isfinite", aliases=("_contrib_isfinite",))
def isfinite_op(data):
    return torch.isfinite(data).to(data.dtype)
