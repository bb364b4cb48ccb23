"""Neural-network operators: the port of the JAX package's
``incubator_mxnet_tpu/ops/nn.py`` (dense, convolution, deconvolution,
pooling, embedding, normalization, activation, softmax and dropout),
plus the registered ``scaled_dot_product_attention`` (``ops.attention``;
with ``flash=True`` the flash kernels on a CUDA tensor).

The JAX numerics are kept: LayerNorm, BatchNorm, InstanceNorm and
GroupNorm compute statistics and the affine transform in f32 and return
the input dtype; BatchNorm returns ``(out, batch_mean, batch_var)`` and
the gluon layer updates the running statistics; Dropout is inverted
dropout whose mask is drawn from ``mx.random``'s generator for the
input's device (the ``generator=`` the front end passes) in place of the
JAX op's PRNG key.

Convolution and deconvolution are NC(D)HW with OI(D)HW weights
(deconvolution's ``(in, out / groups, *k)``, torch's transposed layout),
one ``aten.convolution`` each; the JAX op is one
``lax.conv_general_dilated``, outside any Pallas kernel. A CUDA f32
convolution runs its forward and both backward products with cuDNN's
f32 math set to IEEE (cuDNN would take TF32 by default), set around each
call and restored after it. Pooling builds the JAX op's windows: the
``full`` convention pads the high side by ``max(need, pad)`` and
``count_include_pad`` divides by the whole kernel, so where torch's
window rule differs (``ceil_mode``, or a pad over half the kernel) the
input is padded explicitly and pooled without padding.
``AdaptiveAvgPooling2D`` keeps the JAX op's f32 integral image for bins
that do not divide the input. ``CTCLoss`` is not ported.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .attention import scaled_dot_product_attention as _sdpa
from .registry import register


@register("FullyConnected", aliases=("fully_connected",))
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    """y = x W^T + b, weight (num_hidden, in_units)."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    if data.shape[-1] != weight.shape[1]:
        raise MXNetError(f"FullyConnected: input width {data.shape[-1]} "
                         f"!= weight's {weight.shape[1]}")
    return F.linear(data, weight, None if no_bias else bias)


@register("Embedding", aliases=("embedding",))
def embedding(data, weight, input_dim=None, output_dim=None,
              dtype="float32", sparse_grad=False):
    """Row lookup, indices clipped to the table."""
    return F.embedding(data.long().clamp(0, weight.shape[0] - 1), weight)


def _tup(v, n):
    if v is None:
        return (0,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _spatial(kernel, weight):
    nsp = len(kernel) if kernel is not None else weight.ndim - 2
    if not 1 <= nsp <= 3:
        raise MXNetError("convolution supports 1-3 spatial dims")
    return nsp


def _check_layout(layout, nsp):
    if layout is not None and layout != "NC" + "DHW"[-nsp:]:
        raise MXNetError(f"layout {layout!r}: the port's convolutions and "
                         f"pooling are channels-first (NC{'DHW'[-nsp:]})")


@contextlib.contextmanager
def _ieee_fp32(device):
    """cuDNN's f32 convolutions in IEEE f32 (not TF32) for the block, on a
    CUDA device; the setting in force before is restored after it."""
    if device.type != "cuda":
        yield
        return
    conv = torch.backends.cudnn.conv
    old = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = old


class _Convolution(torch.autograd.Function):
    """``aten.convolution`` whose forward and backward both run under
    ``_ieee_fp32`` (the backward reads cuDNN's settings when it runs, not
    when the forward did)."""

    @staticmethod
    def forward(ctx, x, w, b, conf):
        ctx.conf = conf
        ctx.has_bias = b is not None
        ctx.save_for_backward(x, w)
        with _ieee_fp32(x.device):
            return torch.ops.aten.convolution(x, w, b, *conf)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, pad, dilate, transposed, adj, groups = ctx.conf
        out_c = w.shape[1] * groups if transposed else w.shape[0]
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                ctx.has_bias and ctx.needs_input_grad[2]]
        with _ieee_fp32(x.device):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, w, [out_c] if ctx.has_bias else None, stride, pad,
                dilate, transposed, adj, groups, mask)
        return gx, gw, gb, None


def _convolve(data, weight, bias, stride, pad, dilate, transposed, adj,
              groups):
    conf = (list(stride), list(pad), list(dilate), transposed, list(adj),
            int(groups))
    return _Convolution.apply(data, weight, bias, conf)


@register("Convolution", aliases=("convolution",))
def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None):
    """N-d convolution (1-3 spatial dims), NC(D)HW data, OI(D)HW weight,
    symmetric ``pad``, ``num_group`` feature groups."""
    nsp = _spatial(kernel, weight)
    _check_layout(layout, nsp)
    stride = tuple(s or 1 for s in _tup(stride, nsp))
    dilate = tuple(d or 1 for d in _tup(dilate, nsp))
    return _convolve(data, weight, None if no_bias else bias, stride,
                     _tup(pad, nsp), dilate, False, (0,) * nsp, num_group)


@register("Deconvolution", aliases=("deconvolution",))
def deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=None,
                  num_group=1, no_bias=True, target_shape=None,
                  layout=None):
    """Transposed convolution, weight ``(in, out / groups, *k)``; ``adj``
    adds to the output's high side. ``target_shape`` is accepted and, as
    in the JAX op, does not change the output."""
    nsp = _spatial(kernel, weight)
    _check_layout(layout, nsp)
    stride = tuple(s or 1 for s in _tup(stride, nsp))
    dilate = tuple(d or 1 for d in _tup(dilate, nsp))
    return _convolve(data, weight, None if no_bias else bias, stride,
                     _tup(pad, nsp), dilate, True, _tup(adj, nsp),
                     num_group)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _avg_pool(x, kernel, stride, pad=None, count_include_pad=True,
              divisor_override=None):
    """avg_pool{2,3}d (a 1-d input through the 2-d one)."""
    if len(kernel) == 1:
        out = _avg_pool(x.unsqueeze(-2), (1,) + kernel, (1,) + stride,
                        None if pad is None else (0,) + pad,
                        count_include_pad, divisor_override)
        return out.squeeze(-2)
    return _AVG_POOL[len(kernel)](
        x, kernel, stride, pad or 0, count_include_pad=count_include_pad,
        divisor_override=divisor_override)


@register("Pooling", aliases=("pooling",))
def pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, layout=None):
    """Max / avg / sum pooling over NC(D)HW data, the JAX op's windows:
    ``valid`` or ``full`` (ceil) convention, symmetric ``pad`` (the
    ``full`` high side padded to cover the last window), ``avg`` dividing
    by the whole kernel unless ``count_include_pad=False``."""
    nsp = data.ndim - 2
    _check_layout(layout, nsp)
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError(f"pool_type {pool_type}")
    if global_pool:
        axes = tuple(range(2, data.ndim))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        if pool_type == "avg":
            return data.mean(dim=axes, keepdim=True)
        return data.sum(dim=axes, keepdim=True)
    kernel = _tup(kernel, nsp)
    stride = tuple(s or 1 for s in _tup(stride, nsp))
    pad = _tup(pad, nsp)
    if pooling_convention == "full":
        hi = []
        for i in range(nsp):
            size = data.shape[2 + i]
            out = -(-(size + 2 * pad[i] - kernel[i]) // stride[i]) + 1
            hi.append(max((out - 1) * stride[i] + kernel[i] - size - pad[i],
                          pad[i]))
    elif pooling_convention == "valid":
        hi = list(pad)
    else:
        raise MXNetError(f"pooling_convention {pooling_convention!r}")
    native = hi == list(pad) and all(2 * p <= k for p, k in zip(pad, kernel))
    if native:
        if pool_type == "max":
            return _MAX_POOL[nsp](data, kernel, stride, pad)
        if pool_type == "sum":
            return _avg_pool(data, kernel, stride, pad, divisor_override=1)
        # a valid window never passes the padded input, so torch divides
        # by the whole kernel (or by the unpadded count), as the JAX op
        return _avg_pool(data, kernel, stride, pad, count_include_pad)
    flat = []
    for lo, h in zip(reversed(pad), reversed(hi)):
        flat += [lo, h]
    if pool_type == "max":
        return _MAX_POOL[nsp](F.pad(data, flat, value=float("-inf")),
                              kernel, stride)
    padded = F.pad(data, flat)
    if pool_type == "sum":
        return _avg_pool(padded, kernel, stride, divisor_override=1)
    if count_include_pad:
        return _avg_pool(padded, kernel, stride)
    ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                      device=data.device)
    counts = _avg_pool(F.pad(ones, flat), kernel, stride,
                       divisor_override=1)
    return _avg_pool(padded, kernel, stride, divisor_override=1) / counts


@register("AdaptiveAvgPooling2D", aliases=("contrib_AdaptiveAvgPooling2D",
                                           "_contrib_AdaptiveAvgPooling2D"))
def adaptive_avg_pooling2d(data, output_size=None):
    """Average over ``output_size`` (default 1 x 1) bins of NCHW data, bin
    i spanning ``[floor(i H / oh), ceil((i + 1) H / oh))``."""
    if output_size is None:
        output_size = (1, 1)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    n, c, h, w = data.shape
    oh, ow = output_size
    if h % oh == 0 and w % ow == 0:
        return data.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    # exact per-bin averages from an integral image: its magnitude reaches
    # H * W, past bf16's 8-bit mantissa, and the a - b - c + d difference
    # would cancel, so it is summed in f32
    ii = torch.cumsum(torch.cumsum(data.float(), dim=2), dim=3)
    ii = F.pad(ii, (1, 0, 1, 0))
    dev = data.device
    hs = (torch.arange(oh, device=dev) * h) // oh
    he = ((torch.arange(oh, device=dev) + 1) * h + oh - 1) // oh
    ws = (torch.arange(ow, device=dev) * w) // ow
    we = ((torch.arange(ow, device=dev) + 1) * w + ow - 1) // ow
    a = ii[:, :, he[:, None], we[None, :]]
    b = ii[:, :, hs[:, None], we[None, :]]
    c_ = ii[:, :, he[:, None], ws[None, :]]
    d = ii[:, :, hs[:, None], ws[None, :]]
    area = ((he - hs)[:, None] * (we - ws)[None, :]).float()
    return ((a - b - c_ + d) / area).to(data.dtype)


@register("L2Normalization")
def l2_normalization(data, eps=1e-10, mode="instance"):
    """``data / sqrt(sum(data^2) + eps)`` over every axis but the batch
    (``instance``), the channel axis (``channel``) or the spatial axes
    (``spatial``)."""
    if mode == "instance":
        axes = tuple(range(1, data.ndim))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, data.ndim))
    else:
        raise MXNetError(f"mode {mode}")
    return data / torch.sqrt(data.square().sum(dim=axes, keepdim=True) + eps)


@register("LRN")
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across channels:
    ``data / (knorm + alpha * window_sum(data^2) / nsize) ^ beta``."""
    pad = nsize // 2
    sq = F.pad(data.square(), (0, 0) * (data.ndim - 2) + (pad, pad))
    windows = sum(sq[:, i:i + data.shape[1]] for i in range(nsize))
    return data / torch.pow(knorm + alpha * windows / nsize, beta)


@register("BatchNorm", aliases=("batch_norm",), num_outputs=3,
          training_aware=True)
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               axis=1, training=None):
    """Batch normalization; returns ``(out, batch_mean, batch_var)`` (the
    running statistics when not training), the statistics in the running
    statistics' dtype."""
    dt = data.dtype
    x = data.float()
    ax = axis % data.ndim
    axes = tuple(i for i in range(data.ndim) if i != ax)
    bshape = tuple(data.shape[i] if i == ax else 1 for i in range(data.ndim))
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if training and not use_global_stats:
        mean = torch.mean(x, dim=axes)
        var = torch.var(x, dim=axes, unbiased=False)
    else:
        mean, var = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    out = ((x - mean.reshape(bshape)) * (inv * g).reshape(bshape)
           + beta.reshape(bshape)).to(dt)
    if training and not use_global_stats:
        return out, mean.to(moving_mean.dtype), var.to(moving_var.dtype)
    return out, moving_mean, moving_var


@register("LayerNorm", aliases=("layer_norm",))
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Statistics and affine in f32, output in the input dtype."""
    if axis % data.ndim == data.ndim - 1:
        return F.layer_norm(data.float(), gamma.shape, gamma.float(),
                            beta.float(), eps).to(data.dtype)
    ax = axis % data.ndim
    x = data.float()
    mean = x.mean(dim=ax, keepdim=True)
    var = x.var(dim=ax, keepdim=True, unbiased=False)
    bshape = tuple(data.shape[a] if a == ax else 1 for a in range(data.ndim))
    out = (x - mean) * torch.rsqrt(var + eps)
    out = out * gamma.reshape(bshape).float() + \
        beta.reshape(bshape).float()
    return out.to(data.dtype)


@register("InstanceNorm", aliases=("instance_norm",))
def instance_norm(data, gamma, beta, eps=1e-3):
    """Per-instance, per-channel normalization of (N, C, ...) data."""
    x = data.float()
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    out = (x - mean) * torch.rsqrt(var + eps)
    return (out * gamma.reshape(bshape) + beta.reshape(bshape)) \
        .to(data.dtype)


@register("GroupNorm", aliases=("group_norm",))
def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    """Normalization over channel groups of (N, C, ...) data."""
    n, c = data.shape[:2]
    spatial = tuple(data.shape[2:])
    x = data.float().reshape((n, num_groups, c // num_groups) + spatial)
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    return (x * gamma.reshape(bshape) + beta.reshape(bshape)).to(data.dtype)


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
}


@register("Activation", aliases=("activation",))
def activation(data, act_type="relu"):
    """relu, sigmoid, tanh, softrelu (softplus) or softsign."""
    if act_type not in _ACTIVATIONS:
        raise MXNetError(f"unknown act_type {act_type!r}")
    return _ACTIVATIONS[act_type](data)


@register("LeakyReLU", needs_key=True, training_aware=True)
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, generator=None,
               training=None):
    """leaky, prelu, elu, selu, gelu (exact, erf) or rrelu (a slope drawn
    per element in training, the bounds' mean otherwise)."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2)) \
            if gamma.ndim == 1 and data.ndim > 2 else gamma
        return torch.where(data > 0, data, g * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        return 1.0507009873554805 * torch.where(
            data > 0, data, 1.6732632423543772 * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data)
    if act_type == "rrelu":
        if training:
            s = torch.empty_like(data).uniform_(lower_bound, upper_bound,
                                                generator=generator)
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(data > 0, data, s * data)
    raise MXNetError(f"unknown act_type {act_type!r}")


@register("gelu")
def gelu(data, approximate=False):
    """Gaussian error linear unit (exact unless ``approximate``)."""
    return F.gelu(data, approximate="tanh" if approximate else "none")


@register("softmax", aliases=("Softmax",))
def softmax(data, axis=-1, temperature=None, length=None):
    """Softmax along ``axis``; ``length`` (B,) masks positions past each
    row's length to 0."""
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    if length is None:
        return torch.softmax(data, dim=axis)
    T = data.shape[axis]
    mask = torch.arange(T, device=data.device)[None, :] < \
        length[:, None].long()
    shape = [1] * data.ndim
    shape[0] = data.shape[0]
    shape[axis % data.ndim] = T
    mask = mask.reshape(shape)
    out = torch.softmax(torch.where(mask, data, float("-inf")), dim=axis)
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return torch.log_softmax(data, dim=axis)


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """Summed cross entropy of (B, C) scores against (B,) labels."""
    logp = torch.log_softmax(data, dim=-1)
    return -torch.gather(logp, -1, label.long()[:, None]).sum()


@register("Dropout", aliases=("dropout",), needs_key=True,
          training_aware=True)
def dropout(data, p=0.5, mode="training", axes=(), generator=None,
            training=None):
    """Inverted dropout, ``x * mask / keep`` with the mask in x's dtype
    drawn from ``generator``; identity outside training (unless
    ``mode="always"``). ``axes`` broadcast one mask along them."""
    if (not training and mode != "always") or p == 0.0:
        return data
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    keep = 1.0 - p
    # one out-of-place draw (the in-place form's values): a selective
    # checkpoint saves it, so a rematerialized block replays its masks
    mask = torch.bernoulli(torch.empty(shape, dtype=data.dtype,
                                       device=data.device), keep,
                           generator=generator)
    return data * mask / keep


@register("scaled_dot_product_attention", aliases=("sdpa",))
def scaled_dot_product_attention(q, k, v, mask=None, scale=None,
                                 causal=False, flash=False,
                                 valid_length=None, layout="bthd"):
    """Multi-head attention core over (B, T, H, D) (``ops.attention``);
    ``flash=True`` with a key-length mask takes the flash path (the CUDA
    kernels on a CUDA tensor, their plain versions on the CPU). A
    non-boolean mask attends where it is nonzero."""
    if mask is not None and mask.dtype != torch.bool:
        mask = mask != 0
    return _sdpa(q, k, v, mask=mask, scale=scale, causal=causal,
                 flash=flash, valid_length=valid_length, layout=layout)
