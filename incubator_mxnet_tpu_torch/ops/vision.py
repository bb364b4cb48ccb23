"""Spatial-transform, resampling, patch and fft operators: the port of the
JAX package's ``incubator_mxnet_tpu/ops/vision.py``.

``UpSampling`` (nearest: pixel repetition of every input to the first
one's scaled size, channel-concatenated; bilinear: the fixed depthwise
transposed convolution of kernel 2s - s%2, stride s and pad
ceil((s - 1) / 2), cut to exactly s·H x s·W, a trailing weight argument
being the filter in (C, 1, k, k) layout), ``BilinearSampler`` /
``GridGenerator`` (affine and warp) / ``SpatialTransformer``, ``im2col``
and its adjoint ``col2im`` (built, as the JAX op is, as the vector-
Jacobian product of ``im2col``), and ``fft`` / ``ifft`` with the real and
imaginary parts interleaved in the last axis (``ifft`` unnormalized:
``ifft(fft(x)) == d·x``).

``_grid_sample_zero_pad`` is the bilinear sampler every sampling op here
and in ``ops.contrib`` (deformable convolution, ``mrcnn_mask_target``)
shares: four gathers with per-tap validity weights, an out-of-range tap
counting as zero. Its backward is a scatter-add (atomics on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .nn import _convolve, _tup
from .registry import register


# --------------------------------------------------------------------- #
# sampling helpers
# --------------------------------------------------------------------- #
def _bilinear_weights_1d(scale, device):
    """The reference's bilinear deconvolution filter of size
    2*scale - scale % 2 (upsampling.cc init)."""
    k = 2 * scale - scale % 2
    center = (2 * scale - 1 - scale % 2) / (2.0 * scale)
    idx = torch.arange(k, dtype=torch.float32, device=device)
    return 1.0 - (idx / scale - center).abs()


def _grid_sample_zero_pad(feat, ys, xs):
    """Bilinear samples of a batch of images. feat: (B, C, H, W); ys / xs:
    (B, *S) in PIXEL coordinates. Returns (B, C, *S); a tap outside the
    image contributes zero (the reference BilinearSampler contract)."""
    B, C, H, W = feat.shape
    S = ys.shape[1:]
    flat = feat.reshape(B, C, H * W)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = ys - y0
    lx = xs - x0

    def tap(yi, xi, w):
        valid = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        yc = yi.clamp(0, H - 1).long()
        xc = xi.clamp(0, W - 1).long()
        idx = (yc * W + xc).reshape(B, 1, -1).expand(B, C, -1)
        vals = torch.gather(flat, 2, idx).reshape(B, C, *S)
        return vals * (w * valid)[:, None]

    return (tap(y0, x0, (1 - ly) * (1 - lx))
            + tap(y0, x0 + 1, (1 - ly) * lx)
            + tap(y0 + 1, x0, ly * (1 - lx))
            + tap(y0 + 1, x0 + 1, ly * lx))


# --------------------------------------------------------------------- #
# UpSampling
# --------------------------------------------------------------------- #
@register("UpSampling", aliases=("up_sampling",))
def upsampling(*data, scale=2, sample_type="nearest", num_filter=0,
               multi_input_mode="concat", num_args=None, workspace=None):
    """Spatial upsampling by an integer ``scale`` (see the module
    docstring)."""
    if not data:
        raise MXNetError("UpSampling needs at least one input")
    scale = int(scale)
    if sample_type == "nearest":
        target = (data[0].shape[2] * scale, data[0].shape[3] * scale)
        outs = [x.repeat_interleave(target[0] // x.shape[2], dim=2)
                .repeat_interleave(target[1] // x.shape[3], dim=3)
                for x in data]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    if sample_type != "bilinear":
        raise MXNetError(f"unknown sample_type {sample_type!r}")
    x = data[0]
    B, C, H, W = x.shape
    k = 2 * scale - scale % 2
    pad = -(-(scale - 1) // 2)  # ceil((scale-1)/2), the reference's pad
    if len(data) > 1:
        weight = data[1]
    else:
        w1 = _bilinear_weights_1d(scale, x.device)
        weight = (w1[:, None] * w1[None, :]).expand(C, 1, k, k) \
            .to(x.dtype).contiguous()
    out = _convolve(x, weight, None, (scale, scale), (pad, pad), (1, 1),
                    True, (0, 0), C)
    # reference output size is exactly scale * input
    return out[:, :, :H * scale, :W * scale]


# --------------------------------------------------------------------- #
# BilinearSampler / GridGenerator / SpatialTransformer
# --------------------------------------------------------------------- #
@register("BilinearSampler", aliases=("bilinear_sampler",))
def bilinear_sampler(data, grid, cudnn_off=None):
    """Sample ``data`` (B, C, H, W) at ``grid`` (B, 2, Ho, Wo): channel 0
    is x, channel 1 is y, normalized to [-1, 1] over the input extent.
    Out-of-range locations read zero."""
    B, C, H, W = data.shape
    xs = (grid[:, 0] + 1.0) * (W - 1) / 2.0
    ys = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    return _grid_sample_zero_pad(data, ys, xs)


def _linspace(n, device):
    """``jnp.linspace(-1, 1, n)`` in f32 (computed in f64, rounded once)."""
    return torch.linspace(-1.0, 1.0, n, dtype=torch.float64,
                          device=device).float()


@register("GridGenerator", aliases=("grid_generator",))
def grid_generator(data, transform_type="affine", target_shape=None):
    """A sampling grid for BilinearSampler. ``affine``: data (B, 6),
    row-major 2x3 matrices over the normalized target grid. ``warp``:
    data (B, 2, H, W), a pixel-offset flow field. Output (B, 2, Ho, Wo)
    normalized to [-1, 1]."""
    if transform_type == "affine":
        if target_shape is None:
            raise MXNetError("affine GridGenerator needs target_shape")
        Ho, Wo = int(target_shape[0]), int(target_shape[1])
        theta = data.reshape(-1, 2, 3)
        yy, xx = torch.meshgrid(_linspace(Ho, data.device),
                                _linspace(Wo, data.device), indexing="ij")
        base = torch.stack([xx.reshape(-1), yy.reshape(-1),
                            torch.ones_like(xx).reshape(-1)])
        out = torch.einsum("bij,jk->bik", theta, base.to(data.dtype))
        return out.reshape(-1, 2, Ho, Wo)
    if transform_type == "warp":
        B, two, H, W = data.shape
        jj = torch.arange(W, dtype=data.dtype, device=data.device)
        ii = torch.arange(H, dtype=data.dtype, device=data.device)
        x = (data[:, 0] + jj[None, None, :]) * (2.0 / max(W - 1, 1)) - 1.0
        y = (data[:, 1] + ii[None, :, None]) * (2.0 / max(H - 1, 1)) - 1.0
        return torch.stack([x, y], dim=1)
    raise MXNetError(f"unknown transform_type {transform_type!r}")


@register("SpatialTransformer", aliases=("spatial_transformer",))
def spatial_transformer(data, loc, target_shape=None,
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=None):
    """Affine spatial transformer network head: GridGenerator(loc) then
    BilinearSampler over ``data``."""
    if transform_type != "affine" or sampler_type != "bilinear":
        raise MXNetError("SpatialTransformer supports affine + bilinear")
    if target_shape is None:
        target_shape = data.shape[2:]
    grid = grid_generator(loc, transform_type="affine",
                          target_shape=target_shape)
    return bilinear_sampler(data, grid)


# --------------------------------------------------------------------- #
# im2col / col2im
# --------------------------------------------------------------------- #
@register("im2col")
def im2col(data, kernel=None, stride=None, dilate=None, pad=None):
    """Sliding-window patch extraction (1-3 spatial dims): (B, C, *S) ->
    (B, C*prod(kernel), prod(out)), channel-major taps (reference
    layout)."""
    kernel = _tup(kernel, 2)
    nsp = len(kernel)
    stride = tuple(s or 1 for s in (_tup(stride, nsp) or (1,) * nsp))
    dilate = tuple(d or 1 for d in (_tup(dilate, nsp) or (1,) * nsp))
    pad = _tup(pad, nsp) or (0,) * nsp
    x = F.pad(data, [p for q in reversed(pad) for p in (q, q)])
    for d in range(nsp):
        span = (kernel[d] - 1) * dilate[d] + 1
        x = x.unfold(2 + d, span, stride[d])[..., ::dilate[d]]
    # (B, C, *out, *k, ...) with the taps trailing: move them ahead of out
    B, C = data.shape[:2]
    out = x.shape[2:2 + nsp]
    perm = [0, 1] + [2 + nsp + i for i in range(nsp)] + \
        [2 + i for i in range(nsp)]
    x = x.permute(*perm)
    L = 1
    for o in out:
        L *= o
    return x.reshape(B, -1, L)


@register("col2im")
def col2im(data, output_size=None, kernel=None, stride=None, dilate=None,
           pad=None):
    """Adjoint of im2col: patches (B, C*prod(kernel), L) summed back into
    the image (B, C, *output_size); the vector-Jacobian product of
    ``im2col``, as the JAX op builds it."""
    kernel = _tup(kernel, 2)
    nsp = len(kernel)
    if output_size is None:
        raise MXNetError("col2im needs output_size")
    hw = tuple(int(s) for s in _tup(output_size, nsp))
    C = data.shape[1]
    for k in kernel:
        C //= k
    zeros = torch.zeros((data.shape[0], C) + hw, dtype=data.dtype,
                        device=data.device, requires_grad=True)
    with torch.enable_grad():
        cols = im2col(zeros, kernel=kernel, stride=stride, dilate=dilate,
                      pad=pad)
        img, = torch.autograd.grad(cols, zeros, grad_outputs=data,
                                   create_graph=data.requires_grad)
    return img


# --------------------------------------------------------------------- #
# fft / ifft (contrib)
# --------------------------------------------------------------------- #
@register("fft", aliases=("_contrib_fft",))
def fft(data, compute_size=128):
    """FFT along the last axis (reference: contrib/fft.cc, cuFFT). Real
    input (..., d) -> interleaved real / imaginary output (..., 2d)."""
    c = torch.fft.fft(data.float(), dim=-1)
    out = torch.stack([c.real, c.imag], dim=-1)
    return out.reshape(data.shape[:-1] + (2 * data.shape[-1],)) \
        .to(data.dtype)


@register("ifft", aliases=("_contrib_ifft",))
def ifft(data, compute_size=128):
    """Inverse FFT along the last axis. Interleaved input (..., 2d) -> real
    output (..., d), NOT normalized: ``ifft(fft(x)) == d * x``
    (contrib/fft.cc)."""
    d = data.shape[-1] // 2
    inter = data.reshape(data.shape[:-1] + (d, 2)).float()
    c = torch.complex(inter[..., 0], inter[..., 1])
    out = torch.fft.ifft(c, dim=-1).real * d
    return out.to(data.dtype)
