"""Symmetric quantization on tensors: the port's own copy of the scale
convention of ``incubator_mxnet_tpu/ops/quantization.py``, the one code
path the quantized KV pages (serve/paged_kv.py) use.

  - ``symmetric_scale(amax, qmax)`` is ``amax / qmax``, and 1.0 where
    ``amax == 0`` (an untouched page dequantizes its codes verbatim).
    The zero test is ``amax != 0``: ``NaN > 0`` is False, so a
    greater-than test would map a poisoned amax onto the benign
    fallback. A NaN amax gives a NaN scale, by design.
  - Integer targets round half to even (``torch.round``) before the clip
    to +-qmax and the cast; float8 targets clip then cast (the cast
    rounds to nearest even). ``torch.float8_e4m3fn`` has no saturating
    cast, so the clip to +-448 comes first.

The registry's six quantization ops (``quantize``, ``quantize_v2``,
``dequantize``, ``requantize``, ``quantized_fully_connected``,
``quantized_conv``, each with its ``_contrib_*`` alias) are the JAX
package's (``ops/quantization.py``): symmetric per-tensor int8 scales
(``quantize``'s ``uint8`` output affine), the range tensors returned on
the data's device. Their scales divide by a device tensor, never by a
Python number: PyTorch's CUDA division by a host scalar multiplies by its
reciprocal, one rounding away from the CPU's (and JAX's) quotient.

The int8 x int8 products accumulate in int32 exactly through
``torch._int_mm`` (cuBLASLt's int8 tensor-core product on the card; the
JAX package's is ``lax.dot_general`` with an int32 result, outside any
Pallas kernel). The card's product takes only m > 16 and k, n multiples
of 8, so the operands are padded with zero codes, which leave every sum
exact. ``quantized_conv`` runs the same product on an im2col of the int8
codes made from ``Tensor.unfold`` views (``F.unfold`` takes no int8),
one product per group.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register

__all__ = ["symmetric_scale", "quantize_symmetric", "dequantize_symmetric",
           "requantize_symmetric", "int8_matmul", "int8_conv"]


def symmetric_scale(amax, qmax=127.0):
    """f32 scale ``amax / qmax``; 1.0 where amax is exactly 0."""
    amax = torch.as_tensor(amax, dtype=torch.float32)
    return torch.where(amax != 0, amax / qmax, 1.0)


def _to_codes(y, dtype, qmax):
    if not dtype.is_floating_point:
        y = torch.round(y)
    return torch.clamp(y, -qmax, qmax).to(dtype)


def quantize_symmetric(x, scale, dtype=torch.int8, qmax=127.0):
    """``x / scale`` rounded (integer targets) or cast (float8 targets),
    saturated to +-qmax; the math runs in f32, ``scale`` broadcasts."""
    return _to_codes(x.float() / scale, dtype, qmax)


def dequantize_symmetric(q, scale):
    """Codes to f32: ``q * scale``."""
    return q.float() * scale


def requantize_symmetric(q, ratio, dtype=torch.int8, qmax=127.0):
    """Rescale existing codes by ``ratio = old_scale / new_scale <= 1``
    (a page's scale only grows): ``round(q * ratio)`` saturated — a code
    rescale, never a dequantize/quantize round trip."""
    return _to_codes(q.float() * ratio, dtype, qmax)


# --------------------------------------------------------------------- #
# the registry's quantization ops
# --------------------------------------------------------------------- #
def _range(v, device):
    """A range bound as a 0-dim f32 tensor on ``device``."""
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())


def _symmetric_scale(min_r, max_r, bits=8):
    """``symmetric_scale`` of ``max(|min|, |max|)``, divided by a device
    tensor (a correctly rounded quotient on every device)."""
    amax = torch.maximum(torch.abs(min_r.float()), torch.abs(max_r.float()))
    qmax = torch.full_like(amax, float(2 ** (bits - 1) - 1))
    return torch.where(amax != 0, amax / qmax, 1.0)


@register("quantize", aliases=("_contrib_quantize",), num_outputs=3)
def quantize(data, min_range, max_range, out_type="uint8"):
    """float -> int with explicit range tensors (reference:
    quantization/quantize.cc); ``(quantized, min_range, max_range)``.
    ``out_type='uint8'`` (the default) is affine: scale ``(max - min) /
    255``, zero point ``round(-min / scale)``; ``'int8'`` is symmetric."""
    min_r = _range(min_range, data.device)
    max_r = _range(max_range, data.device)
    if out_type == "int8":
        q = quantize_symmetric(data, _symmetric_scale(min_r, max_r))
    elif out_type == "uint8":
        scale = (max_r - min_r) / torch.full_like(min_r, 255.0)
        zero = torch.round(-min_r / scale)
        q = torch.clamp(torch.round(data.float() / scale) + zero, 0, 255) \
            .to(torch.uint8)
    else:
        raise MXNetError(
            f"quantize: out_type must be 'uint8' or 'int8', got "
            f"{out_type!r}")
    return q, min_r, max_r


@register("quantize_v2", aliases=("_contrib_quantize_v2",), num_outputs=3)
def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """float -> int8 with a symmetric scale (reference: quantize_v2.cc);
    ``(quantized, min_range, max_range)``. Without calibrated ranges the
    data's own min / max are used."""
    if min_calib_range is None:
        min_r, max_r = data.min(), data.max()
    else:
        min_r = _range(min_calib_range, data.device)
        max_r = _range(max_calib_range, data.device)
    return quantize_symmetric(data, _symmetric_scale(min_r, max_r)), \
        min_r, max_r


@register("dequantize", aliases=("_contrib_dequantize",))
def dequantize(data, min_range, max_range, out_type="float32"):
    """int8 -> f32 (reference: dequantize.cc)."""
    return dequantize_symmetric(data, _symmetric_scale(
        _range(min_range, data.device), _range(max_range, data.device)))


@register("requantize", aliases=("_contrib_requantize",), num_outputs=3)
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """int32 accumulator -> int8 with a new scale (reference:
    requantize.cc)."""
    in_scale = _symmetric_scale(_range(min_range, data.device),
                                _range(max_range, data.device), bits=32)
    real = data.float() * in_scale
    if min_calib_range is None:
        min_out, max_out = real.min(), real.max()
    else:
        min_out = _range(min_calib_range, data.device)
        max_out = _range(max_calib_range, data.device)
    return quantize_symmetric(real, _symmetric_scale(min_out, max_out)), \
        min_out, max_out


def _round_up(n, m):
    return -(-n // m) * m


def int8_matmul(a, b):
    """``a (m, k) @ b (n, k).T`` of int8 codes, accumulated in int32
    exactly by ``torch._int_mm``. Zero codes pad m past 16 and k, n to
    multiples of 8 (the card's product refuses other shapes)."""
    m, k = a.shape
    n = b.shape[0]
    kp = _round_up(k, 8)
    a, b = _padded(a, max(m, 17), kp), _padded(b, _round_up(n, 8), kp)
    return torch._int_mm(a, b.t())[:m, :n]


def _padded(x, rows, cols):
    """int8 ``x`` padded with zero codes to (rows, cols); no copy where it
    has that shape."""
    x = x.to(torch.int8)
    if x.shape == (rows, cols):
        return x
    return F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))


def _scaled(acc, s_d, s_w, bias, no_bias, shape):
    """The float output, ``acc * (s_d * s_w) (+ bias)``, and its range."""
    out = acc.float() * (s_d * s_w)
    if bias is not None and not no_bias:
        out = out + bias.reshape(shape)
    return out, out.min(), out.max()


@register("quantized_fully_connected",
          aliases=("_contrib_quantized_fully_connected",), num_outputs=3)
def quantized_fully_connected(data, weight, bias, min_data, max_data,
                              min_weight, max_weight, min_bias=None,
                              max_bias=None, num_hidden=None, no_bias=False):
    """int8 x int8 -> int32 product + float bias (reference:
    quantized_fully_connected.cc). data (..., K) int8, weight (N, K)
    int8; returns (f32 out, min_out, max_out)."""
    dev = data.device
    s_d = _symmetric_scale(_range(min_data, dev), _range(max_data, dev))
    s_w = _symmetric_scale(_range(min_weight, dev), _range(max_weight, dev))
    acc = int8_matmul(data.reshape(-1, data.shape[-1]), weight)
    acc = acc.reshape(*data.shape[:-1], weight.shape[0])
    return _scaled(acc, s_d, s_w, bias, no_bias, (-1,))


def _im2col(x, kernel, stride, pad, dilate):
    """int8 NCHW -> ``(N * OH * OW, C * KH * KW)`` rows in
    ``F.unfold``'s column order, and (OH, OW)."""
    N, C = x.shape[:2]
    if any(pad):
        x = F.pad(x, (pad[1], pad[1], pad[0], pad[0]))
    span = [d * (k - 1) + 1 for k, d in zip(kernel, dilate)]
    win = x.unfold(2, span[0], stride[0]).unfold(3, span[1], stride[1])
    win = win[..., ::dilate[0], ::dilate[1]]          # (N, C, OH, OW, KH, KW)
    OH, OW = win.shape[2:4]
    rows = win.permute(0, 2, 3, 1, 4, 5).reshape(N * OH * OW, -1)
    return rows, OH, OW


def int8_conv(data, weight, stride, pad, dilate, groups=1):
    """NCHW int8 codes convolved with OIHW int8 codes, accumulated in
    int32 exactly: one ``int8_matmul`` of an im2col a group."""
    O, Cg, KH, KW = weight.shape
    N, G = data.shape[0], int(groups)
    accs = []
    for g in range(G):
        rows, OH, OW = _im2col(data[:, g * Cg:(g + 1) * Cg].to(torch.int8),
                               (KH, KW), stride, pad, dilate)
        w = weight[g * (O // G):(g + 1) * (O // G)].reshape(O // G, -1)
        accs.append(int8_matmul(rows, w))
    acc = accs[0] if G == 1 else torch.cat(accs, 1)
    return acc.reshape(N, OH, OW, O).permute(0, 3, 1, 2)


@register("quantized_conv", aliases=("_contrib_quantized_conv",),
          num_outputs=3)
def quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                   max_weight, min_bias=None, max_bias=None, kernel=None,
                   stride=(1, 1), pad=(0, 0), dilate=(1, 1), num_filter=None,
                   num_group=1, no_bias=False, layout="NCHW"):
    """int8 convolution with int32 accumulation (reference:
    quantized_conv.cc). NCHW data, OIHW weight."""
    dev = data.device
    s_d = _symmetric_scale(_range(min_data, dev), _range(max_data, dev))
    s_w = _symmetric_scale(_range(min_weight, dev), _range(max_weight, dev))
    if data.ndim != 4:
        raise ValueError("quantized_conv supports 2-D (NCHW) data only")
    stride, pad, dilate = ((v, v) if isinstance(v, int) else tuple(v)
                           for v in (stride, pad, dilate))
    acc = int8_conv(data, weight, stride, pad, dilate, num_group)
    return _scaled(acc, s_d, s_w, bias, no_bias, (1, -1, 1, 1))
