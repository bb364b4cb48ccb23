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
"""

from __future__ import annotations

import torch

__all__ = ["symmetric_scale", "quantize_symmetric", "dequantize_symmetric",
           "requantize_symmetric"]


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
