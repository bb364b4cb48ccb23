"""Attention primitives: the port of the JAX package's
``incubator_mxnet_tpu/ops/attention.py``.

  - ``_sdpa_dense`` (masked dense attention, what the monolithic prompt
    prefill and the dense KV-cache decode run): (B, T, H, D) matmul and
    softmax with -1e30 masking, scores in the input dtype, softmax in f32,
    probabilities cast back to the input dtype before the value product;
  - ``scaled_dot_product_attention``, the JAX signature (``flash=``,
    ``valid_length=``, ``layout=``) dispatching between it and
    ``flash_attention.use_flash_attention`` (the kernels, and for masks
    they do not take the blockwise plain path ``_sdpa_blockwise``).
"""

from __future__ import annotations

import torch

from ..base import MXNetError
from .flash_attention import use_flash_attention, valid_length_mask

__all__ = ["scaled_dot_product_attention"]

_NEG_INF = -1e30


def _sdpa_dense(q, k, v, mask, scale):
    """(B, T, H, D) attention, materializing the (B, H, Tq, Tk) scores."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def scaled_dot_product_attention(q, k, v, mask=None, scale=None,
                                 causal=False, flash=False,
                                 valid_length=None, layout="bthd"):
    """Multi-head attention core. q/k/v: (B, T, H, D). ``mask`` is either
    a key-padding mask (B, Tk) or broadcasts to (B, H, Tq, Tk), True =
    attend. ``causal`` is bottom-right aligned when Tq != Tk (queries at
    the end of the key buffer). Returns (B, Tq, H, D).

    ``flash=True`` (key-padding or no mask) runs the flash path
    (``flash_attention.use_flash_attention``): the CUDA kernels for
    length-form masks on a CUDA tensor, their plain versions on the CPU,
    the blockwise path for a boolean-only mask. ``layout="bhtd"`` (flash
    only) takes and returns (B, H, T, D), the kernels' layout.
    ``valid_length`` (B,) key lengths: the form the kernels need; given
    with ``mask`` both must describe the same prefix."""
    D = q.shape[-1]
    sc = D ** -0.5 if scale is None else scale
    if layout not in ("bthd", "bhtd"):
        raise MXNetError(f"sdpa: unknown layout {layout!r}")
    if layout == "bhtd" and not (flash and (mask is None or
                                            mask.dim() == 2)):
        raise MXNetError(
            "sdpa: layout='bhtd' is the flash-path fast layout; use the "
            "default layout for the dense/attention-weights path")
    if flash and (mask is None or mask.dim() == 2):
        return use_flash_attention(q, k, v, key_mask=mask, causal=causal,
                                   scale=sc, valid_length=valid_length,
                                   layout=layout)
    m = mask
    if m is not None and m.dim() == 2:
        m = m[:, None, None, :]                              # key padding
    if valid_length is not None:
        vlm = valid_length_mask(valid_length, k.shape[1],
                                q.device)[:, None, None, :]
        m = vlm if m is None else (m.bool() & vlm)
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        cm = torch.ones((Tq, Tk), dtype=torch.bool,
                        device=q.device).tril(Tk - Tq)[None, None]
        m = cm if m is None else (m & cm)
    return _sdpa_dense(q, k, v, m, sc)
