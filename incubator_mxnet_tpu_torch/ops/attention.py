"""Masked dense attention: the port of the JAX package's ``_sdpa_dense``
(``incubator_mxnet_tpu/ops/attention.py``), the attention that the
monolithic prompt prefill and the dense KV-cache decode run.

Plain PyTorch matmul and softmax on (B, T, H, D) tensors with the same
-1e30 masking: scores in the input dtype, softmax in f32, probabilities
cast back to the input dtype before the value product.
"""

from __future__ import annotations

import torch

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
                                 causal=False):
    """q/k/v: (B, T, H, D). ``mask`` broadcasts to (B, H, Tq, Tk), True =
    attend. ``causal`` is bottom-right aligned when Tq != Tk (queries sit
    at the end of the key buffer). Returns (B, Tq, H, D)."""
    D = q.shape[-1]
    sc = D ** -0.5 if scale is None else scale
    m = mask
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        cm = torch.ones((Tq, Tk), dtype=torch.bool,
                        device=q.device).tril(Tk - Tq)[None, None]
        m = cm if m is None else (m & cm)
    return _sdpa_dense(q, k, v, m, sc)
