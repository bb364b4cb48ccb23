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
from .registry import register

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


@register("masked_softmax")
def masked_softmax(scores, mask=None, axis=-1):
    """Softmax where ``mask`` (nonzero = keep) holds; -1e30 elsewhere."""
    if mask is not None:
        scores = torch.where(mask.bool(), scores, _NEG_INF)
    return torch.softmax(scores, dim=axis)


@register("div_sqrt_dim", aliases=("_contrib_div_sqrt_dim",))
def div_sqrt_dim(data):
    """data / sqrt(last dimension)."""
    return data * (data.shape[-1] ** -0.5)


def _split_interleaved(qkv, heads, parts):
    """(S, B, heads * parts * D) -> ``parts`` tensors of (B * heads, S,
    D)."""
    S, B = qkv.shape[0], qkv.shape[1]
    x = qkv.reshape(S, B, heads, parts, -1)
    return [x[:, :, :, p, :].permute(1, 2, 0, 3).reshape(B * heads, S, -1)
            for p in range(parts)]


def _heads_to_seq(out, B, heads):
    """(B * heads, S, D) -> (S, B, heads * D)."""
    S = out.shape[1]
    return out.reshape(B, heads, S, -1).permute(2, 0, 1, 3).reshape(S, B,
                                                                      -1)


@register("interleaved_matmul_selfatt_qk",
          aliases=("_contrib_interleaved_matmul_selfatt_qk",))
def interleaved_matmul_selfatt_qk(queries_keys_values, heads=1):
    """Scaled Q K^T of an interleaved (S, B, H * 3 * D) projection:
    (B * H, S, S)."""
    q, k, _ = _split_interleaved(queries_keys_values, heads, 3)
    return torch.matmul(q * (q.shape[-1] ** -0.5), k.transpose(1, 2))


@register("interleaved_matmul_selfatt_valatt",
          aliases=("_contrib_interleaved_matmul_selfatt_valatt",))
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads=1):
    """attention @ V, back in the (S, B, H * D) layout."""
    _, _, v = _split_interleaved(queries_keys_values, heads, 3)
    return _heads_to_seq(torch.matmul(attention, v),
                         queries_keys_values.shape[1], heads)


@register("interleaved_matmul_encdec_qk",
          aliases=("_contrib_interleaved_matmul_encdec_qk",))
def interleaved_matmul_encdec_qk(queries, keys_values, heads=1):
    """Scaled Q K^T of queries (Sq, B, H * D) against interleaved
    keys / values (Sk, B, H * 2 * D): (B * H, Sq, Sk)."""
    Sq, B = queries.shape[0], queries.shape[1]
    q = queries.reshape(Sq, B, heads, -1).permute(1, 2, 0, 3) \
        .reshape(B * heads, Sq, -1)
    k, _ = _split_interleaved(keys_values, heads, 2)
    return torch.matmul(q * (q.shape[-1] ** -0.5), k.transpose(1, 2))


@register("interleaved_matmul_encdec_valatt",
          aliases=("_contrib_interleaved_matmul_encdec_valatt",))
def interleaved_matmul_encdec_valatt(keys_values, attention, heads=1):
    """attention @ V for cross-attention: (Sq, B, H * D)."""
    _, v = _split_interleaved(keys_values, heads, 2)
    return _heads_to_seq(torch.matmul(attention, v), keys_values.shape[1],
                         heads)


def _sldwin_band_mask(L, w, symmetric, dilation, dtype, device):
    """(L, L) band: key j within ``w`` dilated steps of query i (before it
    only, unless ``symmetric``), on the dilation's grid. ``dilation`` may
    be an int or a tensor (the reference passes it as an input)."""
    i = torch.arange(L, device=device)[:, None]
    d = torch.arange(L, device=device)[None, :] - i
    dil = torch.as_tensor(dilation, device=device).reshape(-1)[0].long()
    lo = -w * dil
    hi = w * dil if symmetric else torch.zeros_like(dil)
    band = (d >= lo) & (d <= hi) & \
        (torch.remainder(d, torch.clamp(dil, min=1)) == 0)
    return band.to(dtype)


@register("sldwin_atten_mask_like",
          aliases=("_contrib_sldwin_atten_mask_like",))
def sldwin_atten_mask_like(score, dilation, valid_length, num_heads=1,
                           w=1, symmetric=True):
    """Ones where a (B * H, L, L) banded score is valid: in the band and
    both positions inside their sequence's length."""
    L = score.shape[-1]
    band = _sldwin_band_mask(L, int(w), bool(symmetric), dilation,
                             score.dtype, score.device)
    B = score.shape[0] // num_heads
    vl = valid_length.long().reshape(B, 1)
    keyok = (torch.arange(L, device=score.device)[None, :] < vl) \
        .to(score.dtype)
    keyok = torch.repeat_interleave(keyok, num_heads, dim=0)
    return band[None] * keyok[:, None, :] * keyok[:, :, None]


@register("sldwin_atten_score", aliases=("_contrib_sldwin_atten_score",))
def sldwin_atten_score(query, key, dilation, num_heads=1, w=1,
                       symmetric=True):
    """Banded Q K^T of (B, L, H * D) inputs: (B * H, L, L), zero outside
    the band."""
    B, L, HD = query.shape
    D = HD // num_heads
    q = query.reshape(B, L, num_heads, D).permute(0, 2, 1, 3)
    k = key.reshape(B, L, num_heads, D).permute(0, 2, 1, 3)
    scores = torch.matmul(q, k.transpose(-1, -2)).reshape(B * num_heads, L,
                                                          L)
    return scores * _sldwin_band_mask(L, int(w), bool(symmetric), dilation,
                                      scores.dtype, scores.device)[None]


@register("sldwin_atten_context",
          aliases=("_contrib_sldwin_atten_context",))
def sldwin_atten_context(score, value, dilation, num_heads=1, w=1,
                         symmetric=True):
    """attention @ V over the band: (B * H, L, L) scores and (B, L, H * D)
    values -> (B, L, H * D)."""
    BH, L, _ = score.shape
    B = BH // num_heads
    D = value.shape[-1] // num_heads
    band = _sldwin_band_mask(L, int(w), bool(symmetric), dilation,
                             score.dtype, score.device)
    s = (score * band[None]).reshape(B, num_heads, L, L)
    v = value.reshape(B, L, num_heads, D).permute(0, 2, 1, 3)
    return torch.matmul(s, v).permute(0, 2, 1, 3).reshape(B, L,
                                                          num_heads * D)
