"""Packed-qkv flash self-attention for the transformer models: the port of
the JAX package's ``incubator_mxnet_tpu/models/_attention.py``.

The kernels are (B, H, T, D)-native while the projection produces
(B, T, 3, H, D). Relaying out q, k and v (and the output, and their
gradients) one by one around every kernel call costs a copy each; packing
once to (3, B, H, T, D) replaces them with one. The JAX package's sharding
constraints on the packed layout are mesh annotations and have no
counterpart on one device.
"""

from __future__ import annotations

import torch

from ..ops.attention import scaled_dot_product_attention
from ..ops.flash_attention import cuda_kernel_eligible

__all__ = ["packed_flash_self_attention", "use_packed_fast_path"]


def _tensor(x):
    return None if x is None else getattr(x, "_data", x)


def packed_flash_self_attention(F, qkv, B, T, H, D, units, causal=False,
                                mask=None, valid_length=None):
    """qkv: (B, T, 3, H, D), the projection's output (an ``NDArray``).
    Returns the attention output as a (B, T, units) ``NDArray``; the
    packing and the kernels' call are recorded when ``autograd`` records
    (``F`` is the JAX signature's op namespace, unused here)."""
    from .. import autograd
    from ..ndarray import NDArray
    m = _tensor(mask)
    if m is not None and m.dtype != torch.bool:
        m = m != 0
    with torch.set_grad_enabled(autograd.is_recording()):
        qkv_p = _tensor(qkv).permute(2, 0, 3, 1, 4).contiguous()
        out = scaled_dot_product_attention(
            qkv_p[0], qkv_p[1], qkv_p[2], mask=m, causal=causal, flash=True,
            valid_length=_tensor(valid_length), layout="bhtd")
        return NDArray(out.transpose(1, 2).reshape(B, T, units))


def use_packed_fast_path(D):
    """Take the packed layout when the flash path will run the bhtd entry
    (``flash_attention_bhtd``: kernels on the card, their plain versions
    on the CPU) rather than the blockwise path. Self-attention is square,
    so the causal Tq != Tk exclusion never applies. Callers must also
    pass the mask in length form (``valid_length``, or no mask)."""
    return cuda_kernel_eligible(D, causal=False)
