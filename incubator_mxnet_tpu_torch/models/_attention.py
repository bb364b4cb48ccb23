"""Packed-qkv flash self-attention for the transformer models: the port of
the JAX package's ``incubator_mxnet_tpu/models/_attention.py``.

The kernels are (B, H, T, D)-native while the projection produces
(B, T, 3, H, D). Relaying out q, k and v (and the output, and their
gradients) one by one around every kernel call costs a copy each; packing
once to (3, B, H, T, D) replaces them with one. The JAX package's sharding
constraints on the packed layout are mesh annotations and have no
counterpart on one device.

The sequence- and tensor-parallel helpers the models share: ``seq_mesh``
(the mesh whose sp axis splits a seq_parallel model's sequence, inside an
SPMD step), ``local_heads`` (the heads a rank computes on a tp axis),
``ring_attention`` (a rank's attention over its sequence block),
``tp_hints`` (the JAX models' sharding hints on their Dense layers) and
``tp_dense`` (such a Dense on a rank's tile of the tp axis).
"""

from __future__ import annotations

import torch

from ..ops.attention import scaled_dot_product_attention
from ..ops.flash_attention import cuda_kernel_eligible

__all__ = ["packed_flash_self_attention", "use_packed_fast_path",
           "seq_mesh", "local_heads", "ring_attention", "tp_hints",
           "tp_axis", "tp_dense"]


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


def tp_hints(col, row, parts=1):
    """The JAX tensor-parallel hints on two gluon ``Dense`` layers:
    ``col`` column-parallel (its output features over tp, read as
    ``parts`` equal parts each split), ``row`` row-parallel."""
    col.weight._sharding, col.bias._sharding = ("tp", None), ("tp",)
    col.weight._tp_groups = col.bias._tp_groups = parts
    row.weight._sharding = (None, "tp")


def tp_axis():
    """The active SPMD mesh's tp axis (``parallel.spmd.TPAxis``) when it
    has more than one rank, else None."""
    from ..parallel.spmd import TPAxis
    return TPAxis.of(None)


def tp_dense(dense, x, tp):
    """``dense(x)`` for a gluon ``Dense`` (flatten=False) with a
    ``tp_hints`` hint; on a tp axis ``tp`` (``tp_axis()``), this rank's
    tile (``parallel.spmd.tp_linear``). An ``NDArray`` in and out."""
    if tp is None:
        return dense(x)
    from .. import autograd
    from ..ndarray import NDArray
    from ..parallel.spmd import tp_linear
    w = dense.weight
    with torch.set_grad_enabled(autograd.is_recording()):
        y = tp_linear(x._data, w._var, dense.bias._var, w._sharding, tp,
                      getattr(w, "_tp_groups", 1))
    return NDArray(y)


def seq_mesh(seq_parallel: bool, seq_len: int, what: str):
    """The active mesh when a ``seq_parallel`` model runs inside an SPMD
    step whose sp axis is > 1 (its stream is then this rank's block of
    the sequence, from the first block to the head), else None. A
    sequence the sp axis does not divide raises ``MXNetError``."""
    from ..base import MXNetError
    from ..parallel import mesh as _mesh
    from ..parallel.spmd import active_mesh
    mesh = active_mesh() if seq_parallel else None
    if mesh is None:
        return None
    sp = _mesh.axis_sizes(mesh)["sp"]
    if sp <= 1:
        return None
    if seq_len % sp:
        raise MXNetError(f"{what}(seq_parallel=True): sequence length "
                         f"{seq_len} does not divide over the sp axis of "
                         f"{sp}")
    return mesh


def local_heads(heads: int, what: str):
    """``(heads this rank computes, the tp axis or None)``: all of them
    off a tp axis, ``heads / tp`` on one (the qkv projection is
    column-parallel by whole heads, the output projection row-parallel;
    ``parallel.spmd.tp_linear``)."""
    from ..base import MXNetError
    tp = tp_axis()
    if tp is None:
        return heads, None
    if heads % tp.size:
        raise MXNetError(f"{what}: {heads} heads do not divide over the tp "
                         f"axis of {tp.size}")
    return heads // tp.size, tp


def ring_attention(q, k, v, mesh, causal=False, flash=False,
                   valid_length=None):
    """This rank's attention over its (B, T/sp, H, D) blocks of q, k, v
    (``NDArray``s) by the sp ring: the flash kernels' ring
    (``ring_flash_attention``) for ``flash`` CUDA tensors at a head width
    the kernels take with no key lengths (GPT), else the plain streaming
    ring (``ring_self_attention``; BERT's global ``valid_length``).
    Returns an ``NDArray``; recorded when ``autograd`` records."""
    from .. import autograd
    from ..ndarray import NDArray
    from ..parallel.ring_attention import (ring_flash_attention,
                                           ring_self_attention)
    tq, tk, tv = _tensor(q), _tensor(k), _tensor(v)
    with torch.set_grad_enabled(autograd.is_recording()):
        if flash and tq.is_cuda and valid_length is None and \
                cuda_kernel_eligible(tq.shape[-1]):
            out = ring_flash_attention(tq, tk, tv, mesh=mesh, causal=causal)
        else:
            out = ring_self_attention(tq, tk, tv, mesh=mesh, causal=causal,
                                      valid_length=_tensor(valid_length))
    return NDArray(out)
