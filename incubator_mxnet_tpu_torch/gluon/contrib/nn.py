"""gluon.contrib.nn: the port of the JAX package's
``incubator_mxnet_tpu/gluon/contrib/nn.py`` (parity:
python/mxnet/gluon/contrib/nn/basic_layers.py).

``SparseEmbedding`` is ``nn.Embedding(sparse_grad=True)`` under the JAX
block's names. ``SyncBatchNorm`` all-reduces its batch statistics over
the process group of a multi-process step; without one it is
``nn.BatchNorm`` with ``num_devices`` kept.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ... import autograd
from ...base import MXNetError
from ...ndarray import NDArray
from .. import nn
from ..block import HybridBlock

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "PixelShuffle1D", "PixelShuffle2D", "PixelShuffle3D",
           "SyncBatchNorm"]


class HybridConcurrent(HybridBlock):
    """Runs children on the same input, concatenates outputs on ``axis``
    (parity: contrib.nn.HybridConcurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def hybrid_call(self, x):
        from ... import ndarray as nd
        outs = [child(x) for child in self._children.values()]
        return nd.concat(*outs, dim=self._axis)

    def forward(self, x):
        return self.hybrid_call(x)


class Concurrent(HybridConcurrent):
    """Eager twin (parity: contrib.nn.Concurrent)."""


class Identity(HybridBlock):
    """Passes input through unchanged (parity: contrib.nn.Identity —
    useful as a no-op branch in Concurrent)."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(HybridBlock):
    """Embedding with row_sparse gradients (parity:
    contrib.nn.SparseEmbedding), sugar over
    ``nn.Embedding(sparse_grad=True)``: the optimizer's lazy update
    touches only the looked-up rows (``optimizer._rows_update``)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self._emb = nn.Embedding(input_dim, output_dim, dtype=dtype,
                                     weight_initializer=weight_initializer,
                                     sparse_grad=True, prefix="")
        self.weight = self._emb.weight

    def hybrid_call(self, x):
        return self._emb(x)

    def forward(self, x):
        return self.hybrid_call(x)


class PixelShuffle2D(HybridBlock):
    """Rearranges (B, C*f1*f2, H, W) → (B, C, H*f1, W*f2) (parity:
    contrib.nn.PixelShuffle2D; sub-pixel convolution upsampling)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._factors = (factor, factor) if isinstance(factor, int) \
            else tuple(factor)

    def hybrid_forward(self, F, x):
        f1, f2 = self._factors
        B, C, H, W = x.shape
        if C % (f1 * f2):
            raise MXNetError(
                f"PixelShuffle2D: channels {C} not divisible by "
                f"{f1}*{f2}")
        c = C // (f1 * f2)
        x = F.reshape(x, shape=(B, c, f1, f2, H, W))
        x = F.transpose(x, axes=(0, 1, 4, 2, 5, 3))
        return F.reshape(x, shape=(B, c, H * f1, W * f2))


class PixelShuffle1D(HybridBlock):
    """(B, C*f, W) → (B, C, W*f) (parity: contrib.nn.PixelShuffle1D)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._factor = int(factor)

    def hybrid_forward(self, F, x):
        f = self._factor
        B, C, W = x.shape
        if C % f:
            raise MXNetError(f"PixelShuffle1D: channels {C} % {f} != 0")
        c = C // f
        x = F.reshape(x, shape=(B, c, f, W))
        x = F.transpose(x, axes=(0, 1, 3, 2))
        return F.reshape(x, shape=(B, c, W * f))


class PixelShuffle3D(HybridBlock):
    """(B, C*f1*f2*f3, D, H, W) → (B, C, D*f1, H*f2, W*f3)
    (parity: contrib.nn.PixelShuffle3D)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._factors = (factor,) * 3 if isinstance(factor, int) \
            else tuple(factor)

    def hybrid_forward(self, F, x):
        f1, f2, f3 = self._factors
        B, C, D, H, W = x.shape
        if C % (f1 * f2 * f3):
            raise MXNetError(
                f"PixelShuffle3D: channels {C} not divisible by "
                f"{f1}*{f2}*{f3}")
        c = C // (f1 * f2 * f3)
        x = F.reshape(x, shape=(B, c, f1, f2, f3, D, H, W))
        x = F.transpose(x, axes=(0, 1, 5, 2, 6, 3, 7, 4))
        return F.reshape(x, shape=(B, c, D * f1, H * f2, W * f3))


class _AllReduceSum(torch.autograd.Function):
    """A sum over the process group whose gradient is the sum of the
    ranks' gradients (each rank's input feeds every rank's output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


class SyncBatchNorm(nn.BatchNorm):
    """Cross-device synchronized BatchNorm (parity:
    contrib.nn.SyncBatchNorm; reference
    src/operator/contrib/sync_batch_norm.cc, which all-reduces the batch
    statistics over the workers).

    In training mode its batch mean and variance are those of the global
    batch: the per-channel sum and count, then the sum of squared
    deviations from the global mean, are summed over the process group
    by differentiable all-reduces (``_AllReduceSum``), so the
    gradient flows through the other ranks' statistics as well. The group
    is the one a running ``parallel.SPMDTrainer`` step splits its batch
    over, else the default group of a multi-process job. Without one it
    is ``nn.BatchNorm``. ``num_devices`` is kept for the API, as in the
    JAX class, whose mesh defines the group.
    """

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)
        self._num_devices = num_devices

    @staticmethod
    def _group():
        from ...parallel.spmd import batch_group
        group = batch_group()
        if group is None and dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            group = dist.group.WORLD
        return group

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        group = self._group()
        if group is None or not autograd.is_training() or \
                self._use_global_stats:
            return super().hybrid_forward(F, x, gamma, beta, running_mean,
                                          running_var)
        data = x._data.float()
        axes = tuple(i for i in range(data.dim()) if i != 1)
        bshape = (1, -1) + (1,) * (data.dim() - 2)
        count = torch.full((1,), float(data.numel() // data.shape[1]),
                           dtype=torch.float32, device=data.device)
        summed = _AllReduceSum.apply(torch.cat([data.sum(dim=axes), count]),
                                     group)
        mean = summed[:-1] / summed[-1]
        var = _AllReduceSum.apply(((data - mean.reshape(bshape)) ** 2)
                                  .sum(dim=axes), group) / summed[-1]
        out, _, _ = F.BatchNorm(
            x, gamma, beta, NDArray(mean), NDArray(var),
            eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale, use_global_stats=True, axis=1)
        m = self._momentum
        with torch.no_grad():
            running_mean._data.copy_(m * running_mean._data + (1 - m) *
                                     mean.detach().to(running_mean._data.dtype))
            running_var._data.copy_(m * running_var._data + (1 - m) *
                                    var.detach().to(running_var._data.dtype))
        return out
