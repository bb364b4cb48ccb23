"""gluon.contrib.nn: the port of the JAX package's
``incubator_mxnet_tpu/gluon/contrib/nn.py`` (parity:
python/mxnet/gluon/contrib/nn/basic_layers.py).

``SparseEmbedding`` is ``nn.Embedding(sparse_grad=True)`` under the JAX
block's names. ``SyncBatchNorm`` on one device is ``nn.BatchNorm`` with
``num_devices`` kept.
"""

from __future__ import annotations

from ...base import MXNetError
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


class SyncBatchNorm(nn.BatchNorm):
    """Cross-device synchronized BatchNorm (parity: contrib.nn.SyncBatchNorm;
    reference src/operator/contrib/sync_batch_norm.cc). On one device it
    is ``nn.BatchNorm``; ``num_devices`` is kept for the API, as in the
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
