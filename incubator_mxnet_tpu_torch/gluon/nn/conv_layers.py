"""Convolution and pooling layers: the port of the JAX package's
``incubator_mxnet_tpu/gluon/nn/conv_layers.py``.

Channels-first layouts (NCW, NCHW, NCDHW); each layer is one registered
op (``Convolution``, ``Deconvolution``, ``Pooling``, ``pad``; see
``ops/nn.py``). ``in_channels=0`` defers the weight's shape to the first
forward (``infer_shape``), as ``Dense`` defers ``in_units``. Parameter
names (``weight``, ``bias``) are the JAX block's, so structural names
match across the packages."""

from __future__ import annotations

from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution",
                 adj=None, **kwargs):
        super().__init__(**kwargs)
        ndim = len(kernel_size)
        self._channels = channels
        self._in_channels = in_channels
        self._kwargs = {
            "kernel": kernel_size, "stride": _tup(strides, ndim),
            "dilate": _tup(dilation, ndim), "pad": _tup(padding, ndim),
            "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias,
        }
        if adj is not None:
            self._kwargs["adj"] = adj
        self._op_name = op_name
        if op_name == "Convolution":
            wshape = (channels, in_channels // groups if in_channels else 0) \
                + tuple(kernel_size)
        else:  # Deconvolution: (in, out/groups, *k) as in the reference
            wshape = (in_channels if in_channels else 0, channels // groups) \
                + tuple(kernel_size)
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer)
            else:
                self.bias = None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def infer_shape(self, x, *args):
        in_c = x.shape[1]
        groups = self._kwargs["num_group"]
        k = tuple(self._kwargs["kernel"])
        if self._op_name == "Convolution":
            self.weight.shape = (self._channels, in_c // groups) + k
        else:
            self.weight.shape = (in_c, self._channels // groups) + k

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        out = op(x, weight, bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,)
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 2
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 3
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,)
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, op_name="Deconvolution",
                         adj=_tup(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 2
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, op_name="Deconvolution",
                         adj=_tup(output_padding, 2), **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 3
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, op_name="Deconvolution",
                         adj=_tup(output_padding, 3), **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", layout="NCHW",
                 count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": _tup(strides, len(pool_size)),
            "pad": _tup(padding, len(pool_size)), "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
        }
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 1), strides, padding, ceil_mode,
                         False, "max", layout, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 2), strides, padding, ceil_mode,
                         False, "max", layout, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 3), strides, padding, ceil_mode,
                         False, "max", layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_tup(pool_size, 1), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tup(pool_size, 2), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tup(pool_size, 3), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad, **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, 0, False, True, "max", layout, **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, False, True, "max", layout, **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, 0, False, True, "max", layout,
                         **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, 0, False, True, "avg", layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, False, True, "avg", layout, **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, 0, False, True, "avg", layout,
                         **kwargs)


class ReflectionPad2D(HybridBlock):
    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
