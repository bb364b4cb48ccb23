"""The port's convolution, pooling and normalization ops and its conv /
pool layers against the JAX package's, on the same numpy inputs, on the
CPU.

  - every case of ``Convolution`` (1-3 spatial dims, stride, dilation,
    padding, groups, depthwise), ``Deconvolution`` (``adj``), ``Pooling``
    (max / avg / sum, ``valid`` and ``full`` at odd sizes, with and
    without ``count_include_pad``, global), ``AdaptiveAvgPooling2D``
    (divisible and not), ``L2Normalization``, ``LRN`` and ``pad`` equals
    the JAX ``nd.<op>`` at f32 rtol 1e-5, atol 1e-6;
  - the gradients of ``Convolution``, ``Deconvolution`` and ``Pooling``
    through ``autograd.record()`` equal ``jax.grad`` of the JAX op (same
    tolerance);
  - each conv / pool layer equals the JAX layer (outputs, input and
    parameter gradients, in training mode), structural names included;
    ``in_channels=0`` defers the weight's shape to the first forward as
    the JAX layer does;
  - a CUDA f32 convolution runs in IEEE f32, the setting restored after
    it; ``cuda``: the ops on the card against the CPU at rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.ops import nn as jops

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd as tag
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import nn as tops

from test_torch_parity import (assert_close, build_pair, fresh_names, host,
                               jax_arrays, port_arrays)

RS = np.random.RandomState
RTOL, ATOL = 1e-5, 1e-6


def _x(*shape, seed=0):
    return RS(seed).randn(*shape).astype(np.float32)


# name: (op, inputs, keywords)
OPS = {
    "conv1d-stride-pad": ("Convolution", [_x(2, 3, 9), _x(4, 3, 3, seed=1),
                                          _x(4, seed=2)],
                          dict(kernel=(3,), stride=(2,), pad=(1,),
                               num_filter=4)),
    "conv2d-dilate": ("Convolution", [_x(2, 3, 9, 8), _x(4, 3, 3, 3, seed=1),
                                      _x(4, seed=2)],
                      dict(kernel=(3, 3), stride=(2, 1), dilate=(2, 2),
                           pad=(1, 2), num_filter=4)),
    "conv2d-groups": ("Convolution", [_x(2, 4, 7, 7), _x(6, 2, 3, 3, seed=1)],
                      dict(kernel=(3, 3), pad=(1, 1), num_filter=6,
                           num_group=2, no_bias=True)),
    "conv2d-depthwise": ("Convolution", [_x(2, 4, 7, 7),
                                         _x(4, 1, 3, 3, seed=1)],
                         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                              num_filter=4, num_group=4, no_bias=True)),
    "conv3d": ("Convolution", [_x(1, 2, 5, 6, 4), _x(3, 2, 3, 3, 2, seed=1),
                               _x(3, seed=2)],
               dict(kernel=(3, 3, 2), stride=(1, 2, 1), pad=(1, 0, 1),
                    num_filter=3)),
    "deconv1d-adj": ("Deconvolution", [_x(2, 3, 5), _x(3, 4, 3, seed=1),
                                       _x(4, seed=2)],
                     dict(kernel=(3,), stride=(2,), pad=(1,), adj=(1,),
                          num_filter=4, no_bias=False)),
    "deconv2d-adj": ("Deconvolution", [_x(2, 3, 5, 4),
                                       _x(3, 2, 4, 3, seed=1)],
                     dict(kernel=(4, 3), stride=(2, 3), pad=(1, 1),
                          adj=(1, 2), num_filter=2)),
    "deconv2d-dilate": ("Deconvolution", [_x(1, 2, 4, 4),
                                          _x(2, 3, 3, 3, seed=1),
                                          _x(3, seed=2)],
                        dict(kernel=(3, 3), stride=(1, 1), dilate=(2, 2),
                             num_filter=3, no_bias=False,
                             target_shape=(8, 8))),
    "deconv3d": ("Deconvolution", [_x(1, 2, 3, 4, 3),
                                   _x(2, 2, 2, 3, 2, seed=1)],
                 dict(kernel=(2, 3, 2), stride=(2, 1, 2), pad=(0, 1, 0),
                      num_filter=2)),
    "max-valid-pad": ("Pooling", [_x(2, 3, 7, 7)],
                      dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max")),
    "max-valid": ("Pooling", [_x(2, 3, 7, 7)],
                  dict(kernel=(3, 3), stride=(2, 2), pool_type="max")),
    "max-full": ("Pooling", [_x(2, 3, 8, 8)],
                 dict(kernel=(3, 3), stride=(2, 2), pool_type="max",
                      pooling_convention="full")),
    "max-full-pad": ("Pooling", [_x(2, 3, 7, 6)],
                     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="max", pooling_convention="full")),
    "max-pad-over-half": ("Pooling", [_x(1, 2, 7, 7)],
                          dict(kernel=(2, 2), stride=(2, 2), pad=(2, 1),
                               pool_type="max")),
    "avg-valid-pad": ("Pooling", [_x(2, 3, 7, 7)],
                      dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="avg")),
    "avg-valid-pad-exclude": ("Pooling", [_x(2, 3, 7, 7)],
                              dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                   pool_type="avg",
                                   count_include_pad=False)),
    "avg-full": ("Pooling", [_x(2, 3, 8, 8)],
                 dict(kernel=(3, 3), stride=(2, 2), pool_type="avg",
                      pooling_convention="full")),
    "avg-full-pad": ("Pooling", [_x(2, 3, 7, 7)],
                     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="avg", pooling_convention="full")),
    "avg-full-pad-exclude": ("Pooling", [_x(2, 3, 7, 7)],
                             dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                  pool_type="avg", pooling_convention="full",
                                  count_include_pad=False)),
    "sum-full-pad": ("Pooling", [_x(2, 3, 7, 7)],
                     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="sum", pooling_convention="full")),
    "sum-valid": ("Pooling", [_x(2, 3, 7, 7)],
                  dict(kernel=(2, 3), stride=(1, 2), pool_type="sum")),
    "avg1d-full-exclude": ("Pooling", [_x(2, 3, 9)],
                           dict(kernel=(4,), stride=(3,), pad=(1,),
                                pool_type="avg", pooling_convention="full",
                                count_include_pad=False)),
    "max3d-full": ("Pooling", [_x(1, 2, 5, 6, 7)],
                   dict(kernel=(2, 3, 3), stride=(2, 2, 2),
                        pool_type="max", pooling_convention="full")),
    "avg3d-pad": ("Pooling", [_x(1, 2, 5, 6, 5)],
                  dict(kernel=(3, 3, 3), stride=(2, 2, 2), pad=(1, 1, 1),
                       pool_type="avg", count_include_pad=False)),
    "global-max": ("Pooling", [_x(2, 3, 5, 4)],
                   dict(global_pool=True, pool_type="max")),
    "global-avg": ("Pooling", [_x(2, 3, 5, 4, 3)],
                   dict(global_pool=True, pool_type="avg")),
    "global-sum": ("Pooling", [_x(2, 3, 5)],
                   dict(global_pool=True, pool_type="sum")),
    "adaptive-divisible": ("AdaptiveAvgPooling2D", [_x(2, 3, 8, 6)],
                           dict(output_size=(2, 3))),
    "adaptive-general": ("AdaptiveAvgPooling2D", [_x(2, 3, 7, 5)],
                         dict(output_size=(3, 2))),
    "adaptive-default": ("AdaptiveAvgPooling2D", [_x(2, 3, 5, 5)], {}),
    "l2norm-instance": ("L2Normalization", [_x(3, 4, 5)], {}),
    "l2norm-channel": ("L2Normalization", [_x(3, 4, 5)],
                       dict(mode="channel")),
    "l2norm-spatial": ("L2Normalization", [_x(3, 4, 2, 3)],
                       dict(mode="spatial", eps=1e-6)),
    "lrn": ("LRN", [_x(2, 7, 3, 3)], dict(nsize=3, alpha=1e-2, beta=0.5)),
    "pad-constant": ("pad", [_x(2, 3, 4)],
                     dict(pad_width=(0, 0, 1, 2, 2, 1),
                          constant_value=1.5)),
    "pad-reflect": ("pad", [_x(2, 3, 4, 5)],
                    dict(mode="reflect", pad_width=(0, 0, 0, 0, 2, 1, 1, 3))),
    "pad-edge": ("pad", [_x(2, 3, 4, 5)],
                 dict(mode="edge", pad_width=(0, 0, 0, 0, 1, 1, 0, 2))),
}


def _call(pkg, op, arrays, kw):
    return getattr(pkg, op)(*arrays, **kw)


@pytest.mark.parametrize("case", sorted(OPS))
def test_op_equals_jax(case):
    op, inputs, kw = OPS[case]
    want = _call(jnd, op, jax_arrays(inputs), kw)
    got = _call(nd, op, port_arrays(inputs), kw)
    assert got.shape == want.shape and str(got.dtype) == str(want.dtype)
    np.testing.assert_allclose(host(got), host(want), rtol=RTOL, atol=ATOL)


def test_op_refusals():
    with mx.cpu():
        x = nd.ones((1, 2, 4, 4))
        with pytest.raises(MXNetError, match="pool_type"):
            nd.Pooling(x, kernel=(2, 2), pool_type="lp")
        with pytest.raises(MXNetError, match="channels-first"):
            nd.Convolution(x, nd.ones((2, 2, 1, 1)), kernel=(1, 1),
                           no_bias=True, layout="NHWC")
        with pytest.raises(MXNetError, match="pooling_convention"):
            nd.Pooling(x, kernel=(2, 2), pooling_convention="same")
        with pytest.raises(MXNetError, match="trailing 3"):
            nd.pad(x, mode="reflect", pad_width=(1, 1, 0, 0, 0, 0, 0, 0))


GRAD_CASES = ["conv1d-stride-pad", "conv2d-dilate", "conv2d-groups",
              "conv2d-depthwise", "conv3d", "deconv1d-adj", "deconv2d-adj",
              "deconv3d", "max-valid-pad", "max-full-pad", "avg-full-pad",
              "avg-full-pad-exclude", "avg-valid-pad-exclude",
              "sum-full-pad", "max3d-full", "avg1d-full-exclude"]
_JAX_OPS = {"Convolution": jops.convolution,
            "Deconvolution": jops.deconvolution, "Pooling": jops.pooling}


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gradients_equal_jax_grad(case):
    op, inputs, kw = OPS[case]
    out_shape = _call(jnd, op, jax_arrays(inputs), kw).shape
    r = _x(*out_shape, seed=9)
    fn = _JAX_OPS[op]

    def jloss(*arrays):
        return jnp.sum(fn(*arrays, **kw) * r)

    want = jax.grad(jloss, argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(a) for a in inputs])
    xs = port_arrays(inputs)
    for x in xs:
        x.attach_grad()
    with tag.record():
        loss = (_call(nd, op, xs, kw) * nd.array(r, ctx=mx.cpu())).sum()
    loss.backward()
    for x, w in zip(xs, want):
        np.testing.assert_allclose(host(x.grad), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


LAYERS = {
    "Conv1D": (lambda g: g.nn.Conv1D(4, 3, strides=2, padding=1),
               [_x(2, 3, 9)]),
    "Conv2D": (lambda g: g.nn.Conv2D(5, (3, 2), strides=(2, 1), padding=1,
                                     dilation=(1, 2), activation="relu"),
               [_x(2, 3, 8, 7)]),
    "Conv2D-groups": (lambda g: g.nn.Conv2D(4, 3, padding=1, groups=2,
                                            use_bias=False, in_channels=4),
                      [_x(2, 4, 6, 6)]),
    "Conv3D": (lambda g: g.nn.Conv3D(3, 2, strides=(1, 2, 1)),
               [_x(1, 2, 4, 5, 4)]),
    "Conv1DTranspose": (lambda g: g.nn.Conv1DTranspose(
        3, 3, strides=2, padding=1, output_padding=1), [_x(2, 4, 5)]),
    "Conv2DTranspose": (lambda g: g.nn.Conv2DTranspose(
        2, (4, 3), strides=2, padding=1, output_padding=(1, 0)),
        [_x(2, 3, 4, 5)]),
    "Conv3DTranspose": (lambda g: g.nn.Conv3DTranspose(2, 2, strides=2),
                        [_x(1, 2, 2, 3, 2)]),
    "MaxPool1D": (lambda g: g.nn.MaxPool1D(3, 2, ceil_mode=True),
                  [_x(2, 3, 8)]),
    "MaxPool2D": (lambda g: g.nn.MaxPool2D(3, 2, 1), [_x(2, 3, 7, 7)]),
    "MaxPool2D-ceil": (lambda g: g.nn.MaxPool2D(3, 2, ceil_mode=True),
                       [_x(2, 3, 8, 8)]),
    "MaxPool3D": (lambda g: g.nn.MaxPool3D(2), [_x(1, 2, 4, 5, 4)]),
    "AvgPool1D": (lambda g: g.nn.AvgPool1D(3, 2, 1, count_include_pad=False),
                  [_x(2, 3, 8)]),
    "AvgPool2D": (lambda g: g.nn.AvgPool2D(3, 2, 1, ceil_mode=True),
                  [_x(2, 3, 7, 7)]),
    "AvgPool3D": (lambda g: g.nn.AvgPool3D(2, ceil_mode=True,
                                           count_include_pad=False),
                  [_x(1, 2, 5, 4, 5)]),
    "GlobalMaxPool1D": (lambda g: g.nn.GlobalMaxPool1D(), [_x(2, 3, 5)]),
    "GlobalMaxPool2D": (lambda g: g.nn.GlobalMaxPool2D(), [_x(2, 3, 5, 4)]),
    "GlobalMaxPool3D": (lambda g: g.nn.GlobalMaxPool3D(),
                        [_x(1, 2, 3, 4, 2)]),
    "GlobalAvgPool1D": (lambda g: g.nn.GlobalAvgPool1D(), [_x(2, 3, 5)]),
    "GlobalAvgPool2D": (lambda g: g.nn.GlobalAvgPool2D(), [_x(2, 3, 5, 4)]),
    "GlobalAvgPool3D": (lambda g: g.nn.GlobalAvgPool3D(),
                        [_x(1, 2, 3, 4, 2)]),
    "ReflectionPad2D": (lambda g: g.nn.ReflectionPad2D(2), [_x(2, 3, 4, 5)]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_equals_jax(name):
    make, inputs = LAYERS[name]
    jblk, tblk = build_pair(lambda: make(jgluon), lambda: make(tgluon),
                            inputs=inputs)
    assert sorted(tblk._collect_params_with_prefix()) == \
        sorted(jblk._collect_params_with_prefix())
    jx, tx = jax_arrays(inputs), port_arrays(inputs)
    for x in jx + tx:
        x.attach_grad()
    with jag.record(train_mode=True):
        jy = jblk(*jx)
        r = RS(9).randn(*jy.shape).astype(np.float32)
        jl = (jy * jnd.array(r)).sum()
    jl.backward()
    with tag.record(train_mode=True):
        ty = tblk(*tx)
        tl = (ty * nd.array(r, ctx=mx.cpu())).sum()
    tl.backward()
    assert_close(ty, jy, rtol=RTOL, atol=ATOL)
    assert_close(tx[0].grad, jx[0].grad, rtol=RTOL, atol=ATOL)
    jp = jblk._collect_params_with_prefix()
    for pname, p in tblk._collect_params_with_prefix().items():
        assert_close(p.grad(), jp[pname].grad(), rtol=RTOL, atol=ATOL)


def test_deferred_in_channels_equal_jax():
    def make(g):
        net = g.nn.HybridSequential()
        net.add(g.nn.Conv2D(4, 3, padding=1), g.nn.BatchNorm(),
                g.nn.Conv2DTranspose(3, 2, strides=2),
                g.nn.GlobalAvgPool2D(),
                g.nn.Dense(5))
        return net

    x = _x(2, 6, 5, 5)
    fresh_names()
    jblk = make(jgluon)
    jblk.initialize()
    fresh_names()
    tblk = make(tgluon)
    tblk.initialize(ctx=mx.cpu())
    before = {k: p.shape for k, p in
              tblk._collect_params_with_prefix().items()}
    assert before["0.weight"] == (4, 0, 3, 3)
    assert before["2.weight"] == (0, 3, 2, 2)
    jy = jblk(*jax_arrays([x]))
    ty = tblk(*port_arrays([x]))
    jp = jblk._collect_params_with_prefix()
    shapes = {k: p.shape for k, p in
              tblk._collect_params_with_prefix().items()}
    assert shapes == {k: p.shape for k, p in jp.items()}
    assert shapes["0.weight"] == (4, 6, 3, 3)
    assert shapes["2.weight"] == (4, 3, 2, 2)
    assert ty.shape == jy.shape == (2, 5)


def test_cuda_f32_convolution_is_ieee():
    conv = torch.backends.cudnn.conv
    old = conv.fp32_precision
    with tops._ieee_fp32(torch.device("cuda")):
        assert conv.fp32_precision == "ieee"
    assert conv.fp32_precision == old
    with tops._ieee_fp32(torch.device("cpu")):
        assert conv.fp32_precision == old


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(c for c in OPS
                                        if OPS[c][0] != "pad"))
def test_op_on_the_card_equals_the_cpu(cuda, case):
    op, inputs, kw = OPS[case]
    with mx.cpu():
        want = _call(nd, op, [nd.array(a) for a in inputs], kw)
    got = _call(nd, op, [nd.array(a, ctx=mx.gpu(0)) for a in inputs], kw)
    assert got.context == mx.gpu(0)
    w = host(want)
    np.testing.assert_allclose(host(got), w, rtol=1e-4, atol=1e-4 * float(
        np.abs(w[np.isfinite(w)]).max()))
