"""The port's int8 quantization ops and ``contrib.quantization`` against
the JAX package on the CPU.

  - the six registry ops (``quantize`` uint8 and int8, ``quantize_v2``,
    ``dequantize``, ``requantize``, ``quantized_fully_connected``,
    ``quantized_conv``) on the case table's cases (k = 147 and m <= 16,
    groups, dilation): bitwise the JAX functions run op by op, codes,
    ranges and float outputs alike; against the jitted JAX op at the
    case's rtol (XLA fuses the products' scale and bias into one FMA);
  - the int32 accumulators of ``int8_matmul`` / ``int8_conv`` bitwise
    the JAX ops' (``lax.dot_general`` / ``lax.conv_general_dilated`` with
    an int32 result: the ResNet stem's 7x7 stride 2, a grouped dilated
    conv, k = 147) and numpy's int64 product at shapes the card's
    product refuses unpadded (m <= 16, k and n not multiples of 8), with
    codes of +-127;
  - ``calib_thresholds_entropy`` and ``_rebin`` equal the JAX functions;
  - ``quantize_net`` on an MLP and a small conv net, ``naive`` and
    ``entropy``: the same layers swapped, the same int8 weights
    (bitwise), the same thresholds (the first layer's bitwise; the later
    ones, from f32 activations summed in another order, at rtol 1e-5),
    and the int8 nets' outputs within one quantum of the JAX net's (the
    last layer's input scale times its weights' scale times the largest
    row sum of |codes|: what one flipped input code at a rounding edge
    can move); the refusals, and symbolic tracing refused with the JAX
    message.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.contrib import quantization as jq
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon, nd
from incubator_mxnet_tpu_torch.contrib import quantization as tq
from incubator_mxnet_tpu_torch.ops import registry as treg
from incubator_mxnet_tpu_torch.ops.quantization import int8_conv, int8_matmul

from test_torch_op_cases import CASES, case_ids, ids
from test_torch_parity import build_pair, jax_arrays, port_arrays
from torch_op_parity import op_equals_jax

CASE_IDS = case_ids("quantization")


@pytest.mark.parametrize("name,i,dtype", CASE_IDS, ids=ids(CASE_IDS))
def test_op_case_equals_jax(name, i, dtype):
    op_equals_jax(name, i, dtype)


@pytest.mark.parametrize("name,i", [(n, i) for n, i, _ in CASE_IDS],
                         ids=[f"{n}-{i}" for n, i, _ in CASE_IDS])
def test_op_equals_the_eager_jax_function_bitwise(name, i):
    """Every output bitwise the JAX function's run op by op (no jit, so
    no fused multiply-add): codes, ranges, the float outputs."""
    make, kw, _, _ = CASES[name][i]
    inputs = make()
    want = jreg.get(name).fn(*[jnp.asarray(a) for a in inputs], **kw)
    got = treg.get(name).fn(*[torch.from_numpy(a) for a in inputs], **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)


def _codes(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("case", ["fc_k147", "fc_m3", "stem", "grouped"])
def test_int32_accumulators_equal_jax(case):
    """``int8_matmul`` / ``int8_conv`` bitwise the JAX ops' int32
    accumulators (``lax.dot_general`` / ``lax.conv_general_dilated`` with
    an int32 result)."""
    rng = np.random.RandomState(3)
    if case.startswith("fc"):
        m = 5 if case == "fc_k147" else 3
        a, b = _codes(rng, m, 147), _codes(rng, 9, 147)
        want = lax.dot_general(jnp.asarray(a), jnp.asarray(b),
                               (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.int32)
        got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    else:
        stem = case == "stem"
        x = _codes(rng, 2, 3 if stem else 4, 12, 11)
        w = _codes(rng, 8, 3, 7, 7) if stem else _codes(rng, 6, 2, 3, 3)
        stride, pad, dil, g = ((2, 2), (3, 3), (1, 1), 1) if stem else \
            ((1, 2), (2, 1), (2, 1), 2)
        want = lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), window_strides=stride,
            padding=[(p, p) for p in pad], rhs_dilation=dil,
            feature_group_count=g, dimension_numbers=("NCHW", "OIHW", "NCHW"),
            preferred_element_type=jnp.int32)
        got = int8_conv(torch.from_numpy(x), torch.from_numpy(w), stride,
                        pad, dil, g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (5, 147, 9), (16, 8, 8),
                                   (17, 13, 3), (40, 576, 64)])
def test_int8_matmul_is_exact(m, k, n):
    rng = np.random.RandomState(m + k + n)
    a = rng.randint(-127, 128, (m, k)).astype(np.int8)
    b = rng.randint(-127, 128, (n, k)).astype(np.int8)
    a[0] = 127
    b[0] = 127 if k % 2 else -127
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64).T)


def test_calibration_helpers_equal_jax():
    rng = np.random.RandomState(0)
    acts = np.abs(rng.standard_t(3, 20000))
    hist, edges = np.histogram(acts, bins=1024)
    assert tq.calib_thresholds_entropy(hist, edges) == \
        jq.calib_thresholds_entropy(hist, edges)
    new_edges = np.linspace(0, edges[-1] * 1.7, 1025)
    np.testing.assert_array_equal(tq._rebin(hist, edges, new_edges),
                                  jq._rebin(hist, edges, new_edges))


def _mlp(g):
    net = g.nn.HybridSequential()
    net.add(g.nn.Dense(32, activation="relu"), g.nn.Dense(16,
                                                         activation="relu"),
            g.nn.Dense(4))
    return net


def _convnet(g):
    net = g.nn.HybridSequential()
    net.add(g.nn.Conv2D(8, 3, padding=1, activation="relu"),
            g.nn.Conv2D(8, 3, strides=2, groups=2, use_bias=False),
            g.nn.Activation("relu"), g.nn.Flatten(), g.nn.Dense(5))
    return net


NETS = {"mlp": (_mlp, (8, 12)), "conv": (_convnet, (4, 3, 8, 8))}


@pytest.mark.parametrize("mode", ["naive", "entropy"])
@pytest.mark.parametrize("kind", sorted(NETS))
def test_quantize_net_equals_jax(kind, mode):
    build, shape = NETS[kind]
    rng = np.random.RandomState(1)
    calib = [rng.randn(*shape).astype(np.float32) for _ in range(3)]
    x = rng.randn(*shape).astype(np.float32)
    jnet, tnet = build_pair(lambda: build(jgluon), lambda: build(gluon),
                            inputs=[x])
    jq.quantize_net(jnet, calib_data=[jax_arrays([c])[0] for c in calib],
                    calib_mode=mode)
    with mx.cpu():
        tq.quantize_net(tnet, calib_data=port_arrays(calib),
                        calib_mode=mode)
    jl = [b for b in jnet._children.values()
          if isinstance(b, (jq.QuantizedDense, jq.QuantizedConv2D))]
    tl = [b for b in tnet._children.values()
          if isinstance(b, (tq.QuantizedDense, tq.QuantizedConv2D))]
    assert [type(b).__name__ for b in tl] == \
        [type(b).__name__ for b in jl]
    assert len(tl) == 3
    # the first layer sees the data: its threshold is bitwise; later ones
    # see f32 activations summed in another order
    assert tl[0]._thresh == jl[0]._thresh
    for t, j in zip(tl, jl):
        np.testing.assert_allclose(t._thresh, j._thresh, rtol=1e-5)
        assert (t._min_w, t._max_w) == (j._min_w, j._max_w)
        assert t._wq.dtype == np.int8
        np.testing.assert_array_equal(t._wq.asnumpy(), j._wq.asnumpy())
    want = jnet(jax_arrays([x])[0]).asnumpy()
    with mx.cpu():
        got = tnet(port_arrays([x])[0]).asnumpy()
    last = tl[-1]
    s_in, s_w = last._thresh / 127.0, last._max_w / 127.0
    codes = np.abs(last._wq.asnumpy().astype(np.int64))
    quantum = s_in * s_w * codes.reshape(codes.shape[0], -1).sum(1).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=quantum)
    assert np.isfinite(got).all()


def test_quantize_net_refusals_and_symbolic_tracing():
    x = np.random.RandomState(2).randn(2, 12).astype(np.float32)
    with mx.cpu():
        net = _mlp(gluon)
        net.initialize()
        net(nd.array(x))
        with pytest.raises(mx.MXNetError, match="calibration data"):
            tq.quantize_net(net)
        with pytest.raises(mx.MXNetError, match="calib_mode"):
            tq.quantize_net(net, calib_data=[nd.array(x)], calib_mode="kl")
        with pytest.raises(mx.MXNetError, match="int8"):
            tq.quantize_net(net, calib_data=[nd.array(x)],
                            quantized_dtype="uint8")
        lonely = gluon.nn.HybridSequential()
        lonely.add(gluon.nn.Activation("relu"))
        with pytest.raises(mx.MXNetError, match="no quantizable"):
            tq.quantize_net(lonely, calib_data=[nd.array(x)])
        tq.quantize_net(net, calib_data=[nd.array(x)],
                        exclude_layers=["2"])
        assert isinstance(net[0], tq.QuantizedDense)
        assert isinstance(net[2], gluon.nn.Dense)
        with pytest.raises(mx.MXNetError, match="cannot be traced "
                                                "symbolically"):
            mx.sym.trace_block(net)
