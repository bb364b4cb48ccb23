"""The port's ``mx.nd`` (NDArray over ``torch.Tensor`` and the registered
ops) against the JAX package's, on the same numpy inputs, on the CPU.

  - every op the port registers, parametrised over its name (the case
    table must cover the registry), equals the JAX ``nd.<op>`` on the same
    inputs and keywords: f32 at rtol 1e-6, except the reductions, products,
    convolutions, pooling and normalizations (rtol 1e-5: the packages sum
    in different orders)
    and the transcendental functions (rtol 2e-6: XLA's and ATen's
    polynomial approximations differ by a few ulps); the ops that take
    bf16 once more in bf16 at rtol 1e-2; the result dtypes agree;
  - the front end's errors are ``MXNetError`` (a bad dtype string, a
    shape-mismatched ``dot``, ``backward()`` outside ``record()``, an
    unregistered op), never a torch error;
  - the creation functions, the 32-bit defaults of ``nd.array``,
    indexing, in-place operators (on the array's own storage outside
    ``record()``), the scalar conversions, ``describe_op``, and the
    default device: without CUDA and without ``with mx.cpu():`` an array
    cannot be made.
"""

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, nd
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import registry as treg

from test_torch_parity import host

RS = np.random.RandomState


def f(*shape, lo=None, seed=0):
    a = RS(seed).randn(*shape).astype(np.float32)
    return np.abs(a) + lo if lo is not None else a


def ints(hi, *shape, lo=0, seed=1):
    return RS(seed).randint(lo, hi, shape).astype(np.int32)


RED, TRANS = 1e-5, 2e-6
# name: (inputs, keywords, rtol, also bf16)
CASES = {
    "AdaptiveAvgPooling2D": [(lambda: [f(2, 3, 7, 5)],
                              dict(output_size=(3, 2)), RED, True),
                             (lambda: [f(2, 3, 8, 4)],
                              dict(output_size=2), RED, False)],
    "Activation": [(lambda: [f(3, 5)], dict(act_type=a), TRANS, True)
                   for a in ("relu", "sigmoid", "tanh", "softrelu",
                             "softsign")],
    "BatchNorm": [
        (lambda: [f(4, 3, 2), f(3, seed=2), f(3, seed=3), f(3, seed=4),
                  f(3, lo=0.5, seed=5)],
         dict(fix_gamma=False, training=t), RED, False)
        for t in (True, False)],
    "BlockGrad": [(lambda: [f(2, 3)], {}, 0, True)],
    "Convolution": [
        (lambda: [f(2, 3, 9, 8), f(4, 3, 3, 3, seed=2), f(4, seed=3)],
         dict(kernel=(3, 3), stride=(2, 1), pad=(1, 1), num_filter=4), RED,
         True),
        (lambda: [f(2, 4, 7), f(4, 1, 3, seed=2)],
         dict(kernel=(3,), num_filter=4, num_group=4, no_bias=True), RED,
         False)],
    "Deconvolution": [(lambda: [f(2, 3, 5, 4), f(3, 2, 3, 3, seed=2)],
                       dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                            adj=(1, 1), num_filter=2), RED, True)],
    "L2Normalization": [(lambda: [f(3, 4, 5)], dict(mode=m), RED, False)
                        for m in ("instance", "channel", "spatial")],
    "LRN": [(lambda: [f(2, 6, 3, 3)], dict(nsize=3), RED, False)],
    "Pooling": [
        (lambda: [f(2, 3, 7, 7)],
         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type=t,
              pooling_convention=c), RED, True)
        for t in ("max", "avg", "sum") for c in ("valid", "full")] + [
        (lambda: [f(2, 3, 7, 7)],
         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
              pooling_convention="full", count_include_pad=False), RED,
         False),
        (lambda: [f(2, 3, 5, 4)], dict(global_pool=True, pool_type="avg"),
         RED, True)],
    "Cast": [(lambda: [f(2, 3) * 10], dict(dtype=d), 0, False)
             for d in ("bfloat16", "int32", "float32")],
    "Dropout": [(lambda: [f(4, 4)], dict(p=0.5), 0, True)],
    "Embedding": [(lambda: [ints(12, 3, 4, lo=-2), f(10, 6)],
                   dict(input_dim=10, output_dim=6), 0, True)],
    "FullyConnected": [
        (lambda: [f(4, 2, 3), f(5, 6, seed=2), f(5, seed=3)],
         dict(num_hidden=5), RED, True),
        (lambda: [f(4, 2, 3), f(5, 3, seed=2)],
         dict(num_hidden=5, no_bias=True, flatten=False), RED, True)],
    "GroupNorm": [(lambda: [f(2, 4, 3, 3), f(4, seed=2), f(4, seed=3)],
                   dict(num_groups=2), RED, False)],
    "InstanceNorm": [(lambda: [f(2, 3, 5), f(3, seed=2), f(3, seed=3)],
                      {}, RED, False)],
    "LayerNorm": [(lambda: [f(3, 8), f(8, seed=2), f(8, seed=3)],
                   dict(eps=1e-12), RED, True),
                  (lambda: [f(3, 4, 5), f(4, seed=2), f(4, seed=3)],
                   dict(axis=1), RED, False)],
    "LeakyReLU": [(lambda: [f(3, 4)], dict(act_type=a, slope=0.3), TRANS,
                   True) for a in ("leaky", "elu", "selu", "gelu")] + [
        (lambda: [f(2, 3, 4), f(3, seed=2)], dict(act_type="prelu"), 0,
         False)],
    "_slice_index": [(lambda: [f(4, 5)], dict(index=(slice(1, 3), 2)), 0,
                      True)],
    "abs": [(lambda: [f(3, 4)], {}, 0, True)],
    "add_n": [(lambda: [f(3, 2), f(3, 2, seed=2), f(3, 2, seed=3)], {}, 0,
               True)],
    "argmax": [(lambda: [f(4, 6)], dict(axis=1), 0, False),
               (lambda: [f(4, 6)], {}, 0, False)],
    "argmin": [(lambda: [f(4, 6)], dict(axis=0, keepdims=True), 0, False)],
    "batch_dot": [(lambda: [f(2, 3, 4), f(2, 5, 4, seed=2)],
                   dict(transpose_b=True), RED, True),
                  (lambda: [f(2, 4, 3), f(2, 4, 5, seed=2)],
                   dict(transpose_a=True), RED, False)],
    "batch_take": [(lambda: [f(2, 6, 3), ints(6, 2, 4)], {}, 0, True)],
    "broadcast_add": [(lambda: [f(3, 1, 4), f(2, 4, seed=2)], {}, 0, True)],
    "broadcast_div": [(lambda: [f(3, 4), f(1, 4, lo=0.5, seed=2)], {}, 0,
                       True)],
    "broadcast_equal": [(lambda: [ints(3, 4, 5).astype(np.float32),
                                  ints(3, 4, 5, seed=2).astype(np.float32)],
                         {}, 0, False)],
    "broadcast_greater": [(lambda: [f(3, 4), f(3, 4, seed=2)], {}, 0,
                           False)],
    "broadcast_greater_equal": [(lambda: [f(3, 4), f(1, 4, seed=2)], {}, 0,
                                 False)],
    "broadcast_hypot": [(lambda: [f(3, 4), f(3, 4, seed=2)], {}, TRANS,
                         False)],
    "broadcast_lesser": [(lambda: [f(3, 4), f(3, 4, seed=2)], {}, 0,
                          False)],
    "broadcast_lesser_equal": [(lambda: [f(3, 4), f(3, 1, seed=2)], {}, 0,
                                False)],
    "broadcast_like": [(lambda: [f(1, 4), f(3, 4, seed=2)], {}, 0, True)],
    "broadcast_logical_and": [(lambda: [ints(2, 3, 4).astype(np.float32),
                                        ints(2, 3, 4, seed=2)
                                        .astype(np.float32)], {}, 0,
                               False)],
    "broadcast_logical_or": [(lambda: [ints(2, 3, 4).astype(np.float32),
                                       ints(2, 3, 4, seed=2)
                                       .astype(np.float32)], {}, 0, False)],
    "broadcast_logical_xor": [(lambda: [ints(2, 3, 4).astype(np.float32),
                                        ints(2, 3, 4, seed=2)
                                        .astype(np.float32)], {}, 0,
                               False)],
    "broadcast_maximum": [(lambda: [f(3, 4), f(3, 4, seed=2)], {}, 0,
                           True)],
    "broadcast_minimum": [(lambda: [f(3, 4), f(3, 4, seed=2)], {}, 0,
                           True)],
    "broadcast_mod": [(lambda: [f(3, 4) * 5, f(3, 4, lo=0.5, seed=2)], {},
                       TRANS, False)],
    "broadcast_mul": [(lambda: [f(3, 4), f(4, seed=2)], {}, 0, True)],
    "broadcast_not_equal": [(lambda: [ints(3, 4, 5).astype(np.float32),
                                      ints(3, 4, 5, seed=2)
                                      .astype(np.float32)], {}, 0, False)],
    "broadcast_power": [(lambda: [f(3, 4, lo=0.1), f(3, 4, seed=2)], {},
                         TRANS, False)],
    "broadcast_sub": [(lambda: [f(3, 4), f(3, 4, seed=2)], {}, 0, True)],
    "broadcast_to": [(lambda: [f(1, 4)], dict(shape=(3, 0)), 0, True)],
    "ceil": [(lambda: [f(3, 4) * 3], {}, 0, False)],
    "clip": [(lambda: [f(3, 4)], dict(a_min=-0.5, a_max=0.7), 0, True)],
    "concat": [(lambda: [f(2, 3), f(2, 4, seed=2)], dict(dim=1), 0, True)],
    "cos": [(lambda: [f(3, 4)], {}, TRANS, False)],
    "dot": [(lambda: [f(3, 4), f(4, 5, seed=2)], {}, RED, True),
            (lambda: [f(4, 3), f(5, 4, seed=2)],
             dict(transpose_a=True, transpose_b=True), RED, False),
            (lambda: [f(2, 3, 4), f(4, 5, seed=2)], {}, RED, False)],
    "erf": [(lambda: [f(3, 4)], {}, TRANS, False)],
    "exp": [(lambda: [f(3, 4)], {}, TRANS, True)],
    "expand_dims": [(lambda: [f(3, 4)], dict(axis=1), 0, True)],
    "expm1": [(lambda: [f(3, 4)], {}, TRANS, False)],
    "flatten": [(lambda: [f(2, 3, 4)], {}, 0, True)],
    "floor": [(lambda: [f(3, 4) * 3], {}, 0, False)],
    "full_like": [(lambda: [f(3, 4)], dict(fill_value=2.5), 0, True)],
    "gelu": [(lambda: [f(3, 4)], {}, TRANS, True)],
    "identity": [(lambda: [f(3, 4)], {}, 0, True)],
    "log": [(lambda: [f(3, 4, lo=0.1)], {}, TRANS, True)],
    "log1p": [(lambda: [f(3, 4, lo=0.0)], {}, TRANS, False)],
    "log_softmax": [(lambda: [f(3, 7)], dict(axis=-1), RED, True)],
    "logsumexp": [(lambda: [f(3, 7)], dict(axis=-1), RED, True),
                  (lambda: [f(3, 7)], dict(axis=0, keepdims=True), RED,
                   False)],
    "max": [(lambda: [f(3, 4, 5)], dict(axis=(0, 2)), 0, True)],
    "mean": [(lambda: [f(3, 4, 5)], dict(axis=1, exclude=True), RED,
              False), (lambda: [f(3, 4)], {}, RED, True)],
    "min": [(lambda: [f(3, 4, 5)], dict(axis=-1, keepdims=True), 0,
             False)],
    "negative": [(lambda: [f(3, 4)], {}, 0, True)],
    "norm": [(lambda: [f(3, 4)], {}, RED, False),
             (lambda: [f(3, 4)], dict(ord=1, axis=1), RED, False),
             (lambda: [f(3, 4, 2)], dict(axis=(1, 2), keepdims=True), RED,
              False)],
    "pad": [(lambda: [f(2, 3, 4)],
             dict(pad_width=(0, 0, 1, 2, 2, 1), constant_value=0.5), 0,
             True),
            (lambda: [f(2, 3, 4, 5)],
             dict(mode="reflect", pad_width=(0, 0, 0, 0, 2, 1, 1, 3)), 0,
             False),
            (lambda: [f(2, 3, 4, 5)],
             dict(mode="edge", pad_width=(0, 0, 0, 0, 1, 1, 0, 2)), 0,
             True)],
    "one_hot": [(lambda: [ints(6, 3, 2, lo=-1)],
                 dict(depth=5, on_value=2.0, off_value=-1.0), 0, False),
                (lambda: [ints(5, 4)], dict(depth=5, dtype="int32"), 0,
                 False)],
    "ones_like": [(lambda: [f(3, 4)], {}, 0, True)],
    "pick": [(lambda: [f(4, 5), ints(7, 4, lo=-1)], dict(axis=-1), 0,
              True),
             (lambda: [f(4, 5), ints(4, 5)], dict(axis=0, keepdims=True), 0,
              False)],
    "prod": [(lambda: [f(3, 4)], dict(axis=1), RED, False)],
    "reciprocal": [(lambda: [f(3, 4, lo=0.5)], {}, 0, True)],
    "relu": [(lambda: [f(3, 4)], {}, 0, True)],
    "reshape": [(lambda: [f(2, 3, 4)], dict(shape=s), 0, True)
                for s in ((0, -1), (-3, 0), (6, -1), (-4, 1, 2, 0, 0),
                          (-2,), (4, 0, -1))] + [
        (lambda: [f(2, 3, 4)], dict(shape=(0, -1), reverse=True), 0,
         False)],
    "reshape_like": [(lambda: [f(2, 6), f(3, 4, seed=2)], {}, 0, True)],
    "round": [(lambda: [f(3, 4) * 3], {}, 0, False)],
    "rsqrt": [(lambda: [f(3, 4, lo=0.2)], {}, TRANS, False)],
    "scaled_dot_product_attention": [
        (lambda: [f(2, 5, 2, 4), f(2, 5, 2, 4, seed=2),
                  f(2, 5, 2, 4, seed=3), np.array([5, 3], np.int32)],
         dict(flash=False), RED, False)],
    "sigmoid": [(lambda: [f(3, 4)], {}, TRANS, True)],
    "sign": [(lambda: [f(3, 4)], {}, 0, True)],
    "sin": [(lambda: [f(3, 4)], {}, TRANS, False)],
    "slice": [(lambda: [f(4, 5, 3)],
               dict(begin=(1, None), end=(3, 4)), 0, True),
              (lambda: [f(6, 5)],
               dict(begin=(0, 1), end=(6, 5), step=(2, 2)), 0, False)],
    "slice_axis": [(lambda: [f(4, 5)], dict(axis=1, begin=1, end=4), 0,
                    True),
                   (lambda: [f(4, 5)], dict(axis=-2, begin=2, end=None), 0,
                    False)],
    "smooth_l1": [(lambda: [f(3, 4)], dict(scalar=2.0), 0, False)],
    "softmax": [(lambda: [f(3, 7)], {}, RED, True),
                (lambda: [f(3, 7), np.array([7, 2, 4], np.int32)],
                 dict(axis=-1, temperature=2.0), RED, False)],
    "softmax_cross_entropy": [(lambda: [f(4, 6), ints(6, 4)], {}, RED,
                               False)],
    "softsign": [(lambda: [f(3, 4)], {}, 0, False)],
    "split": [(lambda: [f(4, 6)], dict(num_outputs=3, axis=1), 0, True),
              (lambda: [f(4, 6)],
               dict(num_outputs=2, axis=0, squeeze_axis=False), 0, False)],
    "sqrt": [(lambda: [f(3, 4, lo=0.0)], {}, 0, True)],
    "square": [(lambda: [f(3, 4)], {}, 0, True)],
    "squeeze": [(lambda: [f(3, 1, 4)], dict(axis=1), 0, True)],
    "stack": [(lambda: [f(2, 3), f(2, 3, seed=2)], dict(axis=1), 0, True)],
    "sum": [(lambda: [f(3, 4, 5)], dict(axis=(0, 2)), RED, True),
            (lambda: [f(3, 4, 5)], dict(axis=1, exclude=True,
                                        keepdims=True), RED, False)],
    "swapaxes": [(lambda: [f(2, 3, 4)], dict(dim1=0, dim2=2), 0, True)],
    "take": [(lambda: [f(5, 3), ints(8, 2, 3, lo=-2)], {}, 0, True),
             (lambda: [f(5, 3), ints(8, 4, lo=-2)],
              dict(axis=1, mode="wrap"), 0, False)],
    "tanh": [(lambda: [f(3, 4)], {}, TRANS, True)],
    "transpose": [(lambda: [f(2, 3, 4)], dict(axes=(1, 2, 0)), 0, True),
                  (lambda: [f(2, 3, 4)], {}, 0, False)],
    "where": [(lambda: [ints(2, 3, 4).astype(np.float32), f(3, 4),
                        f(3, 4, seed=2)], {}, 0, True)],
    "zeros_like": [(lambda: [f(3, 4)], {}, 0, True)],
}

# ops whose first input is a list of arrays
LISTED = {"add_n", "concat", "stack"}
# (positional arrays, names of the trailing arrays passed by keyword)
BY_KEYWORD = {"softmax": (1, ("length",)),
              "scaled_dot_product_attention": (3, ("valid_length",))}
CASE_IDS = [(name, i, dt) for name in sorted(CASES)
            for i in range(len(CASES[name]))
            for dt in (("float32", "bfloat16") if CASES[name][i][3]
                       else ("float32",))]


def _arrays(pkg, inputs, dtype):
    out = []
    for a in inputs:
        if a.dtype.kind == "f" and dtype == "bfloat16":
            out.append(pkg.array(a, **_ctx(pkg), dtype="float32")
                       .astype("bfloat16"))
        else:
            out.append(pkg.array(a, **_ctx(pkg),
                                 dtype="float32" if a.dtype.kind == "f"
                                 else "int32"))
    return out


def _ctx(pkg):
    return {"ctx": mx.cpu()} if pkg is nd else {}


def _call(pkg, name, inputs, kw, dtype):
    arrays = _arrays(pkg, inputs, dtype)
    fn = getattr(pkg, name)
    if name in LISTED:
        return fn(arrays, **kw)
    npos, names = BY_KEYWORD.get(name, (len(arrays), ()))
    return fn(*arrays[:npos], **dict(zip(names, arrays[npos:])), **kw)


def _compare(got, want, rtol, dtype):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _compare(g, w, rtol, dtype)
        return
    assert got.shape == want.shape
    assert str(got.dtype) == str(want.dtype), (got.dtype, want.dtype)
    g, w = host(got), host(want)
    if dtype == "bfloat16":
        rtol = max(rtol, 1e-2)
    atol = rtol * float(np.abs(w).max(initial=0.0))
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_the_case_table_covers_the_registry():
    assert sorted(CASES) == treg.list_all_ops()
    # every port op and alias is a JAX registry name too
    assert set(treg.list_all_names()) <= set(jreg.list_all_names())


@pytest.mark.parametrize("name,i,dtype", CASE_IDS,
                         ids=[f"{n}-{i}-{d}" for n, i, d in CASE_IDS])
def test_op_equals_jax(name, i, dtype):
    make, kw, rtol, _ = CASES[name][i]
    inputs = make()
    want = _call(jnd, name, inputs, kw, dtype)
    got = _call(nd, name, inputs, kw, dtype)
    _compare(got, want, rtol, dtype)


def test_aliases_reach_the_same_op():
    x = nd.array(f(3, 4), ctx=mx.cpu())
    np.testing.assert_array_equal(nd.elemwise_add(x, x).asnumpy(),
                                  nd.broadcast_add(x, x).asnumpy())
    assert nd.Flatten is not nd.flatten and \
        treg.get("Flatten") is treg.get("flatten")
    assert "aliases: Flatten" in treg.describe_op("flatten")
    assert "signature: reshape(data, shape=None, reverse=False)" in \
        nd.reshape.__doc__


def test_errors_are_mxnet_errors():
    with mx.cpu():
        with pytest.raises(MXNetError, match="unknown dtype"):
            nd.array([1.0]).astype("float99")
        with pytest.raises(MXNetError, match="unknown dtype"):
            nd.zeros((2,), dtype="complex17")
        with pytest.raises(MXNetError, match="dot"):
            nd.dot(nd.ones((2, 3)), nd.ones((2, 3)))
        with pytest.raises(MXNetError, match="neither recorded"):
            nd.array([1.0]).backward()
        with pytest.raises(MXNetError, match="not registered"):
            nd.invoke_by_name("no_such_op", nd.ones((1,)))
        with pytest.raises(MXNetError, match="failed"):
            nd.broadcast_add(nd.ones((2, 3)), nd.ones((4, 5)))
        with pytest.raises(MXNetError, match="boolean-mask"):
            nd.ones((3,))[torch.tensor([True, False, True])]


def test_default_device_is_the_card():
    assert mx.current_context() == mx.gpu(0)
    with mx.cpu():
        assert mx.current_context() == mx.cpu(0)
        assert nd.ones((2,)).context == mx.cpu(0)
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            nd.array([1.0, 2.0])
        with pytest.raises(MXNetError, match="no CUDA device"):
            nd.zeros((2,), ctx=mx.gpu(0))


def test_creation_functions_equal_jax():
    with mx.cpu():
        pairs = [
            (nd.array([[1, 2], [3, 4]]), jnd.array([[1, 2], [3, 4]])),
            (nd.array(np.arange(6, dtype=np.float64)),
             jnd.array(np.arange(6, dtype=np.float64))),
            (nd.array(np.arange(6, dtype=np.int64)),
             jnd.array(np.arange(6, dtype=np.int64))),
            (nd.zeros((2, 3)), jnd.zeros((2, 3))),
            (nd.ones(4, dtype="int32"), jnd.ones(4, dtype="int32")),
            (nd.full((2, 2), 3.5), jnd.full((2, 2), 3.5)),
            (nd.arange(2, 11, 3, repeat=2), jnd.arange(2, 11, 3, repeat=2)),
            (nd.arange(5, dtype="int32"), jnd.arange(5, dtype="int32")),
            (nd.concatenate([nd.ones((1, 2)), nd.zeros((2, 2))]),
             jnd.concatenate([jnd.ones((1, 2)), jnd.zeros((2, 2))])),
        ]
        for got, want in pairs:
            assert got.shape == want.shape
            assert str(got.dtype) == str(want.dtype)
            np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
        assert nd.empty((2, 3)).shape == (2, 3)
        nd.waitall()


def test_ndarray_surface():
    with mx.cpu():
        a = nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
        assert (a.shape, a.size, a.ndim, len(a)) == ((3, 4), 12, 2, 3)
        assert str(a.dtype) == "float32" and a.stype == "default"
        assert a.context == mx.cpu(0) and a.ctx == a.context
        np.testing.assert_array_equal(a[1].asnumpy(), [4, 5, 6, 7])
        np.testing.assert_array_equal(a[:, 1:3].asnumpy(),
                                      [[1, 2], [5, 6], [9, 10]])
        idx = nd.array([2.0, 0.0])                  # float indices
        np.testing.assert_array_equal(a[idx].asnumpy()[:, 0], [8, 0])
        assert [r.shape for r in a] == [(4,)] * 3
        b = a.copy()
        b[0, 0] = 100.0
        b[1] = nd.array([1, 1, 1, 1])
        assert float(a[0, 0].asscalar()) == 0.0 and \
            float(b[0, 0].asscalar()) == 100.0
        assert b[1].asnumpy().tolist() == [1, 1, 1, 1]
        where = b._data.data_ptr()
        b += 1
        b *= 2
        b -= nd.ones((3, 4))
        b /= 2
        assert b._data.data_ptr() == where
        np.testing.assert_array_equal(
            b.asnumpy()[2], ((a.asnumpy()[2] + 1) * 2 - 1) / 2)
        assert float(nd.array([3.5])) == 3.5 and int(nd.array([7])) == 7
        assert bool(nd.array([1.0])) and not bool(nd.zeros((0,)))
        with pytest.raises(MXNetError, match="ambiguous"):
            bool(a)
        with pytest.raises(MXNetError, match="not a scalar"):
            a.asscalar()
        np.testing.assert_array_equal((2 - a).asnumpy(), 2 - a.asnumpy())
        np.testing.assert_array_equal((1 / (a + 1)).asnumpy(),
                                      1 / (a.asnumpy() + 1))
        np.testing.assert_array_equal((a ** 2).asnumpy(), a.asnumpy() ** 2)
        np.testing.assert_array_equal((a @ a.T).asnumpy(),
                                      a.asnumpy() @ a.asnumpy().T)
        np.testing.assert_array_equal((a > 5).asnumpy(),
                                      (a.asnumpy() > 5).astype(np.float32))
        half = nd.array([1.5]).astype("bfloat16") * 0.1
        assert str(half.dtype) == "bfloat16"
        np.testing.assert_array_equal(
            half.asnumpy().astype(np.float32),
            (jnd.array([1.5]).astype("bfloat16") * 0.1).asnumpy()
            .astype(np.float32))
        assert a.detach()._data.data_ptr() == a._data.data_ptr()
        assert a.astype("float32", copy=False) is a
        with pytest.raises(MXNetError, match="not ported"):
            a.tostype("row_sparse")
        assert "NDArray 3x4 @cpu(0)" in repr(a)


def test_nd_random_draws_from_the_device_generator():
    with mx.cpu():
        nd.random.seed(4)
        u = nd.random.uniform(-1, 1, shape=(2000,))
        n = nd.random.normal(2.0, 0.5, shape=(2000,))
        nd.random.seed(4)
        u2 = nd.random.uniform(-1, 1, shape=(2000,))
        r = nd.random.randint(0, 5, shape=(50,))
    np.testing.assert_array_equal(u.asnumpy(), u2.asnumpy())
    assert -1 <= u.asnumpy().min() and u.asnumpy().max() < 1
    assert abs(n.asnumpy().mean() - 2.0) < 0.05
    assert abs(n.asnumpy().std() - 0.5) < 0.05
    assert str(r.dtype) == "int32" and set(r.asnumpy()) <= set(range(5))


def test_dropout_training_mode_and_always():
    with mx.cpu():
        x = nd.ones((200, 50))
        assert np.array_equal(nd.Dropout(x, p=0.5).asnumpy(), x.asnumpy())
        mx.random.seed(0)
        with autograd.train_mode():
            y = nd.Dropout(x, p=0.25).asnumpy()
        z = nd.Dropout(x, p=0.25, mode="always").asnumpy()
    for out in (y, z):
        assert set(np.unique(out)) <= {0.0, np.float32(1.0 / 0.75)}
        assert abs((out == 0).mean() - 0.25) < 0.02
