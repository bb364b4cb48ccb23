"""The port's ``mx.nd`` (NDArray over ``torch.Tensor`` and the registered
ops) against the JAX package's, on the same numpy inputs, on the CPU.

  - the case table (``tests/test_torch_op_cases.py``) covers the
    registry; every op of its first part (the ops the port registered
    first), parametrised over its name, equals the JAX ``nd.<op>`` on the
    same inputs and keywords: f32 at rtol 1e-6, except the reductions, products,
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

from test_torch_op_cases import (BASE_CASES, CASES, call, case_ids, f, ids,
                                 compare as _compare)

# the ops the port registered first; the others' JAX parity is in
# tests/test_torch_ops_*.py
CASE_IDS = case_ids("base")


def _ctx(pkg):
    return {"ctx": mx.cpu()} if pkg is nd else {}


def _call(pkg, name, inputs, kw, dtype):
    return call(pkg, name, inputs, kw, dtype, **_ctx(pkg))


def test_the_case_table_covers_the_registry():
    assert sorted(CASES) == treg.list_all_ops()
    # every port op and alias is a JAX registry name too
    assert set(treg.list_all_names()) <= set(jreg.list_all_names())


@pytest.mark.parametrize("name,i,dtype", CASE_IDS, ids=ids(CASE_IDS))
def test_op_equals_jax(name, i, dtype):
    make, kw, rtol, _ = BASE_CASES[name][i]
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
        rsp = a.tostype("row_sparse")
        jrsp = jnd.array(a.asnumpy()).tostype("row_sparse")
        assert rsp.stype == jrsp.stype == "row_sparse"
        np.testing.assert_array_equal(rsp.indices.asnumpy(),
                                      jrsp.indices.asnumpy())
        np.testing.assert_array_equal(rsp.asnumpy(), jrsp.asnumpy())
        assert a.tostype("default") is a
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
