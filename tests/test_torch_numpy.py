"""``mx.np`` / ``mx.numpy`` / ``mx.npx`` of the port against the JAX
package's, on the CPU.

Every name of ``mx.np``'s docstring list runs on the same numpy inputs
(``RandomState(0)``) in both packages: float results within rtol 1e-5 /
atol 1e-6 (float32 transcendental functions differ in the last ulps
between XLA and torch), integer and boolean results equal, the same
shape and the same dtype (bool, uint8 and int32 inputs too: jax.numpy's
weakly typed Python scalars, 32-bit integer results, uint32 sums of
uint8; the values of an integer division by zero, from
``tests/test_torch_numpy_division.py``). ``mx.np.random``'s draws have
the JAX draws' shapes and dtypes (the streams differ by design: two
packages, two generators).
A name off the list raises ``MXNetError`` naming it; ``autograd.record``
sees ``mx.np`` calls; ``mx.npx`` forwards to ``mx.nd`` as the JAX one
does.
"""

import re

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, nd
from incubator_mxnet_tpu_torch import numpy_shim
from incubator_mxnet_tpu_torch.base import MXNetError

from test_torch_numpy_division import DIVISION_CASES

_R = np.random.RandomState(0)
A = _R.randn(3, 4).astype(np.float32)
B = _R.randn(3, 4).astype(np.float32)
P = (np.abs(_R.randn(3, 4)) + 0.5).astype(np.float32)       # positive
U = _R.uniform(-0.9, 0.9, (3, 4)).astype(np.float32)        # in (-1, 1)
G = (np.abs(_R.randn(3, 4)) + 1.1).astype(np.float32)       # > 1
I = _R.randint(-5, 6, (3, 4)).astype(np.int32)
J = (_R.randint(1, 4, (3, 4))).astype(np.int32)
M = _R.randn(4, 5).astype(np.float32)
S = _R.randn(4, 4).astype(np.float32)
V = _R.randn(4).astype(np.float32)
H = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 2.4], np.float32)  # ties
L = _R.rand(3, 4) > 0.5
T3 = _R.randn(2, 3, 4).astype(np.float32)
W3 = _R.randn(4, 2).astype(np.float32)
IDX = np.array([[0, 2], [1, 0]], np.int32)


class Arr:
    """An input array, built in each package's own NDArray."""

    def __init__(self, a):
        self.a = a


def _unary(x):
    return lambda: ((Arr(x),), {})


def _binary(x, y):
    return lambda: ((Arr(x), Arr(y)), {})


def _call(*args, **kw):
    return lambda: (args, kw)


CASES = {}
for _n in ("abs absolute negative positive exp expm1 exp2 sin cos tan "
           "arctan sinh cosh tanh arcsinh sign floor ceil trunc rint fix "
           "round around isnan isinf isfinite signbit deg2rad rad2deg "
           "degrees radians square cbrt").split():
    CASES[_n] = _unary(A * 2)
for _n in "log log1p log2 log10 sqrt reciprocal".split():
    CASES[_n] = _unary(P)
for _n in "arcsin arccos arctanh".split():
    CASES[_n] = _unary(U)
CASES["arccosh"] = _unary(G)
CASES["logical_not"] = _unary(L)
CASES["rint"] = _unary(H)
CASES["round"] = _unary(H)
for _n in ("add subtract multiply divide true_divide maximum minimum fmax "
           "fmin arctan2 hypot copysign logaddexp equal not_equal greater "
           "greater_equal less less_equal").split():
    CASES[_n] = _binary(A, B)
CASES["power"] = _binary(P, B)
CASES["float_power"] = _binary(P, B)
for _n in "floor_divide remainder mod fmod".split():
    CASES[_n] = _binary(I, J)
for _n in "logical_and logical_or logical_xor".split():
    CASES[_n] = _binary(L, ~L)
CASES["add_scalar"] = ("add", _call(Arr(A), 2.5))
CASES["multiply_int_scalar"] = ("multiply", _call(Arr(I), 3))
for _n in "sum prod mean max min amax amin argmax argmin all any".split():
    CASES[_n] = _call(Arr(L if _n in ("all", "any") else A), axis=1)
    CASES[_n + "_all"] = (_n, _unary(L if _n in ("all", "any") else A))
CASES["sum_keepdims"] = ("sum", _call(Arr(A), axis=0, keepdims=True))
CASES["mean_int"] = ("mean", _call(Arr(I), axis=0))
CASES["std"] = _call(Arr(A), axis=0)
CASES["var"] = _call(Arr(A), axis=1, ddof=1)
CASES["cumsum"] = _call(Arr(A), axis=1)
CASES["cumprod"] = _call(Arr(P), axis=0)
CASES["count_nonzero"] = _call(Arr(I), axis=1)
CASES["ptp"] = _call(Arr(A), axis=1)
CASES["reshape"] = _call(Arr(A), (4, 3))
CASES["transpose"] = _call(Arr(T3), (2, 0, 1))
CASES["transpose_default"] = ("transpose", _unary(T3))
CASES["swapaxes"] = _call(Arr(T3), 0, 2)
CASES["moveaxis"] = _call(Arr(T3), 0, -1)
CASES["expand_dims"] = _call(Arr(A), 1)
CASES["squeeze"] = _call(Arr(A.reshape(3, 1, 4)), 1)
CASES["ravel"] = _unary(A)
CASES["flip"] = _call(Arr(A), 1)
CASES["fliplr"] = _unary(A)
CASES["flipud"] = _unary(A)
CASES["roll"] = _call(Arr(A), 2, 1)
CASES["tile"] = _call(Arr(A), (2, 1))
CASES["repeat"] = _call(Arr(A), 2, 1)
CASES["broadcast_to"] = _call(Arr(V), (3, 4))
CASES["concatenate"] = _call([Arr(A), Arr(B)], 1)
CASES["stack"] = _call([Arr(A), Arr(B)], 0)
CASES["vstack"] = _call([Arr(A), Arr(B)])
CASES["hstack"] = _call([Arr(A), Arr(B)])
CASES["split"] = _call(Arr(M), 2)
CASES["array_split"] = _call(Arr(M), 3, 1)
CASES["where"] = _call(Arr(L), Arr(A), Arr(B))
CASES["where_float_condition"] = ("where", _call(Arr((A > 0).astype(
    np.float32)), Arr(A), Arr(B)))       # MXNet's comparisons give 0 / 1
CASES["clip"] = _call(Arr(A), -0.5, 0.5)
CASES["sort"] = _call(Arr(A), 1)
CASES["argsort"] = _call(Arr(A), 1)
CASES["diag"] = _unary(S)
CASES["diagonal"] = _call(Arr(S), 1)
CASES["tril"] = _unary(S)
CASES["triu"] = _call(Arr(S), 1)
CASES["trace"] = _unary(S)
CASES["take"] = _call(Arr(A), Arr(IDX), 1)
CASES["dot"] = _binary(A, M)
CASES["dot_nd"] = ("dot", _binary(T3, W3))
CASES["matmul"] = _binary(A, M)
CASES["inner"] = _binary(A, B)
CASES["outer"] = _binary(V, V)
CASES["tensordot"] = _call(Arr(T3), Arr(M), 1)
CASES["einsum"] = _call("ij,jk->ik", Arr(A), Arr(M))
CASES["kron"] = _binary(A[:2, :2], B[:2, :2])
CASES["isclose"] = _binary(A, A + 1e-7)
CASES["arange"] = _call(2, 11, 3)
CASES["arange_float"] = ("arange", _call(0.0, 1.0, 0.25))
CASES["linspace"] = _call(0.0, 1.0, 7)
CASES["zeros"] = _call((2, 3))
CASES["ones"] = _call((2, 3))
CASES["full"] = _call((2, 3), 7)
CASES["eye"] = _call(3, 4, 1)
CASES["identity"] = _call(3)
CASES["zeros_like"] = _unary(A)
CASES["ones_like"] = _unary(I)
CASES["full_like"] = _call(Arr(A), 2.5)
CASES["empty_like"] = _unary(A)        # zeros in both packages
CASES["array"] = _call([[1.0, 2.0], [3.0, 4.0]])
CASES["asarray"] = _call([[1.0, 2.0]])

# bool, uint8 and int32 inputs, held to jax.numpy's exact result dtypes:
# weakly typed Python scalars beside bool arrays, 32-bit integer
# reductions and indices, uint32 sums of uint8, bool arithmetic
U8 = _R.randint(0, 9, (3, 4)).astype(np.uint8)
LS = _R.rand(4, 4) > 0.5                                     # square bools
ONES_L = np.ones((3, 4), bool)                               # no 0 divisor
for _n in "abs absolute positive floor ceil trunc fix cbrt rint square".split():
    CASES[_n + "_bool"] = (_n, _unary(L))
for _n in "rint round around".split():
    CASES[_n + "_int32"] = (_n, _unary(I))
    CASES[_n + "_uint8"] = (_n, _unary(U8))
for _n in ("add multiply divide equal not_equal greater_equal less "
           "arctan2 maximum minimum fmax fmin subtract").split():
    CASES[_n + "_bool_int"] = (_n, _call(Arr(L), 2))
for _n in "hypot logaddexp".split():
    CASES[_n + "_int32"] = (_n, _binary(I, J))
    CASES[_n + "_bool_int"] = (_n, _call(Arr(L), 2))
    CASES[_n + "_uint8"] = (_n, _binary(U8, U8))
for _n in "power floor_divide remainder mod fmod".split():
    CASES[_n + "_bool"] = (_n, _binary(L, ONES_L))
# integer and bool divisors holding zeros (jax.numpy's values there):
# int8, int32, int64 (int32 in both packages), uint8, bool, int32 by bool
for _c, (_n, _x, _y) in DIVISION_CASES.items():
    CASES[_c] = (_n, _binary(_x, _y))
for _n in "dot matmul inner".split():
    CASES[_n + "_bool"] = (_n, _binary(LS, LS))
CASES["tensordot_bool"] = ("tensordot", _call(Arr(LS), Arr(LS), 1))
CASES["einsum_bool"] = ("einsum", _call("ij,jk->ik", Arr(LS), Arr(LS)))
CASES["where_bool_int"] = ("where", _call(Arr(L), Arr(L), 0))
CASES["where_one_arg_int32"] = ("where", _unary(I))
for _n, _x in (("bool", L), ("uint8", U8), ("int32", I)):
    for _r in "sum prod cumsum cumprod argmax argmin".split():
        CASES[f"{_r}_{_n}"] = (_r, _call(Arr(_x), axis=1))
        CASES[f"{_r}_{_n}_all"] = (_r, _unary(_x))
    CASES[f"argsort_{_n}"] = ("argsort", _call(Arr(_x), axis=1))
    CASES[f"count_nonzero_{_n}"] = ("count_nonzero", _unary(_x))
    CASES[f"all_{_n}"] = ("all", _call(Arr(_x), axis=0))
    CASES[f"any_{_n}"] = ("any", _unary(_x))
    CASES[f"sum_{_n}_dtype"] = ("sum", _call(Arr(_x), dtype="float32"))
    CASES[f"mean_{_n}_dtype"] = ("mean", _call(Arr(_x), axis=0,
                                               dtype="float32"))
    CASES[f"prod_{_n}_dtype"] = ("prod", _call(Arr(_x), axis=1,
                                               dtype="int32"))
CASES["trace_int32"] = ("trace", _unary(I[:, :3]))
CASES["trace_bool"] = ("trace", _unary(LS))
CASES["trace_uint8"] = ("trace", _unary(U8[:, :3]))
CASES["diag_k"] = ("diag", _call(Arr(V), k=1))
CASES["diag_k_matrix"] = ("diag", _call(Arr(S), k=-1))
CASES["full_bool"] = ("full", _call((2, 3), True))

HOST_CASES = {
    "shape": _unary(A), "ndim": _unary(T3), "size": _unary(T3),
    "result_type": _call(Arr(I), 1.0),
    "promote_types": _call("int32", "float32"),
    "can_cast": _call("int32", "float32"),
    "issubdtype": _call("float32", np.floating),
    "isscalar": _call(3.0), "iterable": _call([1, 2]),
    "broadcast_shapes": _call((3, 1), (1, 4)),
}


def _listed_names():
    """The names of the module docstring's list."""
    doc = numpy_shim.__doc__
    body = doc[doc.index("Supported names:"):doc.index("constants and")]
    return set(re.findall(r"[a-z_0-9]+", " ".join(
        re.findall(r"``([^`]*)``", body))))


def _build(pkg, args, kw):
    def conv(v):
        if isinstance(v, Arr):
            return pkg.np.array(v.a) if pkg is jmx else \
                mx.np.array(v.a, ctx=mx.cpu())
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v
    return [conv(a) for a in args], {k: conv(v) for k, v in kw.items()}


def _host(v):
    if isinstance(v, (list, tuple)) and v and hasattr(v[0], "asnumpy"):
        return [np.asarray(x.asnumpy()) for x in v]
    return np.asarray(v.asnumpy()) if hasattr(v, "asnumpy") else v


def _compare(name, got, want):
    if isinstance(want, list):
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            _compare(name, g, w)
        return
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_the_case_table_covers_the_docstring():
    names = {(v[0] if isinstance(v, tuple) else k)
             for k, v in CASES.items()} | set(HOST_CASES)
    assert _listed_names() == names, sorted(_listed_names() ^ names)
    assert set(numpy_shim.SUPPORTED) == names


@pytest.mark.parametrize("case", sorted(CASES))
def test_name_matches_jax(case):
    entry = CASES[case]
    name, make = entry if isinstance(entry, tuple) else (case, entry)
    args, kw = make()
    with mx.cpu():
        pa, pk = _build(mx, args, kw)
        got = _host(getattr(mx.np, name)(*pa, **pk))
    ja, jk = _build(jmx, args, kw)
    want = _host(getattr(jmx.np, name)(*ja, **jk))
    _compare(name, got, want)


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_values_match_jax(name):
    args, kw = HOST_CASES[name]()
    with mx.cpu():
        pa, pk = _build(mx, args, kw)
        got = getattr(mx.np, name)(*pa, **pk)
    ja, jk = _build(jmx, args, kw)
    want = getattr(jmx.np, name)(*ja, **jk)
    assert not hasattr(got, "asnumpy")
    if name in ("result_type", "promote_types"):
        assert np.dtype(got) == np.dtype(want), (got, want)
    else:
        assert got == want, (got, want)


def test_constants_and_names():
    for name in ("pi", "e", "inf", "newaxis", "float32", "int32",
                 "bool_", "bfloat16"):
        assert getattr(mx.np, name) == getattr(jmx.np, name)
    assert np.isnan(mx.np.nan)
    assert mx.np.ndarray is nd.NDArray
    assert mx.numpy is mx.np
    for name in ("median", "percentile", "unique", "fft"):
        with pytest.raises(MXNetError, match=f"mx.np.{name} is not"):
            getattr(mx.np, name)
    with pytest.raises(AttributeError):
        getattr(mx.np, "__wrapped__")


def test_autograd_records_np_calls():
    with mx.cpu():
        x = mx.np.array([[1., 2.], [3., 4.]])
        x.attach_grad()
        with autograd.record():
            z = mx.np.sum(mx.np.square(x))
        z.backward()
        np.testing.assert_allclose(x.grad.asnumpy(), 2 * x.asnumpy())
        assert mx.np.arange(5).context == mx.cpu()


def test_asnumpy_is_a_copy():
    """MXNet's ``asnumpy`` copies: a later in-place write to the array
    (a kvstore pull, an update) leaves an earlier host copy as it was."""
    with mx.cpu():
        for dtype in ("float32", "bfloat16"):
            x = nd.zeros((4,), dtype=dtype)
            host = x.asnumpy()
            x[:] = 3.0
            assert (host.astype(np.float32) == 0).all(), dtype
            assert (x.asnumpy().astype(np.float32) == 3).all()


def test_np_random_shapes_and_dtypes_match_jax():
    draws = {
        "rand": lambda r: r.rand(3, 4),
        "randn": lambda r: r.randn(2, 5),
        "uniform": lambda r: r.uniform(2.0, 4.0, size=(4000,)),
        "normal": lambda r: r.normal(1.0, 2.0, size=(3,)),
        "randint": lambda r: r.randint(3, 9, size=(5,)),
        "gamma": lambda r: r.gamma(2.0, 1.0, size=(4,)),
        "exponential": lambda r: r.exponential(2.0, size=(4,)),
        "laplace": lambda r: r.laplace(0.0, 1.0, size=(4,)),
        "beta": lambda r: r.beta(2.0, 5.0, size=(4000,)),
        "choice": lambda r: r.choice(5, size=(3,)),
        "choice_p": lambda r: r.choice(5, size=(4,), replace=False,
                                       p=[0.92, 0.02, 0.02, 0.02, 0.02]),
        "permutation": lambda r: r.permutation(6),
    }
    mx.random.seed(0)
    jmx.random.seed(0)
    with mx.cpu():
        for name, draw in draws.items():
            got, want = draw(mx.np.random).asnumpy(), \
                draw(jmx.np.random).asnumpy()
            assert got.shape == want.shape, name
            assert got.dtype.kind == want.dtype.kind, (name, got.dtype,
                                                       want.dtype)
        r = mx.np.random
        u = r.uniform(2.0, 4.0, size=(4000,)).asnumpy()
        assert 2.9 < u.mean() < 3.1 and u.min() >= 2.0
        b = r.beta(2.0, 5.0, size=(4000,)).asnumpy()
        assert 0.24 < b.mean() < 0.33 and 0.0 <= b.min() <= b.max() <= 1.0
        assert sorted(r.permutation(6).asnumpy().tolist()) == list(range(6))
        cs = r.choice(mx.np.array([10.0, 20.0, 30.0, 40.0]), size=(3,),
                      replace=False).asnumpy()
        assert len(set(cs.tolist())) == 3
        x = mx.np.array([0.0, 1.0, 2.0, 3.0, 4.0, 5.0])
        ptr = x._data.data_ptr()
        assert r.shuffle(x) is None
        assert sorted(x.asnumpy().tolist()) == [0, 1, 2, 3, 4, 5]
        assert x._data.data_ptr() == ptr              # in place
        with pytest.raises(MXNetError):
            r.choice(10, size=(3,), p=[0.5, 0.5])
        with pytest.raises(MXNetError):
            r.choice(3, size=(5,), replace=False)
        r.seed(7)
        a1 = r.rand(4).asnumpy()
        r.seed(7)
        assert (r.rand(4).asnumpy() == a1).all()


def test_npx_forwards_like_jax():
    x = np.array([[-1.0, 2.0]], np.float32)
    with mx.cpu():
        a = nd.array(x)
        for name, args in (("relu", ()), ("softmax", ()),
                           ("leaky_relu", ()), ("sigmoid", ())):
            got = getattr(mx.npx, name)(a, *args).asnumpy()
            want = getattr(jmx.npx, name)(jmx.nd.array(x), *args).asnumpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
        for name in ("batch_norm", "roi_align", "l2_normalization",
                     "fully_connected", "convolution"):
            assert callable(getattr(mx.npx, name)), name
        mx.npx.waitall()
        for name in mx.npx.__all__:
            assert hasattr(mx.npx, name) and hasattr(jmx.npx, name), name
        assert mx.npx.cpu() == mx.cpu()
        with pytest.raises(AttributeError):
            mx.npx.no_such_operator
        assert mx.npx.is_np_array() is False
        with mx.npx.np_array(True):
            assert mx.npx.is_np_array()
