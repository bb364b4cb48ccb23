"""The port's tensor ops of the registry's later part (the scalar ops,
trigonometric, hyperbolic and special functions, layout, gather /
scatter, sequence and ordering ops, the loss heads) against the JAX
package on the CPU, the registry as a whole against the JAX registry, and
the ``NDArray`` methods and ``nd`` helpers this part adds.

  - every case of the table (``tests/test_torch_op_cases.py``) at its
    stated rtol (bf16 at 1e-2), with the JAX tie order of ``topk`` and
    ``argsort`` and ``gamma``'s JAX magnitude for negative non-integers;
  - each differentiable op's gradient against ``jax.vjp`` of the JAX op
    at rtol 1e-5 (``make_loss`` and ``LinearRegressionOutput`` custom);
  - the registry is the JAX registry less exactly the 7 ops that wait
    for later items (quantization 6, rnn 1), with each op's aliases;
    every op is in exactly one class of the gradient sweep's;
  - a binary op takes a Python number as its other operand, in the
    dtype JAX's weak typing gives the pair;
  - ``NDArray.{argsort, flip, pad, repeat, sort, tile, topk}`` and
    ``nd.{eye, linspace, moveaxis, from_numpy, from_dlpack}`` equal the
    JAX package's; ``to_dlpack_for_read`` shares the array's memory (the
    JAX package's calls ``jax.dlpack.to_dlpack``, which this JAX does not
    have, so the round trip is held against JAX's ``from_dlpack`` of the
    port's tensor).
"""

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.ops import registry as treg

from test_torch_op_cases import (CASES, CUSTOM_GRAD, DISTRIBUTION, NONDIFF,
                                 TIES, case_ids, compare, f, grad_names, ids)
from torch_op_parity import gradient_equals_jax, op_equals_jax

CASE_IDS = [c for c in case_ids("tensor") if c[0] not in DISTRIBUTION]

# the JAX ops that wait for later items, by the JAX module that holds them
WAITING = {
    "quantization": {"dequantize", "quantize", "quantize_v2",
                     "quantized_conv", "quantized_fully_connected",
                     "requantize"},
    "rnn": {"RNN"},
}


@pytest.mark.parametrize("name,i,dtype", CASE_IDS, ids=ids(CASE_IDS))
def test_op_equals_jax(name, i, dtype):
    op_equals_jax(name, i, dtype)


@pytest.mark.parametrize("name", grad_names({"tensor"}))
def test_gradient_equals_jax_vjp(name):
    gradient_equals_jax(name)


def test_only_the_waiting_ops_are_missing():
    missing = set(jreg.list_all_ops()) - set(treg.list_all_ops())
    by_module = {}
    for n in missing:
        mod = jreg.get(n).fn.__module__.rsplit(".", 1)[-1]
        by_module.setdefault(mod, set()).add(n)
    assert by_module == WAITING
    assert sum(map(len, WAITING.values())) == 7
    assert set(treg.list_all_ops()) <= set(jreg.list_all_ops())
    for n in treg.list_all_ops():
        assert set(treg.get(n).aliases) == set(jreg.get(n).aliases), n


def test_registry_fully_classified():
    """Every port op in exactly one class: gradient, non-differentiable,
    custom gradient or distribution."""
    ops = set(treg.list_all_ops())
    grad = set(grad_names({"base", "tensor", "misc_nn", "random",
                           "optimizer", "linalg_attention", "contrib",
                           "vision"})) - CUSTOM_GRAD
    classes = [grad, NONDIFF, CUSTOM_GRAD, DISTRIBUTION]
    assert set().union(*classes) == ops
    assert sum(map(len, classes)) == len(ops)


@pytest.mark.parametrize("name,lhs,rhs", [
    ("maximum", f(2, 3), 0.5), ("broadcast_minimum", f(2, 3), -0.25),
    ("maximum", np.arange(6, dtype=np.int32).reshape(2, 3), 1.5),
    ("broadcast_add", np.arange(6, dtype=np.int32).reshape(2, 3), 2)])
def test_binary_ops_take_a_python_scalar(name, lhs, rhs):
    got = getattr(nd, name)(nd.array(lhs, ctx=mx.cpu(), dtype=lhs.dtype),
                            rhs)
    want = getattr(jnd, name)(jnd.array(lhs, dtype=lhs.dtype), rhs)
    compare(got, want, 0, "float32")


def _pair(a):
    return jnd.array(a), nd.array(a, ctx=mx.cpu())


@pytest.mark.parametrize("method,args", [
    ("flip", dict(axis=1)), ("tile", dict(reps=(2, 1))),
    ("repeat", dict(repeats=2, axis=0)), ("argsort", {}),
    ("argsort", dict(is_ascend=False)), ("sort", dict(is_ascend=False)),
    ("topk", dict(k=3)), ("topk", dict(k=2, ret_typ="both", axis=0)),
    ("pad", dict(mode="constant", pad_width=(0, 0, 1, 2),
                 constant_value=0.5))])
def test_ndarray_methods_equal_jax(method, args):
    j, t = _pair(TIES)
    compare(getattr(t, method)(**args), getattr(j, method)(**args), 0,
            "float32")


def test_nd_helpers_equal_jax():
    with mx.cpu():
        pairs = [(nd.eye(3, 4, 1), jnd.eye(3, 4, 1)),
                 (nd.eye(3, k=-1, dtype="int32"),
                  jnd.eye(3, k=-1, dtype="int32")),
                 (nd.linspace(-1, 2, 7), jnd.linspace(-1, 2, 7)),
                 (nd.linspace(0, 1, 4, endpoint=False),
                  jnd.linspace(0, 1, 4, endpoint=False)),
                 (nd.from_numpy(f(2, 3)), jnd.from_numpy(f(2, 3)))]
        x = f(2, 3, 4)
        pairs.append((nd.moveaxis(nd.array(x), 0, 2),
                      jnd.moveaxis(jnd.array(x), 0, 2)))
        t = nd.array(x)
        back = nd.from_dlpack(nd.to_dlpack_for_read(t))
        assert back._data.data_ptr() == t._data.data_ptr()
        pairs.append((back, jnd.from_dlpack(t._data)))
    for got, want in pairs:
        compare(got, want, 1e-7, "float32")


def test_gamma_keeps_the_jax_magnitude():
    """jnp's gamma is exp(gammaln): |Gamma(x)| for negative x."""
    x = np.array([-0.5, -1.5, 2.5], np.float32)
    with mx.cpu():
        got = nd.gamma(nd.array(x)).asnumpy()
    want = jnd.gamma(jnd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got > 0).all()


def test_boolean_mask_is_eager_and_shaped_by_the_mask():
    with mx.cpu():
        out = nd.boolean_mask(nd.array(f(5, 2)),
                              nd.array([0, 1, 1, 0, 1], dtype="int32"))
    assert out.shape == (3, 2)
    assert jmx.nd.boolean_mask(jnd.array(f(5, 2)), jnd.array(
        [0, 1, 1, 0, 1], dtype="int32")).shape == (3, 2)
