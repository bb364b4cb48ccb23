"""The port's samplers (``ops/random_ops.py``, ``shuffle``, ``nd.random``)
on the CPU. Philox and threefry streams never match, so the samples are
held by distribution, not by value:

  - each sampler's draws (20000 a case, a row for each parameter of a
    ``sample_*`` op) have the analytic mean within 5 standard errors and
    the variance within the gradient sweep's margin
    (``tests/test_op_gradient_sweep.py`` ``DIST_CHECK``); ``shuffle``
    returns a permutation of the rows;
  - one ``mx.random.seed`` replays every sampler bitwise;
  - ``nd.random`` has the JAX package's names, and every sampler's
    output shape and dtype equal the JAX op's (traced, not drawn); a sampler without array inputs draws on ``ctx`` (the current
    context by default: without CUDA and without ``with mx.cpu():`` it
    raises).
"""

import numpy as np
import pytest

import jax

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.base import MXNetError

from test_torch_op_cases import (CASES, DISTRIBUTION, call, check_sampler,
                                 host)

SAMPLERS = sorted(DISTRIBUTION - {"Dropout"})


@pytest.mark.parametrize("name", SAMPLERS)
def test_sampler_moments_and_seeded_replay(name):
    make, kw, _, _ = CASES[name][0]
    inputs = make()
    with mx.cpu():
        mx.random.seed(1234)
        out = call(nd, name, inputs, kw, "float32")
        check_sampler(name, out, inputs, kw)
        mx.random.seed(1234)
        again = call(nd, name, inputs, kw, "float32")
    np.testing.assert_array_equal(host(again), host(out))


_SMALL = {"uniform": dict(low=0.0, high=2.0, shape=(2, 3)),
          "normal": dict(shape=(2, 3)), "gamma": dict(alpha=2.0, shape=(3,)),
          "exponential": dict(lam=2.0, shape=(3,)),
          "poisson": dict(lam=2.0, shape=(3,)),
          "randint": dict(low=0, high=4, shape=(3,)),
          "bernoulli": dict(p=0.5, shape=(3,)),
          "laplace": dict(shape=(2, 2)), "negative_binomial": dict(
              k=2, p=0.5, shape=(3,)),
          "generalized_negative_binomial": dict(shape=(3,))}


def _jax_shape(name, kw):
    """The JAX sampler's output (shape, dtype), by tracing (no draw)."""
    fn = jreg.get(_TARGET[name]).fn
    out = jax.eval_shape(lambda key: fn(key=key, **kw),
                         jax.random.PRNGKey(0))
    return tuple(out.shape), str(out.dtype)


_TARGET = {n: t for n, t in [
    ("uniform", "random_uniform"), ("normal", "random_normal"),
    ("gamma", "random_gamma"), ("exponential", "random_exponential"),
    ("poisson", "random_poisson"), ("randint", "random_randint"),
    ("bernoulli", "random_bernoulli"), ("laplace", "random_laplace"),
    ("negative_binomial", "random_negative_binomial"),
    ("generalized_negative_binomial",
     "random_generalized_negative_binomial")]}


def test_nd_random_namespace_equals_jax():
    names = sorted(n for n in vars(nd.random) if not n.startswith("_"))
    assert names == sorted(n for n in vars(jnd.random)
                           if not n.startswith("_"))
    assert callable(nd.random.seed) and callable(jnd.random.seed)
    for name, kw in _SMALL.items():
        with mx.cpu():
            got = getattr(nd.random, name)(**kw)
        assert (got.shape, str(got.dtype)) == _jax_shape(name, kw), name
        assert got.context == mx.cpu(0)
    with mx.cpu():
        m = nd.random.multinomial(nd.array([[0.5, 0.5]]), shape=(4,))
        s = nd.random.shuffle(nd.arange(6))
        r = nd.random.randn(2, 3)
    assert m.shape == (1, 4) and str(m.dtype) == "int32"
    assert sorted(s.asnumpy().tolist()) == list(range(6))
    assert r.shape == (2, 3)


def test_a_sampler_without_inputs_draws_on_the_context():
    jmx.random.seed(0)
    with mx.cpu():
        a = nd.random_normal(shape=(4,))
    assert a.context == mx.cpu(0)
    b = nd.random.uniform(shape=(4,), ctx=mx.cpu())
    assert b.context == mx.cpu(0)
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            nd.random.uniform(shape=(4,))
