"""``nd.contrib`` of the port against the JAX package's on the CPU: the
control flow (``foreach``, ``while_loop``, ``cond``; eager in the port,
``lax`` loops outside ``record()`` in the JAX package) on the same
bodies, their outputs and final states at rtol 1e-6 and, under
``autograd.record()``, the gradients through a loop to its initial state
and to an array its body closes over; ``while_loop``'s zero-padded
(max_iterations, ...) buffer, also when no step runs; and the contrib
names: every ``_contrib_*`` op the port registers is ``nd.contrib.<X>``,
the JAX names missing being the contrib / vision ops that wait for later
items.
"""

import numpy as np
import pytest

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd as tag
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.ops import registry as treg

from test_torch_op_cases import compare, f


def _both(fn):
    """fn(nd, autograd) for each package (the port on the CPU)."""
    want = fn(jnd, jag)
    with mx.cpu():
        got = fn(nd, tag)
    return got, want


def _foreach(P, _):
    data, w = P.array(f(4, 3)), P.array(f(3, seed=2))

    def body(x, states):
        h = states[0] * 0.5 + x * w
        return [h, h.sum()], [h]

    return P.contrib.foreach(body, data, [P.zeros((3,))])


def _while(P, _):
    def cond(i, s):
        return i < 3

    def func(i, s):
        return s * 2.0, [i + 1, s + i]

    return P.contrib.while_loop(cond, func, [P.array([0.0]),
                                             P.array([1.0, 2.0])],
                                max_iterations=5)


def _while_none(P, _):
    return P.contrib.while_loop(lambda i: i > 10, lambda i: (i * 3, [i + 1]),
                                [P.array([2.0])], max_iterations=4)


def _cond(P, _):
    x = P.array(f(3))
    return [P.contrib.cond(P.array([1.0]), lambda: x * 2, lambda: x - 1),
            P.contrib.cond(P.array([0.0]), lambda: x * 2, lambda: x - 1)]


@pytest.mark.parametrize("case", [_foreach, _while, _while_none, _cond],
                         ids=["foreach", "while_loop", "while_loop_no_step",
                              "cond"])
def test_control_flow_equals_jax(case):
    got, want = _both(case)
    compare(got, want, 1e-6, "float32")


def _grads(P, ag):
    data, w = P.array(f(4, 3)), P.array(f(3, seed=2))
    h0 = P.array(f(3, seed=3))
    w.attach_grad()
    h0.attach_grad()

    def body(x, states):
        h = P.tanh(states[0] * 0.5 + x * w)
        return h, [h]

    with ag.record():
        outs, states = P.contrib.foreach(body, data, [h0])
        loss = (outs * outs).sum() + states[0].sum()
    loss.backward()
    return [outs, w.grad, h0.grad]


def test_foreach_gradients_equal_jax():
    got, want = _both(_grads)
    compare(got, want, 1e-5, "float32")


def test_contrib_namespace():
    ours = {n[len("_contrib_"):] for n in treg.list_all_names()
            if n.startswith("_contrib_")}
    theirs = {n[len("_contrib_"):] for n in jreg.list_all_names()
              if n.startswith("_contrib_")}
    assert ours <= theirs
    for n in theirs - ours:
        mod = jreg.get("_contrib_" + n).fn.__module__.rsplit(".", 1)[-1]
        assert mod in ("contrib", "vision", "quantization"), n
    for n in ours | {"foreach", "while_loop", "cond"}:
        assert callable(getattr(nd.contrib, n)), n
        assert hasattr(jnd.contrib, n), n
