"""The port's ``autograd`` (on ``torch.autograd``) against the JAX
package's, case for case after ``tests/test_autograd.py``.

Each scenario is one function run twice, over the JAX package's ``nd`` /
``autograd`` and over the port's (on the CPU); what it returns (gradient
buffers, values, flags) must agree: exactly for the values the JAX test
pins (small integers, recording flags), rtol 1e-6 for the rest. The
scenarios: basic, chain rule, head gradient, ``grad_req`` 'add' (and a
re-attach resetting it to 'write') and 'null', a variable used twice,
``detach`` and ``stop_gradient``, ``pause`` and the mode scopes, dropout
following ``train_mode``, ``grad`` (and ``create_graph=True`` for a
second order), a custom ``Function``, ``mark_variables``, a multi-output
op, in-place operators under ``record()``, the gradient of an
intermediate, ``retain_graph``, ``astype`` staying on the tape (the JAX
package's PR-3 regression), and the grad-ready hook firing once per leaf
with the leaf's final gradient. Plus the port's own contract: an op
outside ``record()`` builds no graph even on a variable, and
``backward()`` on it raises ``MXNetError``; the gradient buffer is
written in place (its storage never changes).
"""

import contextlib

import numpy as np
import pytest

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import nd as jnd

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd as tag
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch.base import MXNetError


class Pkg:
    def __init__(self, nd, autograd, ctx):
        self.nd, self.ag, self.ctx = nd, autograd, ctx


JAX = Pkg(jnd, jag, contextlib.nullcontext)
PORT = Pkg(tnd, tag, mx.cpu)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if hasattr(x, "asnumpy"):
        return x.asnumpy().astype(np.float64)
    return x


def basic(p):
    x = p.nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with p.ag.record():
        y = (x * x).sum()
    y.backward()
    return x.grad


def chain_rule(p):
    x = p.nd.array([[1.0, 2.0], [3.0, 4.0]])
    x.attach_grad()
    with p.ag.record():
        z = p.nd.exp(p.nd.log(x) * 2.0).sum()
    z.backward()
    return x.grad


def head_gradient(p):
    x = p.nd.array([1.0, 2.0])
    x.attach_grad()
    with p.ag.record():
        y = x * 3.0
    y.backward(p.nd.array([10.0, 100.0]))
    return x.grad


def grad_req_add(p):
    x = p.nd.array([1.0, 1.0])
    x.attach_grad(grad_req="add")
    for _ in range(3):
        with p.ag.record():
            y = (x * 2.0).sum()
        y.backward()
    added = x.grad.asnumpy().copy()
    x.attach_grad()
    with p.ag.record():
        (x * 2.0).sum().backward()
    return [added, x.grad]


def grad_req_null(p):
    x, y = p.nd.array([1.0]), p.nd.array([2.0])
    x.attach_grad()
    y.attach_grad(grad_req="null")
    with p.ag.record():
        z = (x * y).sum()
    z.backward()
    return [x.grad, y.grad]


def multiple_uses(p):
    x = p.nd.array([2.0, 3.0])
    x.attach_grad()
    with p.ag.record():
        y = (x * x + x * 4.0).sum()
    y.backward()
    return x.grad


def detach_and_stop_gradient(p):
    x = p.nd.array([2.0, 3.0])
    x.attach_grad()
    with p.ag.record():
        y = (x.detach() * x + p.nd.stop_gradient(x) * x).sum()
    y.backward()
    return x.grad


def pause_and_modes(p):
    ag = p.ag
    flags = [(ag.is_recording(), ag.is_training())]
    with ag.record():
        flags.append((ag.is_recording(), ag.is_training()))
        with ag.pause():
            flags.append((ag.is_recording(), ag.is_training()))
            with ag.train_mode():
                flags.append((ag.is_recording(), ag.is_training()))
        with ag.predict_mode():
            flags.append((ag.is_recording(), ag.is_training()))
    with ag.record(train_mode=False):
        flags.append((ag.is_recording(), ag.is_training()))
    flags.append((ag.is_recording(), ag.is_training()))
    prev = ag.set_recording(True)
    flags.append((prev, ag.is_recording()))
    ag.set_recording(False)
    return flags


def training_aware_dropout(p):
    x = p.nd.ones((50, 40))
    x.attach_grad()
    with p.ag.record(train_mode=False):
        y = p.nd.Dropout(x, p=0.5)
    y.backward()
    return [y, x.grad]


def autograd_grad(p):
    x = p.nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with p.ag.record():
        y = (x * x * x).sum()
    g = p.ag.grad(y, [x])[0]
    return [g, x.grad]


def create_graph(p):
    x = p.nd.array([1.0, 2.0])
    x.attach_grad()
    with p.ag.record():
        y = (x * x * x).sum()
        g = p.ag.grad(y, [x], create_graph=True)[0]     # 3 x^2
        s = (g * g).sum()                                # 9 x^4
    s.backward()                                        # 36 x^3
    return [g, x.grad]


def custom_function(p):
    class Sigmoid(p.ag.Function):
        def forward(self, x):
            y = 1.0 / (1.0 + p.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1.0 - y)

    x = p.nd.array([-1.0, 0.0, 2.0])
    x.attach_grad()
    with p.ag.record():
        y = Sigmoid()(x)
        z = (y * 3.0).sum()
    z.backward()
    return [y, x.grad]


def mark_variables(p):
    x = p.nd.array([1.0, 2.0])
    g = p.nd.zeros((2,))
    p.ag.mark_variables([x], [g])
    with p.ag.record():
        y = (x * 5.0).sum()
    y.backward()
    return [g, x.grad]


def multi_output(p):
    x = p.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    x.attach_grad()
    with p.ag.record():
        a, b, c = p.nd.split(x, num_outputs=3, axis=1)
        y = (a * 1.0 + b * 2.0 + c * 3.0).sum()
    y.backward()
    return x.grad


def inplace_ops(p):
    x = p.nd.array([1.0, 2.0])
    x.attach_grad()
    with p.ag.record():
        y = x * 2
        y += 1
        y *= 3
        loss = y.sum()
    loss.backward()
    return [y, x.grad]


def grad_wrt_intermediate(p):
    x = p.nd.array([1.0, 2.0])
    x.attach_grad()
    with p.ag.record():
        h = x * 3.0
        y = (h * h).sum()
    gh = p.ag.grad(y, [h])[0]
    return gh


def retain_graph(p):
    x = p.nd.array([2.0])
    x.attach_grad()
    with p.ag.record():
        y = x * x
    y.backward(retain_graph=True)
    first = x.grad.asnumpy().copy()
    y.backward()
    return [first, x.grad]


def astype_on_tape(p):
    x = p.nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with p.ag.record():
        h = x.astype("float16")
        y = ((h * h).astype("float32")).sum()
    y.backward()
    return x.grad


def grad_ready_hook(p):
    a, b, c = (p.nd.array([v, v + 1.0]) for v in (1.0, 2.0, 3.0))
    for v in (a, b, c):
        v.attach_grad()
    fired = []
    handle = p.ag.register_grad_ready_hook(
        lambda leaf, buf: fired.append(
            (id(leaf), buf.asnumpy().tolist())))
    try:
        with p.ag.record():
            y = (a * b + a * c + b).sum()
        y.backward()
    finally:
        p.ag.remove_grad_ready_hook(handle)
    ids = {id(a): "a", id(b): "b", id(c): "c"}
    return sorted((ids[i], g) for i, g in fired)


SCENARIOS = [basic, chain_rule, head_gradient, grad_req_add, grad_req_null,
             multiple_uses, detach_and_stop_gradient, pause_and_modes,
             training_aware_dropout, autograd_grad, create_graph,
             custom_function, mark_variables, multi_output, inplace_ops,
             grad_wrt_intermediate, retain_graph, astype_on_tape,
             grad_ready_hook]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_scenario_matches_jax(scenario):
    want = _np(scenario(JAX))
    with PORT.ctx():
        got = _np(scenario(PORT))
    if scenario in (pause_and_modes, grad_ready_hook):
        assert got == want
        return
    if not isinstance(want, list):
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_ops_outside_record_build_no_graph():
    with mx.cpu():
        x = tnd.array([1.0, 2.0])
        x.attach_grad()
        y = x * 2.0
        assert x._data.requires_grad and not y._data.requires_grad
        with pytest.raises(MXNetError, match="neither recorded"):
            y.backward()
        with tag.record():
            z = x * 2.0
        assert z._data.grad_fn is not None


def test_gradient_buffers_are_written_in_place():
    with mx.cpu():
        x = tnd.array([1.0, 2.0, 3.0])
        x.attach_grad()
        where = x.grad._data.data_ptr()
        for k in (1.0, 2.0):
            with tag.record():
                (x * k).sum().backward()
            assert x.grad._data.data_ptr() == where
            assert x.grad.asnumpy().tolist() == [k] * 3
            assert x._data.grad is None
        assert x.grad._fresh is True


def test_mark_variables_refuses_integer_arrays_and_bad_req():
    with mx.cpu():
        with pytest.raises(MXNetError, match="only floating"):
            tnd.array([1, 2], dtype="int32").attach_grad()
        with pytest.raises(MXNetError, match="invalid grad_req"):
            tnd.array([1.0]).attach_grad(grad_req="sometimes")
