"""The port's ``amp.LossScaler.has_overflow`` against the JAX package's,
on the same numpy gradients, for the three kinds of input it takes:
``NDArray``s, gluon ``Parameter``s after a backward (one of them with
``grad_req='null'``, which has no gradient and is skipped), and
``torch.nn.Parameter``s (``SPMDTrainer``'s). Each kind is checked finite
and non-finite."""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as mx

from test_torch_gluon_trainer import JAX, PORT, _pair

_GRADS = {
    "finite": [np.arange(6, dtype=np.float32).reshape(2, 3),
               np.ones(4, np.float32)],
    "inf": [np.array([1, np.inf, 0], np.float32), np.ones(4, np.float32)],
    "nan": [np.ones((2, 2), np.float32),
            np.array([0, np.nan, 2, 3], np.float32)],
}


def _expected(arrays):
    return any(not np.isfinite(a).all() for a in arrays)


@pytest.mark.parametrize("case", sorted(_GRADS))
def test_has_overflow_ndarrays(case):
    grads = _GRADS[case]
    want = jmx.amp.LossScaler().has_overflow([jmx.nd.array(g) for g in grads])
    with mx.cpu():
        got = mx.amp.LossScaler().has_overflow(
            [mx.nd.array(g) for g in grads])
    assert got == want == _expected(grads)


def test_has_overflow_documented_example():
    with mx.cpu():
        bad = mx.nd.array([1, np.inf, 0])
    assert mx.amp.LossScaler().has_overflow([bad])
    assert not mx.amp.LossScaler().has_overflow([])


def _backward(P, net, loss_scale):
    rng = np.random.RandomState(3)
    with P.ctx():
        x = P.nd.array(rng.randn(8, 8).astype(np.float32))
        with P.ag.record():
            loss = (net(x) * loss_scale).sum()
        loss.backward()


@pytest.mark.parametrize("loss_scale", [1.0, float("inf")])
def test_has_overflow_gluon_parameters(loss_scale):
    jnet, tnet = _pair()
    for net in (jnet, tnet):
        net[0].bias.grad_req = "null"
    _backward(JAX, jnet, loss_scale)
    _backward(PORT, tnet, loss_scale)
    tparams = list(tnet.collect_params().values())
    assert any(p.grad_req == "null" for p in tparams)
    # the JAX scaler reads grad() of every parameter it is given, so it
    # gets the ones that have a gradient; the port skips the null one
    jgrads = [p for p in jnet.collect_params().values()
              if p.grad_req != "null"]
    want = jmx.amp.LossScaler().has_overflow(jgrads)
    got = mx.amp.LossScaler().has_overflow(tparams)
    assert got == want == (loss_scale == float("inf"))
    for jp, tp in zip(jgrads, [p for p in tparams if p.grad_req != "null"]):
        np.testing.assert_array_equal(np.isfinite(jp.grad().asnumpy()),
                                      np.isfinite(tp.grad().asnumpy()))


@pytest.mark.parametrize("case", sorted(_GRADS))
def test_has_overflow_torch_parameters(case):
    grads = _GRADS[case]
    params = []
    for g in grads:
        p = torch.nn.Parameter(torch.zeros(g.shape))
        p.grad = torch.from_numpy(g.copy())
        params.append(p)
    params.append(torch.nn.Parameter(torch.zeros(3)))   # no gradient yet
    want = jmx.amp.LossScaler().has_overflow(grads)
    got = mx.amp.LossScaler().has_overflow(params)
    assert got == want == _expected(grads)
