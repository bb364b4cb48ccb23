"""The port's optimizer update ops (``ops/optimizer_ops.py``: the rules
of ``optimizer/ops.py`` registered under the JAX names) against the JAX
package on the CPU, and against the port's own ``Optimizer.update`` on
the same state.

  - every case of the table (``tests/test_torch_op_cases.py``), outputs
    in the JAX order (``mp_*``: the bf16 weight, the state, the f32
    master; ``multi_*``: each tensor's outputs in turn) at rtol 1e-6
    (``lamb_update_phase2`` and ``multi_sum_sq`` at 1e-5: norms);
  - ``nd.<op>`` with the keywords an optimizer passes equals that
    optimizer's ``update`` (SGD with and without momentum, NAG, Adam and
    AdamW with their bias-corrected lr, RMSProp plain and centered, Ftrl,
    signSGD / Signum, FTML, AdaGrad, AdaDelta, LARS through
    ``multi_sum_sq`` / ``multi_lars``, and SGD's multi-precision update
    as ``mp_sgd_mom_update``) bitwise: one copy of each rule;
  - ``out=`` writes the outputs into the given arrays, as MXNet 1.x
    scripts call ``nd.sgd_mom_update(w, g, m, ..., out=[w, m])``.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd, optimizer as topt

from test_torch_op_cases import case_ids, f, ids
from torch_op_parity import op_equals_jax

CASE_IDS = case_ids("optimizer")


@pytest.mark.parametrize("name,i,dtype", CASE_IDS, ids=ids(CASE_IDS))
def test_op_equals_jax(name, i, dtype):
    op_equals_jax(name, i, dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bias_lr(lr, b1, b2, t=1):
    return lr * (1.0 - b2 ** t) ** 0.5 / (1.0 - b1 ** t)


W, G = f(3, 4), f(3, 4, seed=2)
S1, S2, S3 = f(3, 4, seed=3) * 0.1, f(3, 4, lo=0.1, seed=4) * 0.01, \
    f(3, 4, seed=5) * 0.1
COMMON = dict(wd=0.01, rescale_grad=0.5, clip_gradient=0.8)
# (op, optimizer, its state from S1-S3, the op's state arrays, keywords,
#  (new state) from the op's outputs after the weight)
RULES = {
    "sgd": ("sgd_update", lambda: topt.SGD(learning_rate=0.1, **COMMON),
            None, [], dict(lr=0.1, **COMMON)),
    "sgd_mom": ("sgd_mom_update",
                lambda: topt.SGD(learning_rate=0.1, momentum=0.9,
                                 **COMMON),
                lambda: _t(S1), [S1], dict(lr=0.1, momentum=0.9, **COMMON)),
    "nag": ("nag_mom_update",
            lambda: topt.NAG(learning_rate=0.1, momentum=0.9, **COMMON),
            lambda: _t(S1), [S1], dict(lr=0.1, momentum=0.9, **COMMON)),
    "adam": ("adam_update", lambda: topt.Adam(learning_rate=0.01, **COMMON),
             lambda: (_t(S1), _t(S2)), [S1, S2],
             dict(lr=_bias_lr(0.01, 0.9, 0.999), **COMMON)),
    "adamw": ("adamw_update",
              lambda: topt.AdamW(learning_rate=0.01, **COMMON),
              lambda: (_t(S1), _t(S2)), [S1, S2],
              dict(lr=_bias_lr(0.01, 0.9, 0.999), **COMMON)),
    "rmsprop": ("rmsprop_update",
                lambda: topt.RMSProp(learning_rate=0.01, clip_weights=0.5,
                                     **COMMON),
                lambda: _t(S2), [S2],
                dict(lr=0.01, clip_weights=0.5, **COMMON)),
    "rmsprop_centered": ("rmspropalex_update",
                         lambda: topt.RMSProp(learning_rate=0.01,
                                              centered=True, **COMMON),
                         lambda: (_t(S2), _t(S1), _t(S3)), [S2, S1, S3],
                         dict(lr=0.01, gamma1=0.9, **COMMON)),
    "ftrl": ("ftrl_update", lambda: topt.Ftrl(**COMMON),
             lambda: (_t(S1), _t(S2)), [S1, S2], dict(lr=0.1, **COMMON)),
    "signsgd": ("signsgd_update",
                lambda: topt.Signum(momentum=0.0, **COMMON), None, [],
                dict(lr=0.01, **COMMON)),
    "signum": ("signum_update", lambda: topt.Signum(wd_lh=0.01, **COMMON),
               lambda: _t(S1), [S1],
               dict(lr=0.01, momentum=0.9, wd_lh=0.01, **COMMON)),
    "ftml": ("ftml_update", lambda: topt.FTML(learning_rate=0.01,
                                              wd=0.01, rescale_grad=0.5),
             lambda: (_t(S1), _t(S2), _t(S3)), [S1, S2, S3],
             dict(lr=0.01, t=1, wd=0.01, rescale_grad=0.5)),
    "adagrad": ("adagrad_update",
                lambda: topt.AdaGrad(learning_rate=0.1, **COMMON),
                lambda: _t(S2), [S2], dict(lr=0.1, epsilon=1e-7, **COMMON)),
    "adadelta": ("adadelta_update", lambda: topt.AdaDelta(**COMMON),
                 lambda: (_t(S2), _t(S3)), [S2, S3], dict(**COMMON)),
}


def _flat(state):
    if state is None:
        return []
    return list(state) if isinstance(state, tuple) else [state]


@pytest.mark.parametrize("rule", sorted(RULES))
def test_op_equals_the_optimizers_update(rule):
    op, make_opt, make_state, states, kw = RULES[rule]
    new_w, new_state = make_opt().update(
        0, _t(W), _t(G), make_state() if make_state else None)
    with mx.cpu():
        out = getattr(nd, op)(nd.array(W), nd.array(G),
                              *[nd.array(s) for s in states], **kw)
    outs = out if isinstance(out, list) else [out]
    want = [new_w] + _flat(new_state)
    assert len(outs) == len(want)
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o.asnumpy(), w.numpy())


def test_lars_equals_multi_sum_sq_and_multi_lars():
    opt = topt.LARS(learning_rate=0.1, momentum=0.9, eta=0.01, **COMMON)
    new_w, new_m = opt.update(0, _t(W), _t(G), _t(S1))
    with mx.cpu():
        w, g = nd.array(W), nd.array(G)
        ssq = nd.multi_sum_sq(w, g, num_arrays=2)
        lr = nd.multi_lars(nd.array([0.1]), ssq[0:1], ssq[1:2],
                           nd.array([0.01]), eta=0.01, eps=1e-8,
                           rescale_grad=0.5)
        out = nd.sgd_mom_update(w, g, nd.array(S1), lr=lr[0], momentum=0.9,
                                **COMMON)
    np.testing.assert_allclose(out[0].asnumpy(), new_w.numpy(), rtol=1e-6)
    np.testing.assert_allclose(out[1].asnumpy(), new_m.numpy(), rtol=1e-6)


def test_mp_sgd_mom_update_equals_multi_precision_sgd():
    opt = topt.SGD(learning_rate=0.1, momentum=0.9, multi_precision=True,
                   **COMMON)
    w16 = _t(W).to(torch.bfloat16)
    state = opt.create_state_multi_precision(0, w16)
    new_w, (master, mom) = opt.update_multi_precision(
        0, w16, _t(G).to(torch.bfloat16), state)
    with mx.cpu():
        out = nd.mp_sgd_mom_update(
            nd.array(W).astype("bfloat16"), nd.array(G).astype("bfloat16"),
            nd.zeros((3, 4)), nd.array(w16.float()), lr=0.1, momentum=0.9,
            **COMMON)
    for o, w in zip(out, (new_w, mom, master)):
        assert str(o.dtype) == str(w.dtype).replace("torch.", "")
        np.testing.assert_array_equal(o.asnumpy().astype(np.float32),
                                      w.float().numpy())


def test_out_writes_in_place():
    with mx.cpu():
        w, g, m = nd.array(W), nd.array(G), nd.zeros((3, 4))
        ptr = w._data.data_ptr()
        want = nd.sgd_mom_update(w, g, m, lr=0.1, momentum=0.9)
        nd.sgd_mom_update(w, g, m, lr=0.1, momentum=0.9, out=[w, m])
    assert w._data.data_ptr() == ptr
    np.testing.assert_array_equal(w.asnumpy(), want[0].asnumpy())
    np.testing.assert_array_equal(m.asnumpy(), want[1].asnumpy())
