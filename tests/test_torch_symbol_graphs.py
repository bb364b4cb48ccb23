"""The symbolic Executor's CUDA graphs, on the card.

A small convolutional net (Convolution, BatchNorm, relu, Pooling,
FullyConnected, SoftmaxOutput) bound by ``simple_bind`` on ``gpu(0)``,
cuDNN held deterministic for the test. Held here: a replay of the fused
train program equals its body run eagerly on the current stream from
the same state, bitwise (outputs, every gradient, the running
statistics); each signature under each key is captured once (train,
eval, and a second batch size), later calls replay; outputs handed out
do not change under a later replay; parameters written with
``copy_params_from`` (and a tensor put in ``arg_dict`` behind the
executor's back) are what the next replay reads; ``grad_req='add'``
accumulates inside the graph; Dropout draws from ``mx.random``'s CUDA
generator, registered with the graph (two replays draw different masks,
a replay from a restored generator state draws the eager body's); a
graph that reads the device from the host (``boolean_mask``) fails its
capture with ``MXNetError`` naming the op, with no eager fallback.
This file imports no JAX, so ``chip_smoke.py`` runs it with ``pytest
--noconftest -m cuda``.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.base import MXNetError

B = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = saved


def conv_net(dropout=0.0):
    data = mx.sym.Variable("data")
    x = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                           name="conv")
    x = mx.sym.BatchNorm(x, fix_gamma=False, name="bn")
    x = mx.sym.Activation(x, act_type="relu")
    x = mx.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
    if dropout:
        x = mx.sym.Dropout(x, p=dropout, name="drop")
    x = mx.sym.FullyConnected(mx.sym.flatten(x), num_hidden=5, name="fc")
    return mx.sym.SoftmaxOutput(x, mx.sym.Variable("softmax_label"),
                                normalization="batch", name="softmax")


def bound(sym, batch=B, grad_req="write", seed=0):
    exe = sym.simple_bind(mx.gpu(0), grad_req=grad_req,
                          data=(batch, 3, 8, 8), softmax_label=(batch,))
    rng = np.random.RandomState(seed)
    exe.copy_params_from(
        {n: nd.array(rng.randn(*a.shape).astype(np.float32) * 0.3,
                     ctx=mx.gpu(0))
         for n, a in exe.arg_dict.items()
         if n not in ("data", "softmax_label")},
        {"bn_moving_mean": nd.zeros((8,), ctx=mx.gpu(0)),
         "bn_moving_var": nd.ones((8,), ctx=mx.gpu(0))})
    return exe


def batch(seed, n=B):
    rng = np.random.RandomState(100 + seed)
    return (rng.rand(n, 3, 8, 8).astype(np.float32),
            rng.randint(0, 5, (n,)).astype(np.float32))


def state(exe):
    return {f"{k}:{n}": v._data.clone() for k, d in
            (("arg", exe.arg_dict), ("grad", exe.grad_dict),
             ("aux", exe.aux_dict)) for n, v in d.items()}


def restore(exe, saved):
    with torch.no_grad():
        for k, d in (("arg", exe.arg_dict), ("grad", exe.grad_dict),
                     ("aux", exe.aux_dict)):
            for n, v in d.items():
                v._data.copy_(saved[f"{k}:{n}"])


def step(exe, seed):
    x, y = batch(seed)
    exe.forward(is_train=True, data=x, softmax_label=y)
    exe.backward()
    return exe.outputs[0]._data.clone()


@pytest.mark.cuda
def test_train_replay_equals_eager_body(cuda):
    exe = bound(conv_net())
    step(exe, 0)                               # eager first call + capture
    key = ("train", tuple(exe._arg_names), True)
    prog = next(iter(exe._programs[key].values()))
    assert prog.graph is not None and prog.replays == 0
    for s in (1, 2):
        before = state(exe)
        x, y = batch(s)
        out = step(exe, s)                     # a replay
        replayed = state(exe)
        restore(exe, before)
        exe._bind_value(exe.arg_dict, "data", x)
        exe._bind_value(exe.arg_dict, "softmax_label", y)
        exe._stage_aux()
        eager = exe._body(key)[0]
        torch.cuda.synchronize()
        diff = {k: float((v - replayed[k]).abs().max())
                for k, v in state(exe).items()}
        diff["out"] = float((out - eager).abs().max())
        assert not any(diff.values()), diff
    assert prog.replays == 2
    assert exe.signature_counts() == {key: 1}


@pytest.mark.cuda
def test_one_capture_per_signature_and_outputs_are_copies(cuda):
    exe = bound(conv_net())
    outs = []
    for s in range(3):
        x, y = batch(s)
        outs.append(exe.forward(is_train=False, data=x,
                                softmax_label=y)[0])
    first = outs[0].asnumpy().copy()
    step(exe, 3)
    step(exe, 4)
    x, y = batch(5, n=4)                       # a new batch size
    exe.forward(is_train=False, data=x, softmax_label=y)
    exe.forward(is_train=False, data=x, softmax_label=y)
    counts = exe.signature_counts()
    assert counts[False] == 2 and sum(counts.values()) == 3
    for progs in exe._programs.values():
        for prog in progs.values():
            assert prog.graph is not None and prog.capture_ms > 0
    np.testing.assert_array_equal(outs[0].asnumpy(), first)
    assert not np.array_equal(outs[1].asnumpy(), first)
    # parameters written in place, or put there behind the executor's
    # back, reach the next replay
    x, y = batch(0)
    exe.copy_params_from({"fc_weight": nd.zeros((5, 128), ctx=mx.gpu(0)),
                          "fc_bias": nd.zeros((5,), ctx=mx.gpu(0))})
    flat = exe.forward(data=x, softmax_label=y)[0].asnumpy()
    np.testing.assert_allclose(flat, 0.2, rtol=1e-6)
    exe.arg_dict["fc_bias"] = nd.array([5.0, 0, 0, 0, 0], ctx=mx.gpu(0))
    peaked = exe.forward(data=x, softmax_label=y)[0].asnumpy()
    assert (peaked[:, 0] > 0.9).all()
    assert exe.signature_counts()[False] == 2


@pytest.mark.cuda
def test_grad_add_accumulates_in_the_graph(cuda):
    exe = bound(conv_net(), grad_req="add")
    once = bound(conv_net(), grad_req="write")
    for _ in range(3):
        step(exe, 0)
    step(once, 0)
    for n, g in once.grad_dict.items():
        torch.testing.assert_close(exe.grad_dict[n]._data, 3 * g._data,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_dropout_draws_from_the_registered_generator(cuda):
    exe = bound(conv_net(dropout=0.5))
    mx.random.seed(7)
    a = step(exe, 0)                           # eager + capture
    b = step(exe, 0)                           # replay: fresh masks
    assert not torch.equal(a, b)
    gen = mx.random.generator(torch.device("cuda", 0))
    saved = gen.get_state()
    c = step(exe, 0)
    gen.set_state(saved)
    d = step(exe, 0)
    assert torch.equal(c, d)
    # the training forward read before backward draws the same masks
    x, y = batch(0)
    gen.set_state(saved)
    exe.forward(is_train=True, data=x, softmax_label=y)
    e = exe.outputs[0]._data.clone()
    exe.backward()
    # (the forward alone and the fused program: the same masks, the
    # forward's kernels run with and without autograd)
    torch.testing.assert_close(e, c, rtol=1e-5, atol=1e-6)
    assert torch.equal(exe.outputs[0]._data, c)


@pytest.mark.cuda
def test_host_reading_op_fails_its_capture(cuda):
    x = mx.sym.Variable("x")
    sym = mx.sym.sum(mx.sym.boolean_mask(x, mx.sym.Variable("m"),
                                         name="bm"))
    exe = sym.simple_bind(mx.gpu(0), grad_req="null", x=(4, 3), m=(4,))
    with pytest.raises(MXNetError, match="boolean_mask"):
        exe.forward(x=np.ones((4, 3), np.float32),
                    m=np.array([1, 0, 1, 1], np.float32))
    assert exe.signature_counts().get(False, 0) == 0
