"""The port's fused ``RNN`` op, ``gluon.rnn`` (layers and cells) and a
word-level LSTM language model against the JAX package on the CPU.

  - the ``RNN`` op in each mode (lstm, gru, rnn_tanh, rnn_relu), 2
    layers, both directions, ``state_outputs``: the output and
    final states, and ``jax.vjp``'s gradients of data, flat parameters and
    states, at rtol 1e-5 with an atol of 1e-6 of the largest |entry|
    (both run f32; they differ by summation order, ~3e-7);
  - the case table's ``RNN`` cases and gradient (``test_torch_op_cases``);
    ``mx.sym.RNN``'s output count (3 for an LSTM with ``state_outputs``,
    2 for the others, 1 without); the refusals;
  - inter-layer dropout by its properties (JAX's threefry and torch's
    Philox never draw alike): the rate within 5 standard errors, the kept
    entries scaled by exactly 1 / (1 - p), no dropout after the last
    layer or outside training, the masks repeated by ``mx.random.seed``;
  - ``gluon.rnn.RNN`` / ``LSTM`` / ``GRU`` in TNC and NTC, one and two
    directions, with and without states: parameter names (in order) equal
    the JAX layer's, outputs, states and every gradient at rtol 1e-5;
  - the cells' ``unroll`` (``RNNCell``, ``LSTMCell``, ``GRUCell``,
    ``SequentialRNNCell``, ``BidirectionalCell``, ``ResidualCell``,
    ``DropoutCell`` at rate 0, ``ZoneoutCell`` outside training), with
    ``valid_length`` as the JAX tests hold it;
  - MXNet 1.x's word language model (``example/gluon/word_language_model``:
    embedding, ``rnn.LSTM`` with a dropout between layers, the decoder
    tied to the embedding by ``params=``) at V=50, 2 layers of 16, five
    windows of the example's loop (hidden state carried and detached,
    ``clip_global_norm``, SGD lr 20) with dropout off: the same parameter
    names, the losses at rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, nd
from incubator_mxnet_tpu_torch.ops import registry as treg
from incubator_mxnet_tpu_torch.ops.rnn import rnn_param_size

from test_torch_op_cases import case_ids, grad_names, ids, rnn_inputs
from test_torch_parity import (assert_close, build_pair, fresh_names,
                               jax_arrays, port_arrays)
from torch_op_parity import gradient_equals_jax, op_equals_jax

import jax
import jax.numpy as jnp

CASE_IDS = case_ids("rnn")
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")


@pytest.mark.parametrize("name,i,dtype", CASE_IDS, ids=ids(CASE_IDS))
def test_op_case_equals_jax(name, i, dtype):
    op_equals_jax(name, i, dtype)


@pytest.mark.parametrize("name", grad_names({"rnn"}))
def test_op_gradient_equals_jax_vjp(name):
    gradient_equals_jax(name)


@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_and_gradients_equal_jax(mode):
    """Two layers, both directions (the case table's forward cases hold
    one direction)."""
    inputs = rnn_inputs(mode, layers=2, bidirectional=True, T=6, B=3, I=5,
                        H=7, seed=4)
    kw = dict(state_size=7, num_layers=2, mode=mode, bidirectional=True,
              state_outputs=True)
    rng = np.random.RandomState(9)
    n_out = 3 if mode == "lstm" else 2
    cts = [rng.randn(6, 3, 14).astype(np.float32)] + \
        [rng.randn(4, 3, 7).astype(np.float32) for _ in range(n_out - 1)]

    @jax.jit
    def forward_and_vjp(xs, cs):          # one compiled program
        outs, vjp = jax.vjp(lambda *a: jreg.get("RNN").fn(*a, **kw), *xs)
        return outs, vjp(tuple(cs))

    outs, jgrads = forward_and_vjp([jnp.asarray(a) for a in inputs],
                                   [jnp.asarray(c) for c in cts])
    assert len(outs) == n_out
    tx = [torch.from_numpy(a).requires_grad_() for a in inputs]
    touts = treg.get("RNN").fn(*tx, **kw)
    tgrads = torch.autograd.grad(touts, tx,
                                 [torch.from_numpy(c) for c in cts])
    assert_close(touts, outs, rtol=1e-5, scale_atol=1e-6)
    assert_close(tgrads, jgrads, rtol=1e-5, scale_atol=1e-6)


def test_param_size_and_refusals():
    for mode in MODES:
        for bi in (False, True):
            n = rnn_param_size(3, 5, 7, mode, bi)
            assert n == len(rnn_inputs(mode, 3, bi, I=5, H=7)[1])
    x, p, h, c = rnn_inputs("lstm", layers=1, bidirectional=False)
    with mx.cpu():
        args = [nd.array(a) for a in (x, p, h, c)]
        with pytest.raises(mx.MXNetError, match="LSTMP"):
            nd.RNN(*args, state_size=6, mode="lstm", projection_size=3)
        with pytest.raises(mx.MXNetError, match="state_size"):
            nd.RNN(*args, mode="lstm")
    with pytest.raises(NotImplementedError, match="LSTMP"):
        rnn_param_size(1, 5, 7, "lstm", projection_size=3)


def test_symbol_rnn_output_arity():
    x, p, h, c = (mx.sym.Variable(n) for n in "xphc")
    s = mx.sym.RNN(x, p, h, c, state_size=4, num_layers=1, mode="lstm",
                   state_outputs=True)
    assert len(s.list_outputs()) == 3
    s2 = mx.sym.RNN(x, p, h, state_size=4, num_layers=1, mode="gru",
                    state_outputs=True)
    assert len(s2.list_outputs()) == 2
    s3 = mx.sym.RNN(x, p, h, state_size=4, num_layers=1, mode="gru",
                    state_outputs=False)
    assert len(s3.list_outputs()) == 1
    # implicit parameter / state variables, as the JAX front end makes
    s4 = mx.sym.RNN(mx.sym.Variable("data"), state_size=4, mode="lstm",
                    name="lm")
    assert s4.list_arguments() == ["data", "lm_parameters", "lm_state",
                                   "lm_state_cell"]


def _relay_inputs(p_layers, H=32, B=64, T=8):
    """A 2-layer rnn_relu whose second layer passes its input through
    (W_i2h = I, W_h2h = 0, no bias) after a first layer with positive
    outputs, so the output is the inter-layer dropout's result."""
    rng = np.random.RandomState(0)
    x = np.abs(rng.randn(T, B, H)).astype(np.float32)
    n = rnn_param_size(p_layers, H, H, "rnn_relu")
    flat = np.zeros(n, np.float32)
    GH = H
    w0 = np.abs(rng.randn(GH, H)).astype(np.float32) * 0.2
    flat[:GH * H] = w0.reshape(-1)                       # layer 0 W_i2h
    if p_layers == 2:
        off = 2 * GH * H                                 # layer 1 W_i2h
        flat[off:off + GH * H] = np.eye(H, dtype=np.float32).reshape(-1)
    state = np.zeros((p_layers, B, H), np.float32)
    return x, flat, state


def test_inter_layer_dropout_properties():
    p = 0.4
    with mx.cpu():
        args = [nd.array(a) for a in _relay_inputs(2)]
        kw = dict(state_size=32, num_layers=2, mode="rnn_relu", p=p,
                  state_outputs=True)
        plain = nd.RNN(*args, **kw)
        mx.random.seed(5)
        with autograd.train_mode():
            dropped = nd.RNN(*args, **kw)
        mx.random.seed(5)
        with autograd.train_mode():
            again = nd.RNN(*args, **kw)
    y, y0 = dropped[0].asnumpy(), plain[0].asnumpy()
    assert (y0 > 0).all()
    zero = y == 0
    n = zero.size
    assert abs(zero.mean() - p) < 5 * np.sqrt(p * (1 - p) / n)
    # kept entries: exactly x / keep (one dropout, none after the last
    # layer, which would make more zeros and scale twice)
    np.testing.assert_allclose(y[~zero], y0[~zero] / (1 - p), rtol=1e-6)
    # the first layer's state is not dropped
    np.testing.assert_array_equal(dropped[1].asnumpy()[0],
                                  plain[1].asnumpy()[0])
    np.testing.assert_array_equal(again[0].asnumpy(), y)
    # one layer: nothing to drop; outside training: nothing dropped
    with mx.cpu():
        one = [nd.array(a) for a in _relay_inputs(1)]
        kw1 = dict(state_size=32, num_layers=1, mode="rnn_relu", p=p)
        with autograd.train_mode():
            got = nd.RNN(*one, **kw1).asnumpy()
        np.testing.assert_array_equal(got, nd.RNN(*one, **kw1).asnumpy())


# (class, keywords, layout, bidirectional, num_layers, with states)
LAYERS = [("LSTM", {}, "NTC", True, 2, True),
          ("GRU", {}, "TNC", False, 1, False),
          ("RNN", dict(activation="relu"), "NTC", False, 2, True),
          ("RNN", {}, "TNC", True, 1, False)]


@pytest.mark.parametrize("cls,extra,layout,bidirectional,L,with_states",
                         LAYERS, ids=["lstm", "gru", "rnn_relu", "rnn_tanh"])
def test_layer_equals_jax(cls, extra, layout, bidirectional, L,
                          with_states):
    """Outputs, states and every gradient; the JAX layer hybridized (one
    compiled program, as its CachedOp runs it)."""
    H, T, B, C = 5, 4, 3, 6
    rng = np.random.RandomState(2)
    x = rng.randn(*((T, B, C) if layout == "TNC" else (B, T, C))) \
        .astype(np.float32)
    kw = dict(num_layers=L, layout=layout, bidirectional=bidirectional,
              **extra)
    jl, tl = build_pair(lambda: getattr(jgluon.rnn, cls)(H, **kw),
                        lambda: getattr(gluon.rnn, cls)(H, **kw),
                        inputs=[x])
    jl.hybridize()
    assert list(tl.collect_params()) == list(jl.collect_params())
    n_states = 2 if cls == "LSTM" else 1
    d = 2 if bidirectional else 1
    states = [rng.randn(L * d, B, H).astype(np.float32)
              for _ in range(n_states)] if with_states else []
    (jx, *jst), (tx, *tst) = jax_arrays([x] + states), \
        port_arrays([x] + states)
    for a in [jx, tx] + jst + tst:
        a.attach_grad()
    ct = rng.randn(*((T, B, H * d) if layout == "TNC" else (B, T, H * d))) \
        .astype(np.float32)

    def run(blk, xa, sts, pkg_nd, ag):
        with ag.record():
            out = blk(xa, sts) if with_states else blk(xa)
            y = out[0] if with_states else out
            loss = (y * pkg_nd.array(ct)).sum()
            if with_states:
                loss = loss + sum((s * s).sum() for s in out[1])
        loss.backward()
        return out

    jo = run(jl, jx, jst, jnd, jautograd)
    with mx.cpu():
        to = run(tl, tx, tst, nd, autograd)
    assert_close(to, jo, rtol=1e-5, scale_atol=1e-6)
    assert_close([tx.grad] + [s.grad for s in tst],
                 [jx.grad] + [s.grad for s in jst], rtol=1e-5,
                 scale_atol=1e-6)
    jp, tp = jl.collect_params(), tl.collect_params()
    for name in jp:
        assert_close(tp[name].grad(), jp[name].grad(), rtol=1e-5,
                     scale_atol=1e-6)


def _cells(rnn, C, H):
    seq = rnn.SequentialRNNCell()
    seq.add(rnn.LSTMCell(H, input_size=C))
    seq.add(rnn.DropoutCell(0.0))
    seq.add(rnn.ResidualCell(rnn.GRUCell(H, input_size=H)))
    return {
        "rnn": lambda: rnn.RNNCell(H, activation="relu", input_size=C),
        "lstm": lambda: rnn.LSTMCell(H, input_size=C),
        "gru": lambda: rnn.GRUCell(H, input_size=C),
        "sequential": lambda: seq,
        "bidirectional": lambda: rnn.BidirectionalCell(
            rnn.LSTMCell(H, input_size=C), rnn.GRUCell(H, input_size=C)),
        "zoneout": lambda: rnn.ZoneoutCell(rnn.GRUCell(H, input_size=C),
                                           zoneout_outputs=0.3,
                                           zoneout_states=0.3),
    }


@pytest.mark.parametrize("valid", [False, True], ids=["full", "valid_length"])
@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru", "sequential",
                                  "bidirectional", "zoneout"])
def test_cell_unroll_equals_jax(kind, valid):
    T, B, C, H = 5, 3, 4, 4
    rng = np.random.RandomState(3)
    x = rng.randn(B, T, C).astype(np.float32)
    vl = np.array([5, 2, 4], np.float32)
    jc, tc = build_pair(lambda: _cells(jgluon.rnn, C, H)[kind](),
                        lambda: _cells(gluon.rnn, C, H)[kind]())
    assert sorted(jc.collect_params()) == sorted(tc.collect_params())
    jkw = dict(layout="NTC", merge_outputs=True)
    jx, tx = jax_arrays([x])[0], port_arrays([x])[0]
    if valid:
        jkw["valid_length"] = jnd.array(vl)
    jo, js = jc.unroll(T, jx, **jkw)
    if valid:
        jkw["valid_length"] = nd.array(vl, ctx=mx.cpu())
    with mx.cpu():
        to, ts = tc.unroll(T, tx, **jkw)
    assert_close(to, jo, rtol=1e-5, scale_atol=1e-6)
    assert_close(ts, js, rtol=1e-5, scale_atol=1e-6)


def test_bidirectional_valid_length_sees_valid_frames():
    T, B, C, H = 5, 2, 3, 4
    x = np.random.RandomState(3).randn(T, B, C).astype(np.float32)
    with mx.cpu():
        bi = gluon.rnn.BidirectionalCell(gluon.rnn.GRUCell(H, input_size=C),
                                         gluon.rnn.GRUCell(H, input_size=C))
        bi.initialize()
        out, _ = bi.unroll(T, nd.array(x), layout="TNC", merge_outputs=True,
                           valid_length=nd.array([5.0, 2.0]))
        sub, _ = bi.unroll(2, nd.array(x[:2, 1:2]), layout="TNC",
                           merge_outputs=True)
    out = out.asnumpy()
    assert np.allclose(out[2:, 1, :], 0.0)
    assert np.abs(out[0, 1, H:]).sum() > 0
    np.testing.assert_allclose(out[:2, 1, :], sub.asnumpy()[:, 0, :],
                               rtol=1e-5, atol=1e-5)


def test_bidirectional_cell_cannot_step():
    with mx.cpu():
        bi = gluon.rnn.BidirectionalCell(gluon.rnn.GRUCell(2, input_size=2),
                                         gluon.rnn.GRUCell(2, input_size=2))
        bi.initialize()
        with pytest.raises(mx.MXNetError, match="unroll"):
            bi(nd.zeros((1, 2)), bi.begin_state(1))


# --------------------------------------------------------------------- #
# MXNet 1.x's word language model (example/gluon/word_language_model)
# --------------------------------------------------------------------- #
def word_lm(pkg, vocab, units, layers, dropout, tied=True):
    """``model.RNNModel`` of the example in ``pkg`` (either package)."""
    nn, rnn = pkg.gluon.nn, pkg.gluon.rnn

    class RNNModel(pkg.gluon.Block):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.drop = nn.Dropout(dropout)
                self.encoder = nn.Embedding(
                    vocab, units, weight_initializer=pkg.init.Uniform(0.1))
                self.rnn = rnn.LSTM(units, layers, dropout=dropout,
                                    input_size=units)
                if tied:
                    self.decoder = nn.Dense(vocab, in_units=units,
                                            params=self.encoder.params)
                else:
                    self.decoder = nn.Dense(vocab, in_units=units)

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            return self.decoder(output.reshape((-1, units))), hidden

        def begin_state(self, *args, **kwargs):
            return self.rnn.begin_state(*args, **kwargs)

    return RNNModel()


def lm_losses(pkg, model, windows, B, bptt, ctx=None, lr=20.0):
    """The example's ``train()`` over ``windows`` (T x B tokens, targets):
    the hidden state carried and detached, ``clip_global_norm(grads,
    0.25 * bptt * B)``, SGD lr 20; the mean loss of each window."""
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = pkg.gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": lr, "momentum": 0,
                                 "wd": 0})
    params = list(model.collect_params().values())
    hidden = model.begin_state(func=pkg.nd.zeros, batch_size=B,
                               **({"ctx": ctx} if ctx else {}))
    losses = []
    for data, target in windows:
        data = pkg.nd.array(data, dtype="int32", **({"ctx": ctx} if ctx
                                                    else {}))
        target = pkg.nd.array(target.reshape(-1), dtype="int32",
                              **({"ctx": ctx} if ctx else {}))
        hidden = [h.detach() for h in hidden]
        with pkg.autograd.record():
            output, hidden = model(data, hidden)
            L = loss_fn(output, target)
            L.backward()
        grads = [p.grad() for p in params]
        pkg.gluon.utils.clip_global_norm(grads, 0.25 * bptt * B)
        trainer.step(B)
        losses.append(float(L.mean().asnumpy()))
    return losses


def test_word_language_model_trains_as_jax():
    V, U, L, B, bptt = 50, 16, 2, 4, 6
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, V, (5 * bptt + 1, B))
    windows = [(tokens[i * bptt:(i + 1) * bptt],
                tokens[i * bptt + 1:(i + 1) * bptt + 1]) for i in range(5)]
    jmx.random.seed(0)
    fresh_names()
    jm = word_lm(jmx, V, U, L, 0.0)
    jm.initialize(jmx.init.Xavier())
    jm.rnn.hybridize()             # one compiled LSTM (eager: 10x slower)
    mx.random.seed(0)
    fresh_names()
    tm = word_lm(mx, V, U, L, 0.0)
    tm.initialize(mx.init.Xavier(), ctx=mx.cpu())
    jp = jm._collect_params_with_prefix()
    assert sorted(jp) == sorted(tm._collect_params_with_prefix())
    assert list(jm.collect_params()) == list(tm.collect_params())
    # the decoder's weight is the embedding's, by the same name
    assert tm.decoder.weight is tm.encoder.weight
    assert tm.decoder.weight.name == jm.decoder.weight.name
    from incubator_mxnet_tpu_torch.models import convert
    tm.load_state_dict(convert.block_params_from_jax(
        tm, {k: p.data().asnumpy() for k, p in jp.items()}))
    want = lm_losses(jmx, jm, windows, B, bptt)
    with mx.cpu():
        got = lm_losses(mx, tm, windows, B, bptt)
    assert all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for name, p in tm._collect_params_with_prefix().items():
        np.testing.assert_allclose(p.data().asnumpy(),
                                   jp[name].data().asnumpy(), rtol=1e-3,
                                   atol=1e-5)
