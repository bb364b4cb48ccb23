"""The port's ``gluon.contrib`` against the JAX package on the CPU.

  - the contrib cells' ``unroll`` (``Conv2DRNNCell``, ``Conv2DLSTMCell``,
    ``Conv2DGRUCell``, ``LSTMPCell``): parameter names, outputs and
    states at rtol 1e-5 with an atol of 1e-6 of the largest |entry| (f32
    convolutions and products in another summation order), and
    ``Conv2DLSTMCell``'s gradients at the same tolerance;
  - ``VariationalDropoutCell`` by its properties (torch's Philox and JAX's
    threefry never draw alike): outside training the base cell's
    outputs, in training one input mask for every step of an unroll, its
    entries 0 or 1 / (1 - p), a new one after ``reset``;
  - ``HybridConcurrent`` / ``Concurrent`` / ``Identity`` at rtol 1e-5,
    ``PixelShuffle1D/2D/3D`` bitwise, ``SyncBatchNorm``'s output and
    running statistics after a training step at rtol 1e-5 (its
    ``num_devices`` kept); ``SparseEmbedding``'s names, gradient storage
    type and lookup;
  - ``Estimator.fit`` over an ``NDArrayIter`` with shuffle off: the loss
    after every batch at rtol 1e-5, the final parameters at rtol 1e-4,
    ``evaluate``, the epoch log lines, ``EarlyStoppingHandler``'s stop and
    ``CheckpointHandler``'s files, which the JAX package loads.
"""

import contextlib
import os

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.gluon import contrib as jcontrib

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, nd
from incubator_mxnet_tpu_torch.gluon import contrib as tcontrib

from test_torch_parity import (assert_close, build_pair, fresh_names,
                               jax_arrays, port_arrays)

CELLS = {
    "conv_rnn": lambda c: c.rnn.Conv2DRNNCell((2, 5, 4), 3,
                                              activation="relu"),
    "conv_lstm": lambda c: c.rnn.Conv2DLSTMCell((2, 5, 4), 3,
                                                h2h_kernel=(1, 3)),
    "conv_gru": lambda c: c.rnn.Conv2DGRUCell((2, 5, 4), 3, i2h_kernel=1),
    "lstmp": lambda c: c.rnn.LSTMPCell(6, 3, input_size=4),
}


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_contrib_cell_unroll_equals_jax(kind):
    T, B = 3, 2
    rng = np.random.RandomState(1)
    shape = (B, T, 4) if kind == "lstmp" else (B, T, 2, 5, 4)
    x = rng.randn(*shape).astype(np.float32)
    jc, tc = build_pair(lambda: CELLS[kind](jcontrib),
                        lambda: CELLS[kind](tcontrib))
    assert list(tc.collect_params()) == list(jc.collect_params())
    jx, tx = jax_arrays([x])[0], port_arrays([x])[0]
    grads = kind == "conv_lstm"
    if grads:
        jx.attach_grad()
        tx.attach_grad()
    with jautograd.record():
        jo, js = jc.unroll(T, jx, layout="NTC", merge_outputs=True)
        jl = (jo * jo).sum()
    with mx.cpu(), autograd.record():
        to, ts = tc.unroll(T, tx, layout="NTC", merge_outputs=True)
        tl = (to * to).sum()
    assert_close(to, jo, rtol=1e-5, scale_atol=1e-6)
    assert_close(ts, js, rtol=1e-5, scale_atol=1e-6)
    if grads:
        jl.backward()
        tl.backward()
        assert_close(tx.grad, jx.grad, rtol=1e-5, scale_atol=1e-6)
        jp, tp = jc.collect_params(), tc.collect_params()
        for name in jp:
            assert_close(tp[name].grad(), jp[name].grad(), rtol=1e-5,
                         scale_atol=1e-6)


def test_conv_cell_refuses_even_kernels():
    for c in (jcontrib, tcontrib):
        with pytest.raises(c.rnn.MXNetError, match="odd"):
            c.rnn.Conv2DLSTMCell((2, 5, 4), 3, i2h_kernel=(2, 3))


def test_variational_dropout_cell_properties():
    p, T, B, C = 0.5, 4, 64, 8
    x = np.random.RandomState(2).randn(B, T, C).astype(np.float32)
    with mx.cpu():
        base = gluon.rnn.GRUCell(8, input_size=C)
        cell = tcontrib.rnn.VariationalDropoutCell(base, drop_inputs=p)
        cell.initialize()
        xs = nd.array(x)
        plain, _ = cell.unroll(T, xs, layout="NTC")
        ref, _ = base.unroll(T, xs, layout="NTC")
        np.testing.assert_array_equal(plain.asnumpy(), ref.asnumpy())
        seen = []
        real_base = cell.base_cell.forward

        def spy(inputs, states):
            seen.append(inputs.asnumpy())
            return real_base(inputs, states)

        cell.base_cell.forward = spy
        with autograd.train_mode():
            cell.unroll(T, xs, layout="NTC")
            first = cell._input_mask.asnumpy()
            cell.unroll(T, xs, layout="NTC")
            second = cell._input_mask.asnumpy()
    assert set(np.unique(first)) <= {0.0, 1.0 / (1 - p)}
    assert abs((first == 0).mean() - p) < 5 * np.sqrt(p * (1 - p)
                                                       / first.size)
    for t in range(T):               # the one mask at every step
        np.testing.assert_array_equal(seen[t], x[:, t] * first)
    assert not np.array_equal(first, second)      # reset draws anew


def test_concurrent_and_identity_equal_jax():
    x = np.random.RandomState(3).randn(3, 5).astype(np.float32)

    def build(g, c, cls):
        blk = getattr(c.nn, cls)(axis=-1)
        blk.add(g.nn.Dense(4), c.nn.Identity(), g.nn.Dense(2))
        return blk

    for cls in ("HybridConcurrent", "Concurrent"):
        jb, tb = build_pair(lambda: build(jgluon, jcontrib, cls),
                            lambda: build(gluon, tcontrib, cls), inputs=[x])
        with mx.cpu():
            got = tb(port_arrays([x])[0])
        assert got.shape == (3, 11)
        assert_close(got, jb(jax_arrays([x])[0]), rtol=1e-5, scale_atol=1e-6)


@pytest.mark.parametrize("cls,factor,shape", [
    ("PixelShuffle1D", 3, (2, 6, 5)),
    ("PixelShuffle2D", (2, 3), (2, 12, 3, 4)),
    ("PixelShuffle3D", 2, (1, 16, 2, 3, 2))])
def test_pixel_shuffle_equals_jax(cls, factor, shape):
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    want = getattr(jcontrib.nn, cls)(factor)(jax_arrays([x])[0]).asnumpy()
    with mx.cpu():
        got = getattr(tcontrib.nn, cls)(factor)(port_arrays([x])[0])
    np.testing.assert_array_equal(got.asnumpy(), want)
    with pytest.raises(mx.MXNetError, match="divisible|!= 0"):
        with mx.cpu():
            getattr(tcontrib.nn, cls)(factor)(
                nd.zeros((1, 7) + shape[2:]))


def test_sync_batch_norm_equals_jax():
    x = np.random.RandomState(5).randn(4, 3, 2, 2).astype(np.float32)
    jb, tb = build_pair(lambda: jcontrib.nn.SyncBatchNorm(num_devices=4),
                        lambda: tcontrib.nn.SyncBatchNorm(num_devices=4),
                        inputs=[x])
    assert tb._num_devices == 4
    with jautograd.record():
        jo = jb(jax_arrays([x])[0])
    with mx.cpu(), autograd.record():
        to = tb(port_arrays([x])[0])
    assert_close(to, jo, rtol=1e-5, scale_atol=1e-6)
    for name in ("running_mean", "running_var"):
        assert_close(getattr(tb, name).data(), getattr(jb, name).data(),
                     rtol=1e-5, scale_atol=1e-6)


def test_sparse_embedding_waits_for_sparse_storage():
    """``SparseEmbedding`` (sparse storage is ported): the JAX block's
    parameter names, a row-sparse gradient type and its lookup at rtol
    1e-5 (its training: ``tests/test_torch_sparse.py``)."""
    ids = np.array([[3, 7], [49, 3]], np.float32)
    jb, tb = build_pair(lambda: jcontrib.nn.SparseEmbedding(50, 8),
                        lambda: tcontrib.nn.SparseEmbedding(50, 8))
    assert sorted(tb._collect_params_with_prefix()) == \
        sorted(jb._collect_params_with_prefix())
    assert tb.weight._grad_stype == jb.weight._grad_stype == "row_sparse"
    with mx.cpu():
        assert_close(tb(port_arrays([ids])[0]), jb(jax_arrays([ids])[0]),
                     rtol=1e-5)


# --------------------------------------------------------------------- #
# Estimator
# --------------------------------------------------------------------- #
def _toy(pkg):
    rng = np.random.RandomState(0)
    X = rng.randn(96, 8).astype(np.float32)
    y = np.argmax(X @ rng.randn(8, 3).astype(np.float32), 1) \
        .astype(np.float32)
    return pkg.io.NDArrayIter(X, y, batch_size=32, shuffle=False,
                              label_name="softmax_label"), X, y


def _net(pkg):
    pkg.random.seed(0)
    fresh_names()
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(16, activation="relu"),
            pkg.gluon.nn.Dense(3))
    net.initialize(pkg.init.Xavier())
    it, X, y = _toy(pkg)
    net(pkg.nd.array(X[:1]))
    return net, it


class _Losses:
    """A ``batch_end`` handler keeping the loss metric after each batch."""

    def __init__(self):
        self.values = []

    def batch_end(self, est):
        self.values.append(dict(est.train_metrics_values())["loss"])


def test_estimator_fit_equals_jax(tmp_path):
    jnet, jit_ = _net(jmx)
    with mx.cpu():
        tnet, tit = _net(mx)
    tnet.load_parameters(_save(jnet, tmp_path / "init.params"))
    runs = []
    for pkg, c, net, it, d in ((jmx, jcontrib, jnet, jit_, "j"),
                               (mx, tcontrib, tnet, tit, "t")):
        logs, losses = [], _Losses()
        os.makedirs(tmp_path / d)
        with (mx.cpu() if pkg is mx else contextlib.nullcontext()):
            est = c.estimator.Estimator(
                net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
                train_metrics="acc",
                trainer=pkg.gluon.Trainer(net.collect_params(), "sgd",
                                          {"learning_rate": 0.1}),
                logger=logs.append)
            est.fit(it, epochs=4, event_handlers=[
                losses, c.estimator.CheckpointHandler(str(tmp_path / d)),
                c.estimator.EarlyStoppingHandler(monitor="loss", mode="max",
                                                 patience=1)])
            evals = est.evaluate(it)
        runs.append((losses.values, evals, logs,
                     sorted(os.listdir(tmp_path / d))))
    (jl, je, jlogs, jfiles), (tl, te, tlogs, tfiles) = runs
    assert len(tl) == len(jl) == 6                  # 2 epochs of 3 batches
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert [n for n, _ in te] == [n for n, _ in je]
    np.testing.assert_allclose([v for _, v in te], [v for _, v in je],
                               rtol=1e-5)
    assert "early stop at epoch 1" in tlogs
    assert [s for s in tlogs if "done" in s or "stop" in s] == \
        [s for s in jlogs if "done" in s or "stop" in s]
    assert tfiles == jfiles == ["model-0000.params", "model-0001.params"]
    jp = jnet._collect_params_with_prefix()
    for name, p in tnet._collect_params_with_prefix().items():
        np.testing.assert_allclose(p.data().asnumpy(),
                                   jp[name].data().asnumpy(), rtol=1e-4,
                                   atol=1e-6)
    # the port's checkpoint loads into the JAX net
    jnet.load_parameters(str(tmp_path / "t" / "model-0001.params"))
    for name, p in tnet._collect_params_with_prefix().items():
        np.testing.assert_array_equal(jp[name].data().asnumpy(),
                                      p.data().asnumpy())


def _save(net, path):
    net.save_parameters(str(path))
    return str(path)
