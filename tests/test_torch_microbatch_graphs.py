"""The accumulation step's CUDA graph and the image reader on the card.

A small MLP with BatchNorm (f32, SGD with momentum, a power-of-two loss
scale: cuBLAS matmuls, deterministic run to run) through
``SPMDTrainer.step_microbatches``. Held here: rounds of 1, 4 and 4
microbatches replayed from one capture equal, bitwise (losses,
parameters, optimizer state, BatchNorm statistics), a trainer from the
same weights whose every microbatch runs the body eagerly; a NaN
microbatch through a replay leaves all of it bitwise, records one skip
and halves the scale once, and the next round applies through the same
graph. ``io.ImageRecordIter`` on the card: its batch equals numpy's
``(x - mean) / std`` of the same pixels bitwise, and under
``io.PrefetchingIter`` it stages batches on its thread while the step
graph is captured. Each case skips without a CUDA device. This file
imports no JAX, so ``chip_smoke.py`` runs it with ``pytest --noconftest
-m cuda``.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon, nd, parallel
from incubator_mxnet_tpu_torch.amp import LossScaler
from incubator_mxnet_tpu_torch.optimizer.fused import tree_leaves
from incubator_mxnet_tpu_torch.train import StepOutcome

MEAN = dict(mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.395,
            std_g=57.12, std_b=57.375)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _net():
    mx.random.seed(0)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(64, in_units=32, activation="relu"),
            gluon.nn.BatchNorm(in_channels=64), gluon.nn.Dense(10,
                                                               in_units=64))
    net.initialize(ctx=mx.gpu(0))
    return net


def _trainer(net):
    scaler = LossScaler(init_scale=4.0, scale_window=1000)
    return parallel.SPMDTrainer(
        net, loss=gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
        loss_scaler=scaler), scaler


def _micros(k, seed, nan_at=None):
    rng = np.random.RandomState(seed)
    out = []
    for m in range(k):
        x = rng.randn(16, 32).astype(np.float32)
        if m == nan_at:
            x[0, 0] = np.nan
        out.append((nd.array(x, ctx=mx.gpu(0)),
                    nd.array(rng.randint(0, 10, 16), ctx=mx.gpu(0))))
    return out


def _state(tr, net):
    return [p.detach().clone() for p in tr._params] + \
        [t.clone() for t in tree_leaves(tr._opt_state)] + \
        [b.clone() for b in net.buffers()]


@pytest.mark.cuda
def test_replays_equal_the_eager_body_and_skip_a_nan_round(cuda):
    net, ref_net = _net(), _net()
    tr, scaler = _trainer(net)
    ref, _ = _trainer(ref_net)
    ref._capture = lambda prog, body: None      # every microbatch eager
    for i, k in enumerate((1, 4, 4)):
        a = float(tr.step_microbatches(_micros(k, i)).asnumpy())
        b = float(ref.step_microbatches(_micros(k, i)).asnumpy())
        assert a == b and np.isfinite(a)
        for x, y in zip(_state(tr, net), _state(ref, ref_net)):
            assert torch.equal(x, y)
    prog = next(iter(tr._accum_programs.values()))
    assert tr.accum_step_trace_count == 1 and prog.graph is not None
    assert prog.replays == 8 and ref._accum_programs[
        next(iter(ref._accum_programs))].graph is None
    before = _state(tr, net)
    tr.step_microbatches(_micros(4, 9, nan_at=2))
    assert tr.last_outcome is StepOutcome.SKIPPED_NONFINITE
    assert tr.health["SKIPPED_NONFINITE"] == 1 and scaler.loss_scale == 2.0
    assert tr.step_count == 3
    for x, y in zip(_state(tr, net), before):
        assert torch.equal(x, y)
    tr.step_microbatches(_micros(4, 10))
    assert tr.last_outcome is StepOutcome.APPLIED
    assert tr.accum_step_trace_count == 1 and prog.replays == 16


def _rec(tmp_path, n=24):
    from incubator_mxnet_tpu_torch.io import recordio
    rng = np.random.RandomState(0)
    path = str(tmp_path / "imgs.rec")
    w = recordio.MXRecordIO(path, "w")
    for i in range(n):
        h, wd = 36 + i % 5, 40 + i % 7
        img = (rng.rand(h, wd, 3) * 255).astype(np.uint8)
        w.write(recordio.pack_img(recordio.IRHeader(0, float(i % 10), i, 0),
                                  img, quality=90))
    w.close()
    return path


@pytest.mark.cuda
def test_reader_normalizes_on_the_card_as_numpy_does(cuda, tmp_path):
    path = _rec(tmp_path)
    card = mx.io.ImageRecordIter(path, (3, 32, 32), 8, **MEAN).next()
    with mx.cpu():
        pix = mx.io.ImageRecordIter(path, (3, 32, 32), 8).next()
    mean = np.asarray([MEAN[f"mean_{c}"] for c in "rgb"], np.float32)
    std = np.asarray([MEAN[f"std_{c}"] for c in "rgb"], np.float32)
    want = (pix.data[0].asnumpy() - mean.reshape(1, 3, 1, 1)) / \
        std.reshape(1, 3, 1, 1)
    assert card.data[0].context.device_type == "gpu"
    np.testing.assert_array_equal(card.data[0].asnumpy(), want)
    np.testing.assert_array_equal(card.label[0].asnumpy(),
                                  pix.label[0].asnumpy())


@pytest.mark.cuda
def test_capture_while_the_reader_stages_batches(cuda, tmp_path):
    path = _rec(tmp_path)
    mx.random.seed(0)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(8, 3, in_channels=3), gluon.nn.BatchNorm(),
            gluon.nn.Activation("relu"), gluon.nn.GlobalAvgPool2D(),
            gluon.nn.Dense(10))
    net.initialize(ctx=mx.gpu(0))
    net(nd.zeros((1, 3, 32, 32), ctx=mx.gpu(0)))
    tr = parallel.SPMDTrainer(net, loss=gluon.loss.SoftmaxCrossEntropyLoss(),
                              optimizer="sgd",
                              optimizer_params={"learning_rate": 0.05})
    pf = mx.io.PrefetchingIter(mx.io.ResizeIter(mx.io.ImageRecordIter(
        path, (3, 32, 32), 4, rand_crop=True, rand_mirror=True,
        shuffle=True, preprocess_threads=4, **MEAN), 14))
    losses = []
    for k in (2, 4, 4, 4):
        micros = [(b.data[0], b.label[0]) for b in (pf.next()
                                                      for _ in range(k))]
        losses.append(float(tr.step_microbatches(micros).asnumpy()))
    assert list(pf) == []
    assert all(np.isfinite(losses)) and tr.step_count == 4
    prog = next(iter(tr._accum_programs.values()))
    assert tr.accum_step_trace_count == 1 and prog.graph is not None
    assert prog.replays == 13
