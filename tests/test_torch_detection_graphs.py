"""SSD's train step graph and its detection, on the card.

``ssd_300(num_classes=3)`` f32 at 64 x 64, B=2 (two ground-truth rows an
image, one a padding row), bench.py ``_run_ssd``'s SGD (lr 0.05, momentum
0.9, wd 5e-4) through ``SPMDTrainer(forward_loss=...)``: the step, with
``MultiBoxTarget``'s matching and hard negative mining inside it, is
captured once, and over 3 steps (cuDNN deterministic) its losses equal
a second trainer's step body run eagerly from the same weights within
1e-5, every parameter and optimizer-state tensor within 1e-4 of its
largest |entry| (the gathers' backward accumulates with atomics, so the
two are not bitwise); then
``SSD.detect`` on the card equals ``MultiBoxDetection`` on the CPU from
the card's class probabilities: class ids bitwise, scores and boxes
within 1e-6 (a selection by score: probabilities an ulp apart, from a
softmax on each device, would order rows differently). Each case skips
without a CUDA device. This file imports no JAX, so ``chip_smoke.py``
runs it with ``pytest --noconftest -m cuda``.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.models import ssd
from incubator_mxnet_tpu_torch.parallel import SPMDTrainer

from test_torch_train_graphs import _eager_step, _state

LABELS = np.array([[[1, 0.1, 0.1, 0.4, 0.4], [-1, 0, 0, 0, 0]],
                   [[0, 0.5, 0.5, 0.9, 0.9], [2, 0.1, 0.6, 0.3, 0.9]]],
                  np.float32)
SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 5e-4}
TOL, STATE_TOL = 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def forward_loss(model, xb, yb):
    anchors, cls_preds, box_preds = model(xb)
    bt, bm, ct = model.training_targets(anchors, cls_preds, yb)
    return model.loss(cls_preds, box_preds, bt, bm, ct)


def _net(x):
    mx.random.seed(0)
    net = ssd.ssd_300(num_classes=3)
    net.initialize(ctx=mx.gpu(0))
    net(x)
    return net


def _err(a, b):
    """max |a - b| over max |b|."""
    return float((a.double() - b.double()).abs().max()) / \
        max(float(b.double().abs().max()), 1e-30)


@pytest.mark.cuda
def test_ssd_replay_equals_eager_body(cuda):
    x = nd.array(np.random.RandomState(0).rand(2, 3, 64, 64)
                 .astype(np.float32), ctx=mx.gpu(0))
    y = nd.array(LABELS, ctx=mx.gpu(0))
    net, ref_net = _net(x), _net(x)
    ref_net.load_state_dict(net.state_dict())
    tr, ref = (SPMDTrainer(n, forward_loss=forward_loss, optimizer="sgd",
                           optimizer_params=dict(SGD))
               for n in (net, ref_net))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for i in range(3):
            got = tr.step(x, y)._data
            want = _eager_step(ref, [x._data, y._data])
            assert _err(got, want) <= TOL, (i, float(got), float(want))
            worst = max(_err(a, b) for a, b in zip(_state(tr), _state(ref)))
            assert worst <= STATE_TOL, (i, worst)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert tr.step_trace_count == 1
    assert next(iter(tr._programs.values())).replays == 2


@pytest.mark.cuda
def test_ssd_detect_on_the_card_equals_the_cpu(cuda):
    x = nd.array(np.random.RandomState(1).rand(2, 3, 64, 64)
                 .astype(np.float32), ctx=mx.gpu(0))
    net = _net(x)
    anchors, cls_preds, box_preds = net(x)
    got = net.detect(cls_preds, box_preds, anchors)._data.cpu()
    probs = nd.softmax(cls_preds, axis=1)
    cpu = [nd.array(a._data.cpu(), ctx=mx.cpu())
           for a in (probs, box_preds, anchors)]
    with mx.cpu():
        want = nd.MultiBoxDetection(*cpu, nms_threshold=0.45,
                                    threshold=0.01, nms_topk=400)._data
        soft = nd.softmax(nd.array(cls_preds._data.cpu()), axis=1)._data
    assert torch.allclose(probs._data.cpu(), soft, rtol=1e-5, atol=1e-7)
    assert torch.equal(got[..., 0], want[..., 0])
    assert int((want[..., 0] >= 0).sum()) > 0
    assert float((got[..., 1:] - want[..., 1:]).abs().max()) <= 1e-6
