"""The port's detectors against the JAX package's, on the CPU.

SSD: ``ssd_300(num_classes=3)`` at 64 x 64, B=2, two ground-truth rows an
image (one a padding row), the JAX weights carried across by
``models.convert.block_params_from_jax``:

  - the training-mode forward: anchors bitwise, ``cls_preds`` and
    ``box_preds`` at rtol 1e-4 plus 1e-4 of each output's largest |entry|;
  - ``training_targets`` (``MultiBoxTarget`` with hard negative mining)
    on the JAX forward's outputs: masks and class targets (the mining
    included) bitwise, box targets within 2 ulps (the two libraries'
    ``log`` differ by an ulp); on the port's own forward the class
    targets are bitwise too;
  - one ``SPMDTrainer(forward_loss=...)`` step with bench.py ``_run_ssd``'s
    SGD (lr 0.05, momentum 0.9, wd 5e-4): the loss at rtol 1e-5, every
    parameter and running statistic afterwards at rtol 1e-4 plus 1e-4 of
    its largest |entry| (plus 1e-6), one build each;
  - ``detect`` on the JAX forward's outputs: rows bitwise in their class
    ids, scores and boxes at rtol 1e-6 plus 1e-6 of the largest |entry|.

Faster R-CNN: ``faster_rcnn_small(num_classes=3, rpn_post_nms_top_n=16)``
at 64 x 64, B=2: rois (batch column bitwise, boxes at rtol 1e-5 plus 1e-5
of the image extent), scores and deltas at rtol 1e-4 plus 1e-4 of the
largest |entry|, and every parameter's gradient of the toy loss of
``tests/test_contrib_det.py`` at rtol 1e-4 plus 1e-4 of its largest
|entry| (the gradients reach the RPN's box branch through the proposals'
coordinates in both packages).

The properties of ``tests/test_contrib_det.py``'s end-to-end cases run
through the port alone (they are ``slow`` in the JAX suite, where each
first op compiles; the port's take a second), with SSD-300's shapes at
300 x 300: 37², 19², 10², 5² and 1² cells, 7424 anchors.

The JAX side runs as few programs as it can: the SSD forward hybridized,
``MultiBoxTarget`` and the detection each one ``jax.jit`` of the registry
function, the train step on a one-device mesh.
"""

import jax
import numpy as np
import pytest

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.models import faster_rcnn as jfrcnn
from incubator_mxnet_tpu.models import ssd as jssd
from incubator_mxnet_tpu.ops import registry as jreg
from incubator_mxnet_tpu.parallel import SPMDTrainer as JaxSPMDTrainer
from incubator_mxnet_tpu.parallel import mesh as jmesh

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd as tag
from incubator_mxnet_tpu_torch import gluon, nd
from incubator_mxnet_tpu_torch.models import convert, faster_rcnn, ssd
from incubator_mxnet_tpu_torch.parallel import SPMDTrainer

from test_torch_model_zoo import _FromPort, _jax_params
from test_torch_parity import assert_close, fresh_names, host

RS = np.random.RandomState
B, SIDE = 2, 64
LABELS = np.array([[[1, 0.1, 0.1, 0.4, 0.4], [-1, 0, 0, 0, 0]],
                   [[0, 0.5, 0.5, 0.9, 0.9], [2, 0.1, 0.6, 0.3, 0.9]]],
                  np.float32)
SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 5e-4}
DETECT = dict(nms_threshold=0.45, threshold=0.01, nms_topk=400)


def _x():
    return RS(0).rand(B, 3, SIDE, SIDE).astype(np.float32)


def _cpu(a):
    return nd.array(host(a).astype(np.float32), ctx=mx.cpu())


def forward_loss(model, xb, yb):
    """bench.py ``_run_ssd``'s training objective."""
    anchors, cls_preds, box_preds = model(xb)
    bt, bm, ct = model.training_targets(anchors, cls_preds, yb)
    return model.loss(cls_preds, box_preds, bt, bm, ct)


def _pair(port_make, jax_make, *inputs):
    """The port's block on the CPU, its shapes completed by a forward; the
    JAX block of the same names given those shapes and the port's weights
    (``_FromPort``), hybridized. Returns the JAX block and its parameters
    (the port block is rebuilt from them by ``_port``)."""
    mx.random.seed(0)
    fresh_names()
    tnet = port_make()
    tnet.initialize(ctx=mx.cpu())
    tnet(*[nd.array(a, ctx=mx.cpu()) for a in inputs])
    fresh_names()
    jnet = jax_make()
    shapes = {p.name: p.shape for p in tnet.collect_params().values()}
    for p in jnet.collect_params().values():
        p.shape = shapes[p.name]
    jnet.initialize(_FromPort(tnet))
    jnet.hybridize()
    return jnet, _jax_params(jnet)


def _port(make, params, *inputs):
    fresh_names()
    net = make()
    net.initialize(ctx=mx.cpu())
    net(*[nd.array(a, ctx=mx.cpu()) for a in inputs])
    net.load_state_dict(convert.block_params_from_jax(net, params))
    return net


def _port_ssd(params):
    return _port(lambda: ssd.ssd_300(num_classes=3), params, _x())


@pytest.fixture(scope="module")
def jax_ssd():
    """The JAX SSD's initial parameters, its training-mode forward, the
    targets and detections of that forward, and one SPMDTrainer step from
    the initial parameters."""
    x = _x()
    net, params = _pair(lambda: ssd.ssd_300(num_classes=3),
                        lambda: jssd.ssd_300(num_classes=3), x)
    with jag.record(train_mode=True):
        anchors, cls_preds, box_preds = net(jnd.array(x))
    fwd = [a._data for a in (anchors, cls_preds, box_preds)]
    targets = jax.jit(lambda a, lab, c: jreg.get("MultiBoxTarget").fn(
        a, lab, c, negative_mining_ratio=3.0))(fwd[0], LABELS, fwd[1])
    dets = jax.jit(lambda c, b, a: jreg.get("MultiBoxDetection").fn(
        jax.nn.softmax(c, axis=1), b, a, **DETECT))(fwd[1], fwd[2], fwd[0])
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(jnd.array(params[k]))
    tr = JaxSPMDTrainer(
        net, forward_loss=forward_loss, optimizer="sgd",
        optimizer_params=SGD, sharding="replicated",
        mesh=jmesh.build_mesh(devices=jax.devices()[:1],
                              axis_sizes={"dp": 1}))
    loss = float(tr.step(jnd.array(x), jnd.array(LABELS)).asnumpy())
    return dict(params=params, forward=[np.asarray(a) for a in fwd],
                targets=[np.asarray(a) for a in targets],
                detections=np.asarray(dets), loss=loss,
                after=_jax_params(net), traces=tr.step_trace_count)


def test_ssd_forward_equals_jax(jax_ssd):
    net = _port_ssd(jax_ssd["params"])
    with tag.record(train_mode=True):
        out = net(nd.array(_x(), ctx=mx.cpu()))
    anchors, cls_preds, box_preds = jax_ssd["forward"]
    np.testing.assert_array_equal(host(out[0]), anchors)
    assert_close(out[1], cls_preds, rtol=1e-4, scale_atol=1e-4)
    assert_close(out[2], box_preds, rtol=1e-4, scale_atol=1e-4)
    # the port's own class targets, mining included, from its own forward
    ct = net.training_targets(out[0], out[1], _cpu(LABELS))[2]
    np.testing.assert_array_equal(host(ct), jax_ssd["targets"][2])


def test_ssd_training_targets_are_exact(jax_ssd):
    net = _port_ssd(jax_ssd["params"])
    anchors, cls_preds, _ = jax_ssd["forward"]
    got = [host(t).astype(np.float32) for t in net.training_targets(
        _cpu(anchors), _cpu(cls_preds), _cpu(LABELS))]
    bt, bm, ct = jax_ssd["targets"]
    np.testing.assert_array_equal(got[1], bm)
    np.testing.assert_array_equal(got[2], ct)
    np.testing.assert_array_max_ulp(got[0], bt, maxulp=2)
    assert (ct == -1).any() and (ct > 0).any()    # mining ignored some


def test_ssd_sgd_step_equals_jax(jax_ssd):
    net = _port_ssd(jax_ssd["params"])
    tr = SPMDTrainer(net, forward_loss=forward_loss, optimizer="sgd",
                     optimizer_params=SGD, sharding="replicated")
    loss = float(tr.step(nd.array(_x(), ctx=mx.cpu()),
                         _cpu(LABELS)).asnumpy())
    np.testing.assert_allclose(loss, jax_ssd["loss"], rtol=1e-5)
    assert tr.step_trace_count == jax_ssd["traces"] == 1
    after = jax_ssd["after"]
    got = net._collect_params_with_prefix()
    assert sorted(got) == sorted(after)
    for name, p in got.items():
        assert_close(p.data(), after[name], rtol=1e-4, atol=1e-6,
                     scale_atol=1e-4)


def test_ssd_detect_equals_jax(jax_ssd):
    net = _port_ssd(jax_ssd["params"])
    anchors, cls_preds, box_preds = (_cpu(a) for a in jax_ssd["forward"])
    got = host(net.detect(cls_preds, box_preds, anchors, **DETECT))
    want = jax_ssd["detections"]
    assert got.shape == (B, anchors.shape[1], 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    assert (want[..., 0] >= 0).sum() > 10
    assert_close(got[..., 1:], want[..., 1:], rtol=1e-6, scale_atol=1e-6)


def test_ssd_300_shapes_in_the_port():
    """Three 2x2 max pools floor 300 to 37; 7424 anchors; the extra
    stages keep 128 channels whatever the backbone's widths."""
    with mx.cpu():
        net = ssd.ssd_300(num_classes=20, base_channels=(8, 8, 16))
        net.initialize()
        x = nd.array(RS(1).rand(1, 3, 300, 300).astype(np.float32))
        anchors, cls_preds, box_preds = net(x)
        feats = [net.backbone(x)]
        for stage in net.stages:
            feats.append(stage(feats[-1]))
    assert [f.shape[2] for f in feats] == [37, 19, 10, 5]
    assert all(f.shape[1] == 128 for f in feats[1:])
    assert anchors.shape == (1, 7424, 4)
    assert cls_preds.shape == (1, 21, 7424) and box_preds.shape == (1,
                                                                    29696)


def test_ssd_end_to_end_in_the_port():
    with mx.cpu():
        mx.random.seed(0)
        net = ssd.ssd_300(num_classes=3)
        net.initialize()
        x = nd.random.uniform(shape=(2, 3, 64, 64))
        anchors, cls_preds, box_preds = net(x)
        N = anchors.shape[1]
        assert cls_preds.shape == (2, 4, N) and box_preds.shape == (2, N * 4)
        labels = nd.array(LABELS)
        bt, bm, ct = net.training_targets(anchors, cls_preds, labels)
        assert ct.shape == (2, N) and bt.shape == (2, N * 4)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
        with tag.record():
            a, cp, bp = net(x)
            loss = net.loss(cp, bp, *net.training_targets(a, cp, labels))
        loss.backward()
        tr.step(2)
        assert (ct.asnumpy() == -1).any()
        assert net.detect(cls_preds, box_preds, anchors).shape == (2, N, 6)


RCNN = dict(num_classes=3, rpn_post_nms_top_n=16)


def _rcnn_inputs():
    x = RS(0).rand(B, 3, SIDE, SIDE).astype(np.float32)
    info = np.tile([SIDE, SIDE, 1.0], (B, 1)).astype(np.float32)
    return x, info


def _toy_loss(s, d):
    return (s.log_softmax(axis=-1)[:, :, 0]).mean() * -1 + (d * d).mean()


@pytest.fixture(scope="module")
def jax_rcnn():
    x, info = _rcnn_inputs()
    net, params = _pair(lambda: faster_rcnn.faster_rcnn_small(**RCNN),
                        lambda: jfrcnn.faster_rcnn_small(**RCNN), x, info)
    with jag.record():
        outs = net(jnd.array(x), jnd.array(info))
        loss = _toy_loss(outs[1], outs[2])
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in
             net._collect_params_with_prefix().items()}
    return dict(params=params, outs=[o.asnumpy() for o in outs],
                loss=float(loss.asnumpy()), grads=grads)


def test_faster_rcnn_equals_jax(jax_rcnn):
    x, info = _rcnn_inputs()
    net = _port(lambda: faster_rcnn.faster_rcnn_small(**RCNN),
                jax_rcnn["params"], x, info)
    with tag.record():
        outs = net(nd.array(x, ctx=mx.cpu()), nd.array(info, ctx=mx.cpu()))
        loss = _toy_loss(outs[1], outs[2])
    loss.backward()
    rois, scores, deltas, rpn_cls, rpn_box = jax_rcnn["outs"]
    got = host(outs[0])
    np.testing.assert_array_equal(got[..., 0], rois[..., 0])
    np.testing.assert_allclose(got[..., 1:], rois[..., 1:], rtol=1e-5,
                               atol=1e-5 * SIDE)
    assert (rois[..., 1:] > 0).any(axis=-1).sum() > 8
    for g, w in zip(outs[1:], (scores, deltas, rpn_cls, rpn_box)):
        assert_close(g, w, rtol=1e-4, scale_atol=1e-4)
    np.testing.assert_allclose(float(loss.asnumpy()), jax_rcnn["loss"],
                               rtol=1e-5)
    grads = jax_rcnn["grads"]
    for name, p in net._collect_params_with_prefix().items():
        assert_close(p.grad(), grads[name], rtol=1e-4, scale_atol=1e-4)
    assert np.abs(grads["rpn_box.weight"]).sum() > 0


def test_faster_rcnn_forward_and_grad_in_the_port():
    """Fixed-shape rois with the image's batch index, boxes inside the
    image, and a gluon.Trainer step whose gradient reaches the backbone."""
    x, info = _rcnn_inputs()
    with mx.cpu():
        mx.random.seed(0)
        net = faster_rcnn.faster_rcnn_small(**RCNN)
        net.initialize()
        xs, infos = nd.array(x), nd.array(info)
        rois, scores, deltas, _, _ = net(xs, infos)
        assert rois.shape == (B, 16, 5) and scores.shape == (B, 16, 4)
        assert deltas.shape == (B, 16, 4)
        r = rois.asnumpy()
        for i in range(B):
            assert (r[i, :, 0].astype(int) == i).all()
        assert (r[..., 1:] >= 0).all() and (r[..., (1, 3)] <= SIDE).all() \
            and (r[..., (2, 4)] <= SIDE).all()
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.01}, kvstore=None)
        with tag.record():
            _, s, d, _, _ = net(xs, infos)
            loss = _toy_loss(s, d)
        loss.backward()
        tr.step(1)
        assert np.abs(net.backbone.body[0].weight.grad().asnumpy()).sum() \
            > 0
