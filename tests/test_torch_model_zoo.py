"""The port's vision model zoo, LeNet and the structural-name converter
against the JAX package's, on the CPU.

  - ``get_model``'s name table equals the JAX one, and every name builds
    the JAX network's structural names and (deferred) shapes;
    ``pretrained=True`` and an unknown name raise;
  - one forward per family in training mode (BatchNorm on batch
    statistics, running statistics moved; dropout rates set to 0, the
    packages drawing different masks) with the JAX weights carried
    across by ``models.convert.block_params_from_jax``, at f32 rtol 1e-4:
    ResNet v1 / v2 with basic and bottleneck blocks, VGG with BatchNorm,
    AlexNet, DenseNet, SqueezeNet 1.1, MobileNet v1 and v2, and
    Inception V3's five block kinds (the whole network at 299 x 299 only
    in the port: the JAX network's first forward compiles each of its
    ops, which takes long on the CPU), each at its least input; widths
    are cut where a family's constructor takes them (ResNet bottlenecks,
    DenseNet), and every train-mode BatchNorm averages at least 8 values
    a channel (over fewer, it amplifies f32 rounding);
  - LeNet equals the JAX LeNet;
  - ``resnet18_v1(thumbnail=True, classes=10)`` f32, B=32, 32 x 32: three
    ``SPMDTrainer`` SGD steps (lr 1e-3, momentum 0.9) equal the JAX
    trainer's (losses at rtol 2e-4, final parameters and running
    statistics at rtol 1e-3 plus 1e-3 of each tensor's largest |entry|
    plus 1e-5) with an equal
    ``step_trace_count``. The batch and the rate keep the three steps
    well conditioned: at B=8 with lr 0.1 or 0.01 a change of 1e-6 in the
    weights moves the third loss by 3.5e-3 to 1.7e-2, so f32 rounding
    alone parts two implementations past 2e-4; here it moves it by
    3.9e-5 (``tools/torch_vision_conditioning.py sensitivity``);
  - the converter refuses a missing, extra, misshaped or mistyped name;
  - ``cuda``: a ResNet step's replay equals its body run eagerly
    (cuDNN deterministic), and the zoo builds on ``gpu(0)`` by default.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.gluon import loss as jloss
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu.models import lenet as jlenet

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd as tag
from incubator_mxnet_tpu_torch import models
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon import loss as tloss
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from incubator_mxnet_tpu_torch.models import convert
from incubator_mxnet_tpu_torch.parallel import SPMDTrainer

from test_torch_parity import assert_close, fresh_names, jax_arrays, \
    port_arrays

RS = np.random.RandomState


def _x(*shape, seed=0):
    return RS(seed).rand(*shape).astype(np.float32)


def _jax_params(block):
    return {k: p.data().asnumpy()
            for k, p in block._collect_params_with_prefix().items()}


def _no_dropout(block):
    """Dropout layers' rate to 0 (the packages draw different masks)."""
    if type(block).__name__ == "Dropout":
        block._rate = 0.0
    for child in block._children.values():
        _no_dropout(child)
    return block


def _initial_stats(jax_params, block):
    """The JAX block's parameters with the running statistics as
    ``block`` (freshly initialized) holds them."""
    own = block._collect_params_with_prefix()
    return {k: own[k].data().asnumpy() if "running_" in k else v
            for k, v in jax_params.items()}


class _FromPort(jmx.init.Initializer):
    """The JAX initializer that takes each weight from the port's block
    of the same parameter names (biases and BatchNorm parameters keep
    their constant initializers)."""

    def __init__(self, block):
        super().__init__()
        self._weights = {p.name: p.data().asnumpy()
                         for p in block.collect_params().values()}

    def _init_weight(self, name, arr):
        arr._data = jnp.asarray(self._weights[name])


def _train_forward(make, x):
    """The port's block on the CPU (dropout off), its shapes completed by
    a forward; the JAX block of the same construction given those shapes
    and the port's random weights by parameter name (``_FromPort``: the
    JAX package's random initializers compile a kernel for each shape),
    hybridized (one compile of the whole forward, where op by op
    compiles each op) and run once in training mode; then the
    JAX block's weights carried back into the port's by
    ``block_params_from_jax``, the running statistics as they were before
    that forward."""
    mx.random.seed(0)
    fresh_names()
    tblk = _no_dropout(make(tvision))
    tblk.initialize(ctx=mx.cpu())
    tblk(*port_arrays([x]))
    fresh_names()
    jblk = _no_dropout(make(jvision))
    shapes = {p.name: p.shape for p in tblk.collect_params().values()}
    for p in jblk.collect_params().values():
        p.shape = shapes[p.name]
    jblk.initialize(_FromPort(tblk))
    jblk.hybridize()
    with jag.record(train_mode=True):
        jy = jblk(*jax_arrays([x]))
    tblk.load_state_dict(convert.block_params_from_jax(
        tblk, _initial_stats(_jax_params(jblk), tblk)))
    return jblk, jy, tblk


def test_model_table_equals_jax():
    assert sorted(tvision._models) == sorted(jvision._models)
    for bad in (lambda v: v.get_model("resnet9999_v9"),
                lambda v: v.get_model("resnet18_v1", pretrained=True),
                lambda v: v.get_model("vgg16", pretrained=True),
                lambda v: v.get_resnet(3, 18)):
        with pytest.raises(MXNetError):
            bad(tvision)


@pytest.mark.parametrize("name", sorted(jvision._models))
def test_every_model_builds_the_jax_structure(name):
    fresh_names()
    jnet = jvision.get_model(name, classes=7)
    fresh_names()
    tnet = tvision.get_model(name, classes=7)
    jp = jnet._collect_params_with_prefix()
    tp = tnet._collect_params_with_prefix()
    assert list(tp) == list(jp)
    assert [p.shape for p in tp.values()] == [p.shape for p in jp.values()]
    assert [p.name for p in tp.values()] == [p.name for p in jp.values()]


def _inception_block(kind):
    def make(v):
        inc = v.inception
        if kind == "A":
            return inc._make_A(32, "A1_")
        if kind == "B":
            return inc._make_B("B_")
        if kind == "C":
            return inc._make_C(128, "C1_")
        if kind == "D":
            return inc._make_D("D_")
        return inc._make_E("E1_")
    return make


# family: (constructor over a vision module, input shape)
FAMILIES = {
    "resnet_v1-basic": (lambda v: v.resnet18_v1(thumbnail=True, classes=10),
                        (32, 3, 32, 32)),
    "resnet_v1-bottleneck": (lambda v: v.ResNetV1(
        v.BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128], classes=10),
        (2, 3, 64, 64)),
    "resnet_v2-basic": (lambda v: v.resnet18_v2(thumbnail=True, classes=10),
                        (4, 3, 16, 16)),
    "resnet_v2-bottleneck": (lambda v: v.ResNetV2(
        v.BottleneckV2, [1, 2, 1, 1], [8, 16, 32, 64, 128], classes=10),
        (2, 3, 64, 64)),
    "vgg_bn": (lambda v: v.vgg11_bn(classes=10), (2, 3, 64, 64)),
    "alexnet": (lambda v: v.alexnet(classes=10), (1, 3, 63, 63)),
    "densenet": (lambda v: v.DenseNet(8, 4, [1, 2, 1, 1], classes=10),
                 (1, 3, 221, 221)),
    "squeezenet": (lambda v: v.squeezenet1_1(classes=10), (1, 3, 33, 33)),
    "mobilenet": (lambda v: v.mobilenet0_25(classes=10), (2, 3, 64, 64)),
    "mobilenet_v2": (lambda v: v.mobilenet_v2_0_25(classes=10),
                     (4, 3, 64, 64)),
    "inception-A": (_inception_block("A"), (1, 16, 7, 7)),
    "inception-B": (_inception_block("B"), (1, 16, 7, 7)),
    "inception-C": (_inception_block("C"), (1, 16, 7, 7)),
    "inception-D": (_inception_block("D"), (1, 16, 7, 7)),
    "inception-E": (_inception_block("E"), (1, 16, 5, 5)),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_forward_equals_jax(family):
    make, shape = FAMILIES[family]
    x = _x(*shape)
    jblk, jy, tblk = _train_forward(make, x)
    with tag.record(train_mode=True):
        ty = tblk(*port_arrays([x]))
    assert_close(ty, jy, rtol=1e-4, scale_atol=1e-4)
    jp = _jax_params(jblk)
    for name, p in tblk._collect_params_with_prefix().items():
        # a running mean is an average whose rounding scales with the
        # data's magnitude, not its own: 1e-6 absolute
        assert_close(p.data(), jp[name], rtol=1e-4, atol=1e-6,
                     scale_atol=1e-4)


def test_inception_v3_runs_at_299_in_the_port():
    with mx.cpu():
        net = tvision.inception_v3(classes=5)
        net.initialize()
        out = net(mx.nd.array(_x(1, 3, 299, 299)))
    assert out.shape == (1, 5) and np.isfinite(out.asnumpy()).all()


def test_lenet_equals_jax():
    x = _x(2, 1, 28, 28)
    jmx.random.seed(0)
    fresh_names()
    jnet = jlenet.LeNet()
    jnet.initialize()
    jy0 = jnet(*jax_arrays([x]))
    fresh_names()
    tnet = models.LeNet()
    tnet.initialize(ctx=mx.cpu())
    tnet(*port_arrays([x]))
    tnet.load_state_dict(convert.block_params_from_jax(tnet,
                                                       _jax_params(jnet)))
    assert_close(tnet(*port_arrays([x])), jy0, rtol=1e-4, scale_atol=1e-5)


def test_converter_refuses_bad_names():
    make, shape = FAMILIES["resnet_v2-basic"]
    jblk, _, tblk = _train_forward(make, _x(*shape))
    params = _jax_params(jblk)
    assert len(params) == len(tblk.state_dict())
    name = "features.1.0.body.1.running_mean" if \
        "features.1.0.body.1.running_mean" in params else sorted(params)[3]
    missing = dict(params)
    del missing[name]
    with pytest.raises(MXNetError, match="structural names differ"):
        convert.block_params_from_jax(tblk, missing)
    with pytest.raises(MXNetError, match="structural names differ"):
        convert.block_params_from_jax(tblk, dict(params, extra=params[name]))
    with pytest.raises(MXNetError, match="shape"):
        convert.block_params_from_jax(
            tblk, dict(params, **{name: params[name][:-1]}))
    with pytest.raises(MXNetError, match="dtype"):
        convert.block_params_from_jax(
            tblk, dict(params, **{name: params[name].astype(np.float16)}))
    with pytest.raises(MXNetError, match="dict of structural names"):
        convert.block_params_from_jax(tblk, list(params.values()))


B, SIDE, CLASSES = 32, 32, 10
SGD = {"learning_rate": 0.001, "momentum": 0.9}


def _batch():
    rng = RS(0)
    return (rng.rand(B, 3, SIDE, SIDE).astype(np.float32),
            rng.randint(0, CLASSES, (B,)).astype(np.int32))


def _resnet18(v):
    return FAMILIES["resnet_v1-basic"][0](v)


@pytest.fixture(scope="module")
def jax_train():
    """The JAX resnet18_v1 thumbnail: its weights, and three SPMDTrainer
    SGD-momentum steps on one batch."""
    x, y = _batch()
    net, _, _ = _train_forward(_resnet18, x)
    params = _jax_params(net)
    tr = jparallel.SPMDTrainer(net, loss=jloss.SoftmaxCrossEntropyLoss(),
                               optimizer="sgd", optimizer_params=SGD,
                               sharding="replicated")
    xs, ys = jax_arrays([x, y])
    losses = [float(tr.step(xs, ys).asnumpy()) for _ in range(3)]
    return dict(params=params, losses=losses, final=_jax_params(net),
                traces=tr.step_trace_count)


def _port_resnet(params, ctx):
    fresh_names()
    net = _resnet18(tvision)
    net.initialize(ctx=ctx)
    net(mx.nd.array(_batch()[0], ctx=ctx))
    net.load_state_dict(convert.block_params_from_jax(net, params))
    return net


def test_spmd_trainer_steps_equal_jax(jax_train):
    net = _port_resnet(jax_train["params"], mx.cpu())
    tr = SPMDTrainer(net, loss=tloss.SoftmaxCrossEntropyLoss(),
                     optimizer="sgd", optimizer_params=SGD,
                     sharding="replicated")
    xs, ys = port_arrays(list(_batch()))
    losses = [float(tr.step(xs, ys).asnumpy()) for _ in range(3)]
    np.testing.assert_allclose(losses, jax_train["losses"], rtol=2e-4)
    assert losses[-1] < losses[0]
    assert tr.step_trace_count == jax_train["traces"] == 1
    final = jax_train["final"]
    got = net._collect_params_with_prefix()
    assert sum("running_" in k for k in got) == 38
    for name, p in got.items():
        # a BatchNorm beta is a sum with cancellation: after three steps
        # one of 3.3e-4 is 6.7e-6 off float64 in f32
        # (tools/torch_vision_conditioning.py float64)
        assert_close(p.data(), final[name], rtol=1e-3, atol=1e-5,
                     scale_atol=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_zoo_defaults_to_the_card():
    nets = [tvision.resnet18_v1(thumbnail=True, classes=4), models.LeNet()]
    for net in nets:
        if torch.cuda.is_available():
            net.initialize()
            assert all(p.data().context == mx.gpu(0) for p in
                       net._collect_params_with_prefix().values()
                       if p._data is not None)
        else:
            with pytest.raises(MXNetError, match="no CUDA device"):
                net.initialize()


@pytest.mark.cuda
def test_resnet_replay_equals_eager_body(cuda, jax_train):
    from test_torch_train_graphs import _eager_step, _state
    x, y = (torch.tensor(a, device="cuda") for a in _batch())
    trs = []
    for _ in range(2):
        net = _port_resnet(jax_train["params"], mx.gpu(0))
        trs.append(SPMDTrainer(net, loss=tloss.SoftmaxCrossEntropyLoss(),
                               optimizer="sgd", optimizer_params=SGD))
    tr, ref = trs
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for i in range(3):
            got = tr.step(x, y)._data
            want = _eager_step(ref, [x, y])
            assert torch.equal(got, want), (i, float(got), float(want))
            assert all(torch.equal(a, b)
                       for a, b in zip(_state(tr), _state(ref))), i
            assert all(torch.equal(a, b) for a, b in
                       zip(tr._buffers, ref._buffers)), i
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert tr.step_trace_count == 1
    assert next(iter(tr._programs.values())).replays == 2
