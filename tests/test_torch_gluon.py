"""The port's gluon (``Parameter``, ``Block`` / ``HybridBlock`` as
``torch.nn.Module``s, ``nn``, ``loss``) and initializers against the JAX
package's, on the CPU.

  - ``collect_params()`` keys and the structural names
    (``_collect_params_with_prefix``) equal the JAX block's, in a fresh
    naming scope, for Dense, HybridSequential and bert_tiny; the port's
    ``state_dict()`` keys are the structural names;
  - a deferred shape is torch's ``UninitializedParameter`` until the
    first forward completes it, as the JAX Parameter's deferred init;
  - every ported layer and loss equals the JAX one with the JAX block's
    parameters copied across: the output and the input's gradient at
    rtol 1e-5 (f32: the two packages sum in different orders), a
    BatchNorm's running statistics after a training forward likewise;
  - ``len(block._cached_op._cache)`` after calls at two batch shapes and
    in both training modes equals the JAX block's;
  - a ``save_parameters`` file written by either package, in either
    format, loads in the other bitwise (and a loaded parameter keeps its
    storage);
  - the initializers: the deterministic ones equal the JAX ones exactly,
    the random ones have the JAX distributions' support and moments, and
    the registry, ``Mixed``, ``Load`` and an ``InitDesc`` override work as
    the JAX package's;
  - the Block surface: ``cast``, hooks, ``summary``, ``apply``, name
    scopes, ``zero_grad``, ``set_data`` in place, ``Constant``,
    ``ParameterDict``, and the refusals (``SymbolBlock``, ``export``,
    ``optimize_for``, sparse storage, a CTCLoss layout other than NTC /
    TNC);
  - gluon ``CTCLoss`` (NTC and TNC, with and without lengths, an
    impossible alignment among the rows) and its input gradient equal the
    JAX loss's.
"""


import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import initializer as jinit
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.models import bert as jb

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd as tag
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import initializer as tinit
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch.base import (DeferredInitializationError,
                                            MXNetError)
from incubator_mxnet_tpu_torch.models import bert as tb

from test_torch_parity import (assert_close, build_pair, fresh_names, host,
                               jax_arrays, port_arrays)


def _both(make):
    """The same construction in both packages, each in a fresh naming
    scope."""
    fresh_names()
    j = make(jgluon, jb)
    fresh_names()
    t = make(tgluon, tb)
    return j, t


def _mlp(g, _):
    net = g.nn.HybridSequential()
    with net.name_scope():
        net.add(g.nn.Dense(8, activation="relu"), g.nn.Dense(3))
    return net


def _bert(_, b):
    return b.BERTForPretraining(b.bert_tiny(vocab_size=32, max_length=8))


@pytest.mark.parametrize("make", [lambda g, _: g.nn.Dense(4, in_units=3),
                                  _mlp, _bert],
                         ids=["dense", "hybridsequential", "bert_tiny"])
def test_parameter_names_equal_jax(make):
    jblk, tblk = _both(make)
    assert list(tblk.collect_params().keys()) == \
        list(jblk.collect_params().keys())
    assert list(tblk._collect_params_with_prefix()) == \
        list(jblk._collect_params_with_prefix())
    assert [n for n, _ in tblk.named_parameters()] == \
        list(tblk._collect_params_with_prefix())
    assert isinstance(tblk, torch.nn.Module)
    assert tblk.name == jblk.name and tblk.prefix == jblk.prefix


def test_deferred_init_completes_at_first_forward():
    with mx.cpu():
        net = tgluon.nn.Dense(4)
        net.initialize()
        assert isinstance(net.weight._var, torch.nn.UninitializedParameter)
        assert net.weight.shape == (4, 0)
        with pytest.raises(DeferredInitializationError):
            net.weight.data()
        var = net.weight._var
        net(tnd.ones((2, 7)))
        assert net.weight.shape == (4, 7)
        assert net.weight._var is var and \
            not isinstance(var, torch.nn.UninitializedParameter)
        assert tuple(net.weight.data().shape) == (4, 7)
        assert [n for n, _ in net.named_parameters()] == ["weight", "bias"]
    jnet = jgluon.nn.Dense(4)
    jnet.initialize()
    jnet(jnd.ones((2, 7)))
    assert jnet.weight.shape == net.weight.shape


# --------------------------------------------------------------------- #
# layers and losses
# --------------------------------------------------------------------- #
RS = np.random.RandomState


def _x(*shape, seed=0):
    return RS(seed).randn(*shape).astype(np.float32)


LAYERS = {
    "Dense": (lambda g: g.nn.Dense(5, activation="tanh"), [_x(3, 2, 4)]),
    "Dense-noflat": (lambda g: g.nn.Dense(5, flatten=False, use_bias=False),
                     [_x(3, 2, 4)]),
    "Dropout": (lambda g: g.nn.Dropout(0.5), [_x(3, 4)]),
    "Embedding": (lambda g: g.nn.Embedding(10, 4),
                  [RS(1).randint(0, 10, (3, 5)).astype(np.float32)]),
    "BatchNorm": (lambda g: g.nn.BatchNorm(), [_x(4, 3, 5)]),
    "BatchNorm-noscale": (lambda g: g.nn.BatchNorm(axis=-1, scale=False,
                                                   momentum=0.7),
                          [_x(6, 3)]),
    "LayerNorm": (lambda g: g.nn.LayerNorm(), [_x(3, 6)]),
    "InstanceNorm": (lambda g: g.nn.InstanceNorm(), [_x(2, 3, 5)]),
    "GroupNorm": (lambda g: g.nn.GroupNorm(num_groups=2),
                  [_x(2, 4, 3)]),
    "Flatten": (lambda g: g.nn.Flatten(), [_x(2, 3, 4)]),
    "Identity": (lambda g: g.nn.Identity(), [_x(2, 3)]),
    "HybridLambda": (lambda g: g.nn.HybridLambda(
        lambda F, x: F.relu(x) * 2.0), [_x(2, 3)]),
    "HybridLambda-name": (lambda g: g.nn.HybridLambda("tanh"), [_x(2, 3)]),
    "Lambda": (lambda g: g.nn.Lambda("sigmoid"), [_x(2, 3)]),
    "Activation": (lambda g: g.nn.Activation("softrelu"), [_x(2, 3)]),
    "LeakyReLU": (lambda g: g.nn.LeakyReLU(0.2), [_x(2, 3)]),
    "PReLU": (lambda g: g.nn.PReLU(in_channels=3), [_x(2, 3, 4)]),
    "ELU": (lambda g: g.nn.ELU(0.7), [_x(2, 3)]),
    "SELU": (lambda g: g.nn.SELU(), [_x(2, 3)]),
    "GELU": (lambda g: g.nn.GELU(), [_x(2, 3)]),
    "Swish": (lambda g: g.nn.Swish(1.5), [_x(2, 3)]),
    "Sequential": (lambda g: _seq(g, g.nn.Sequential), [_x(3, 4)]),
    "HybridSequential": (lambda g: _seq(g, g.nn.HybridSequential),
                         [_x(3, 4)]),
}


def _seq(g, cls):
    net = cls()
    with net.name_scope():
        net.add(g.nn.Dense(6, activation="relu"), g.nn.LayerNorm(),
                g.nn.Dense(2))
    return net


@pytest.mark.parametrize("name", sorted(LAYERS))
@pytest.mark.parametrize("training", [False, True], ids=["predict", "train"])
def test_layer_equals_jax(name, training):
    make, inputs = LAYERS[name]
    jblk, tblk = build_pair(lambda: make(jgluon), lambda: make(tgluon),
                            inputs=inputs)
    jx, tx = jax_arrays(inputs), port_arrays(inputs)
    differentiable = inputs[0].dtype == np.float32 and name != "Embedding"
    for x in (jx + tx) if differentiable else ():
        x.attach_grad()
    if name == "Dropout" and training:
        # the masks come from different generators: the statistics agree
        with tag.record():
            out = tblk(*tx)
        kept = out.asnumpy() != 0
        np.testing.assert_allclose(out.asnumpy()[kept],
                                   inputs[0][kept] * 2.0, rtol=1e-6)
        assert 0.3 < kept.mean() < 0.7
        return
    with jag.record(train_mode=training):
        jy = jblk(*jx)
        # a random projection: sum(y^2) of a normalized y is a constant
        r = RS(9).randn(*jy.shape).astype(np.float32)
        jl = (jy * jnd.array(r)).sum()
    jl.backward()
    with tag.record(train_mode=training):
        ty = tblk(*tx)
        tl = (ty * tnd.array(r, ctx=mx.cpu())).sum()
    tl.backward()
    assert_close(ty, jy, rtol=1e-5, scale_atol=1e-6)
    if differentiable:
        assert_close(tx[0].grad, jx[0].grad, rtol=1e-5, scale_atol=1e-6)
    jp = jblk._collect_params_with_prefix()
    for name_, p in tblk._collect_params_with_prefix().items():
        assert_close(p.data(), jp[name_].data(), rtol=1e-5,
                     scale_atol=1e-7)


def _labels(n, k, seed=3):
    return RS(seed).randint(0, k, (n,)).astype(np.float32)


def _signs(*shape):
    return np.sign(RS(4).randn(*shape)).astype(np.float32)


def _probs(*shape):
    return (1.0 / (1.0 + np.exp(-_x(*shape, seed=5)))).astype(np.float32)


LOSSES = {
    "L2Loss": (lambda L: L.L2Loss(), [_x(4, 3), _x(4, 3, seed=1)]),
    "L1Loss": (lambda L: L.L1Loss(weight=0.5), [_x(4, 3), _x(4, 3, seed=1)]),
    "SoftmaxCE": (lambda L: L.SoftmaxCrossEntropyLoss(),
                  [_x(4, 5), _labels(4, 5)]),
    "SoftmaxCE-dense": (lambda L: L.SoftmaxCELoss(sparse_label=False),
                        [_x(4, 5), _probs(4, 5)]),
    "SoftmaxCE-logits": (lambda L: L.SoftmaxCrossEntropyLoss(
        from_logits=True, weight=2.0), [_x(4, 5), _labels(4, 5)]),
    "SoftmaxCE-weighted": (lambda L: L.SoftmaxCrossEntropyLoss(),
                           [_x(4, 5), _labels(4, 5), _probs(4, 1)]),
    "SigmoidBCE": (lambda L: L.SigmoidBinaryCrossEntropyLoss(),
                   [_x(4, 3), _probs(4, 3)]),
    "SigmoidBCE-sigmoid": (lambda L: L.SigmoidBCELoss(from_sigmoid=True),
                           [_probs(4, 3), _probs(4, 3)]),
    "KLDivLoss": (lambda L: L.KLDivLoss(from_logits=False),
                  [_x(4, 5), _probs(4, 5)]),
    "HuberLoss": (lambda L: L.HuberLoss(rho=0.5),
                  [_x(4, 3), _x(4, 3, seed=1)]),
    "HingeLoss": (lambda L: L.HingeLoss(), [_x(4, 3), _signs(4, 3)]),
    "SquaredHingeLoss": (lambda L: L.SquaredHingeLoss(margin=0.5),
                         [_x(4, 3), _signs(4, 3)]),
    "LogisticLoss": (lambda L: L.LogisticLoss(), [_x(4, 3), _signs(4, 3)]),
    "LogisticLoss-binary": (lambda L: L.LogisticLoss(label_format="binary"),
                            [_x(4, 3), (_signs(4, 3) > 0)
                             .astype(np.float32)]),
    "TripletLoss": (lambda L: L.TripletLoss(margin=0.3),
                    [_x(4, 3), _x(4, 3, seed=1), _x(4, 3, seed=2)]),
    "CosineEmbeddingLoss": (lambda L: L.CosineEmbeddingLoss(margin=0.1),
                            [_x(4, 3), _x(4, 3, seed=1), _signs(4)]),
    "PoissonNLLLoss": (lambda L: L.PoissonNLLLoss(compute_full=True),
                       [_x(4, 3), np.abs(_x(4, 3, seed=1)) * 3]),
    "PoissonNLLLoss-rate": (lambda L: L.PoissonNLLLoss(from_logits=False),
                            [np.abs(_x(4, 3)) + 0.1,
                             np.abs(_x(4, 3, seed=1))]),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_equals_jax(name):
    make, inputs = LOSSES[name]
    jl, tl = make(jgluon.loss), make(tgluon.loss)
    jx, tx = jax_arrays(inputs), port_arrays(inputs)
    jx[0].attach_grad()
    tx[0].attach_grad()
    with jag.record():
        jy = jl(*jx)
    jy.backward()
    with tag.record():
        ty = tl(*tx)
    ty.backward()
    assert_close(ty, jy, rtol=1e-5, scale_atol=1e-6)
    assert_close(tx[0].grad, jx[0].grad, rtol=1e-5, scale_atol=1e-6)


def test_ctc_loss_is_refused():
    """CTCLoss refuses a layout other than NTC / TNC, as the JAX loss
    does; the default builds."""
    for L in (jgluon.loss, tgluon.loss):
        with pytest.raises(Exception, match="layout"):
            L.CTCLoss(layout="NCT")
    assert isinstance(tgluon.loss.CTCLoss(), tgluon.loss.Loss)


def _ctc_case(layout, lengths):
    """(B=3, T=6, C=5) activations; label rows padded with -1, the middle
    one impossible (four repeats of one class need 7 frames)."""
    B, T, C = 3, 6, 5
    x = _x(B, T, C, seed=7)
    if layout == "TNC":
        x = np.ascontiguousarray(x.transpose(1, 0, 2))
    label = np.array([[1, 2, -1, -1], [3, 3, 3, 3], [0, 2, 1, -1]],
                     np.float32)
    if not lengths:
        return [x, label]
    return [x, label, np.array([6, 6, 5], np.float32),
            np.array([2, 4, 3], np.float32)]


@pytest.mark.parametrize("layout,lengths", [("NTC", False), ("TNC", True)])
def test_ctc_loss_equals_jax(layout, lengths):
    """gluon CTCLoss (blank last) against the JAX loss, loss and input
    gradient, with and without lengths; the impossible alignment holds
    the JAX recursion's large finite loss."""
    inputs = _ctc_case(layout, lengths)
    jl = jgluon.loss.CTCLoss(layout=layout)
    tl = tgluon.loss.CTCLoss(layout=layout)
    jx, tx = jax_arrays(inputs), port_arrays(inputs)
    jx[0].attach_grad()
    tx[0].attach_grad()
    with jag.record():
        jy = jl(*jx)
    jy.backward()
    with tag.record():
        ty = tl(*tx)
    ty.backward()
    assert np.isfinite(host(ty)).all() and host(ty).max() > 1e29
    assert_close(ty, jy, rtol=1e-5, scale_atol=1e-6)
    assert_close(tx[0].grad, jx[0].grad, rtol=1e-4, scale_atol=1e-5)


# --------------------------------------------------------------------- #
# hybridize's cache
# --------------------------------------------------------------------- #

def test_cached_op_signature_count_equals_jax():
    x1, x2 = _x(4, 6), _x(7, 6, seed=1)
    jnet, tnet = build_pair(lambda: _seq(jgluon, jgluon.nn.HybridSequential),
                            lambda: _seq(tgluon, tgluon.nn.HybridSequential),
                            inputs=[x1])
    counts = []
    for net, arrays in ((jnet, jax_arrays), (tnet, port_arrays)):
        net.hybridize()
        seen = []
        for x, train in ((x1, False), (x1, False), (x2, False), (x1, True),
                         (x2, True), (x2, False)):
            with (jag if net is jnet else tag).record(train_mode=train):
                net(*arrays([x]))
            seen.append(len(net._cached_op._cache))
        counts.append(seen)
    assert counts[0] == counts[1] == [1, 1, 2, 3, 4, 4]
    out = tnet(*port_arrays([x1]))
    tnet.hybridize(active=False)
    assert tnet._cached_op is None
    np.testing.assert_array_equal(tnet(*port_arrays([x1])).asnumpy(),
                                  out.asnumpy())


# --------------------------------------------------------------------- #
# parameter files across the packages
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("fmt", ["mxtpu", "mxnet"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_parameters_crosses_packages(tmp_path, fmt, writer):
    x = _x(3, 4)
    jnet, tnet = build_pair(lambda: _seq(jgluon, jgluon.nn.HybridSequential),
                            lambda: _seq(tgluon, tgluon.nn.HybridSequential),
                            inputs=[x])
    path = str(tmp_path / f"net.{fmt}")
    if writer == "jax":
        jnet.save_parameters(path, format=fmt)
        src = {k: p.data().asnumpy()
               for k, p in jnet._collect_params_with_prefix().items()}
        with mx.cpu():
            fresh = _seq(tgluon, tgluon.nn.HybridSequential)
            fresh.initialize()
            fresh(tnd.ones((1, 4)))
            where = [p.data()._data.data_ptr()
                     for p in fresh.collect_params().values()]
            fresh.load_parameters(path)
            assert where == [p.data()._data.data_ptr()
                             for p in fresh.collect_params().values()]
            got = {k: p.data().asnumpy()
                   for k, p in fresh._collect_params_with_prefix().items()}
    else:
        with torch.no_grad():
            for p in tnet.parameters():
                p.add_(0.25)                   # differ from the JAX net
        tnet.save_parameters(path, format=fmt)
        src = {k: p.data().asnumpy()
               for k, p in tnet._collect_params_with_prefix().items()}
        fresh = _seq(jgluon, jgluon.nn.HybridSequential)
        fresh.load_parameters(path)
        got = {k: p.data().asnumpy()
               for k, p in fresh._collect_params_with_prefix().items()}
    assert sorted(got) == sorted(src)
    for k in src:
        np.testing.assert_array_equal(got[k], src[k], err_msg=k)


def test_nd_save_load_cross_packages_bf16_and_int(tmp_path):
    arrays = {"w": _x(3, 5), "i": np.arange(6, dtype=np.int32)}
    for fmt in ("mxtpu", "mxnet"):
        p1, p2 = str(tmp_path / f"a.{fmt}"), str(tmp_path / f"b.{fmt}")
        with mx.cpu():
            tnd.save(p1, {"w": tnd.array(arrays["w"]).astype("bfloat16"),
                          "i": tnd.array(arrays["i"], dtype="int32")},
                     format=fmt)
        jnd.save(p2, {"w": jnd.array(arrays["w"]).astype("bfloat16"),
                      "i": jnd.array(arrays["i"], dtype="int32")},
                 format=fmt)
        j, t = jnd.load(p1), tnd.load(p2, ctx=mx.cpu())
        for k in arrays:
            assert str(j[k].dtype) == str(t[k].dtype)
            np.testing.assert_array_equal(
                j[k].asnumpy().astype(np.float32),
                t[k].asnumpy().astype(np.float32))
        with open(p1, "rb") as a, open(p2, "rb") as b:
            assert a.read() == b.read()
    with mx.cpu():
        tnd.save(str(tmp_path / "l"), [tnd.ones((2,)), tnd.zeros((3,))])
        assert [x.shape for x in tnd.load(str(tmp_path / "l"))] == \
            [(2,), (3,)]
    with open(tmp_path / "junk", "wb") as f:
        f.write(b"not a params file")
    with pytest.raises(MXNetError, match="neither"):
        tnd.load(str(tmp_path / "junk"), ctx=mx.cpu())


# --------------------------------------------------------------------- #
# initializers
# --------------------------------------------------------------------- #

def _init_pair(init_j, init_t, name, shape):
    jarr = jnd.zeros(shape)
    init_j(name, jarr)
    with mx.cpu():
        tarr = tnd.zeros(shape)
    init_t(name, tarr)
    return jarr.asnumpy(), tarr.asnumpy()


@pytest.mark.parametrize("name,args,shape,pname", [
    ("Zero", (), (3, 4), "w_weight"), ("One", (), (3, 4), "w_weight"),
    ("Constant", (0.7,), (3, 4), "w_weight"),
    ("Bilinear", (), (2, 1, 4, 4), "up_weight"),
    ("LSTMBias", (2.0,), (12,), "lstm_i2h_bias"),
    ("LSTMBias", (2.0,), (12,), "lstm_i2h_init"),
    ("Uniform", (0.3,), (5,), "x_bias"), ("Normal", (), (4,), "x_gamma"),
    ("Xavier", (), (4,), "bn_running_mean"),
    ("Xavier", (), (4,), "bn_running_var")])
def test_deterministic_initializers_equal_jax(name, args, shape, pname):
    j, t = _init_pair(getattr(jinit, name)(*args),
                      getattr(tinit, name)(*args), pname, shape)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("make,check", [
    (lambda m: m.Uniform(0.2), lambda a: (a.min() >= -0.2) &
     (a.max() <= 0.2) & (abs(a.std() - 0.2 / 3 ** 0.5) < 0.01)),
    (lambda m: m.Normal(0.05), lambda a: abs(a.std() - 0.05) < 0.003),
    (lambda m: m.Xavier(), lambda a: np.abs(a).max() <= (3 / 40) ** 0.5),
    (lambda m: m.Xavier(rnd_type="gaussian", factor_type="in",
                        magnitude=2), lambda a: abs(a.std() - (2 / 48) ** 0.5) < 0.02),
    (lambda m: m.MSRAPrelu(), lambda a: abs(
        a.std() - (2 / 1.0625 / 40) ** 0.5) < 0.02),
    (lambda m: m.TruncNorm(stdev=0.02), lambda a: (np.abs(a).max() <= 0.04)
     & (abs(a.std() - 0.0176) < 0.002)),
], ids=["uniform", "normal", "xavier", "xavier-gauss", "msraprelu",
        "truncnorm"])
def test_random_initializers_match_jax_distributions(make, check):
    j, t = _init_pair(make(jinit), make(tinit), "fc_weight", (32, 48))
    assert check(j) and check(t)


def test_orthogonal_and_registry_and_mixed_and_load(tmp_path):
    _, t = _init_pair(jinit.Orthogonal(scale=1.0), tinit.Orthogonal(
        scale=1.0), "q_weight", (4, 6))
    np.testing.assert_allclose(t @ t.T, np.eye(4), atol=1e-5)
    for name in ("xavier", "uniform", "normal", "zeros", "one", "constant",
                 "msraprelu", "orthogonal", "bilinear", "lstmbias",
                 "truncnorm"):
        assert type(tinit.create(name)).__name__ == \
            type(jinit.create(name)).__name__
    with pytest.raises(MXNetError, match="not registered"):
        tinit.create("nope")
    mixed = (jinit.Mixed([".*bias", ".*"], [jinit.Constant(3.0),
                                            jinit.One()]),
             tinit.Mixed([".*bias", ".*"], [tinit.Constant(3.0),
                                            tinit.One()]))
    for pname in ("fc_bias", "fc_weight"):
        j, t = _init_pair(*mixed, pname, (2, 2))
        np.testing.assert_array_equal(t, j)
    with mx.cpu(), pytest.raises(MXNetError, match="did not match"):
        tinit.Mixed(["a"], [tinit.One()])("zz", tnd.zeros((2,)))
    desc = tinit.InitDesc("fc_weight", attrs={"__init__": "one"})
    with mx.cpu():
        arr = tnd.zeros((2, 2))
    tinit.Uniform()(desc, arr)
    assert arr.asnumpy().tolist() == [[1.0, 1.0], [1.0, 1.0]]
    path = str(tmp_path / "saved")
    with mx.cpu():
        tnd.save(path, {"arg:fc_weight": tnd.full((2, 2), 5.0)})
        load = tinit.Load(path, default_init=tinit.Zero())
        a, b = tnd.ones((2, 2)), tnd.ones((2,))
        load("fc_weight", a)
        load("fc_bias", b)
        assert a.asnumpy().tolist() == [[5.0, 5.0], [5.0, 5.0]]
        assert b.asnumpy().tolist() == [0.0, 0.0]
        with pytest.raises(MXNetError, match="shape mismatch"):
            load("fc_weight", tnd.ones((3,)))


# --------------------------------------------------------------------- #
# the Block surface
# --------------------------------------------------------------------- #

def test_block_surface(capsys):
    with mx.cpu():
        mx.random.seed(0)
        net = _seq(tgluon, tgluon.nn.HybridSequential)
        net.initialize()
        x = tnd.array(_x(2, 4))
        net(x)
        seen = []
        net.register_forward_pre_hook(lambda b, a: seen.append("pre"))
        net.register_forward_hook(lambda b, a, o: seen.append(o.shape))
        net(x)
        assert seen == ["pre", (2, 2)]
        net.summary(x)
        assert "Layer" in capsys.readouterr().out
        kinds = []
        net.apply(lambda b: kinds.append(type(b).__name__))
        assert kinds[-1] == "HybridSequential" and "Dense" in kinds
        assert list(net.collect_params(".*weight").keys()) == [
            k for k in net.collect_params().keys() if k.endswith("weight")]
        net.cast("bfloat16")
        assert {p.dtype for p in net.parameters()} == {torch.bfloat16}
        assert net(x.astype("bfloat16")).dtype.name == "bfloat16"
        p = net[0].weight
        where = p.data()._data.data_ptr()
        p.set_data(np.ones(p.shape, np.float32))
        assert p.data()._data.data_ptr() == where
        assert float(p.data().asnumpy().mean()) == 1.0
        with tag.record():
            net(x.astype("bfloat16")).sum().backward()
        assert float(np.abs(p.grad().asnumpy().astype(np.float32)).sum()) > 0
        net.collect_params().zero_grad()
        assert float(np.abs(p.grad().asnumpy().astype(np.float32)).sum()) \
            == 0
        p.grad_req = "null"
        assert not p._var.requires_grad and p._grad is None
        c = tgluon.Constant("const", [[1.0, 2.0]])
        c.initialize()
        assert c.data().asnumpy().tolist() == [[1.0, 2.0]] and \
            c.grad_req == "null"
        pd = tgluon.ParameterDict("blk_")
        w = pd.get("w", shape=(2,))
        assert pd.get("w") is w and w.name == "blk_w" and "blk_w" in pd
        pd.initialize(init=tinit.One())
        assert w.data().asnumpy().tolist() == [1.0, 1.0]
        with pytest.raises(MXNetError, match="not ported"):
            tgluon.Parameter("s", stype="row_sparse")
        with pytest.raises(MXNetError, match="not ported"):
            tgluon.nn.Embedding(4, 2, sparse_grad=True)
        with pytest.raises(MXNetError, match="symbol"):
            net.export("x")
        with pytest.raises(MXNetError, match="symbol"):
            net.optimize_for(x)
        with pytest.raises(MXNetError, match="symbol"):
            tgluon.SymbolBlock(None, None)
        with pytest.raises(MXNetError, match="cannot infer"):
            class NoInfer(tgluon.HybridBlock):
                def __init__(self):
                    super().__init__()
                    self.w = self.params.get("w", shape=(0,),
                                             allow_deferred_init=True)

                def hybrid_forward(self, F, x, w):
                    return x
            blk = NoInfer()
            blk.initialize()
            blk(x)
