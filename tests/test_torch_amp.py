"""The port's ``amp`` against the JAX package's on the CPU.

  - ``LossScaler.has_overflow`` on the same numpy gradients, for the
    three kinds of input it takes: ``NDArray``s, gluon ``Parameter``s
    after a backward (one of them with ``grad_req='null'``, which has no
    gradient and is skipped), and ``torch.nn.Parameter``s
    (``SPMDTrainer``'s), each finite and non-finite;
  - ``amp.init``: the port of ``tests/test_infra.py``'s
    ``test_amp_autocast_and_loss_scaler``; the op lists equal the JAX
    lists op for op and every entry is registered; the wraps' output
    dtypes on mixed inputs equal the JAX ones (values within bf16 / f16
    rounding, rtol 2e-2); gluon ``Conv2D`` and ``Dense`` compute in bf16
    through the wrap (bitwise the plain ops on bf16-cast inputs);
    ``_deinit_for_tests`` restores every ``OpSpec.fn``;
  - ``init_trainer``: scale 1 for bfloat16, 2^16 for float16, a warning
    on a Trainer without the fused guard; with float16 a batch holding an
    inf skips its step (weights bitwise kept) and halves the scale, the
    clean steps apply, step for step as the JAX trainer on the same
    weights and batches (weights and losses within f16 rounding, 1e-2).
"""

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


# --------------------------------------------------------------------- #
# amp.init and the MXNet 1.x loop
# --------------------------------------------------------------------- #
from incubator_mxnet_tpu import autograd as jag  # noqa: E402
from incubator_mxnet_tpu import gluon as jgluon  # noqa: E402
from incubator_mxnet_tpu import nd as jnd  # noqa: E402
from incubator_mxnet_tpu.amp import lists as jlists  # noqa: E402

from incubator_mxnet_tpu_torch import autograd as tag  # noqa: E402
from incubator_mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from incubator_mxnet_tpu_torch import nd as tnd  # noqa: E402
from incubator_mxnet_tpu_torch.amp import lists as tlists  # noqa: E402
from incubator_mxnet_tpu_torch.ops import registry as treg  # noqa: E402

from test_torch_parity import copy_params, host  # noqa: E402


@pytest.fixture
def amp_of():
    """Calls ``amp.init(dtype)`` of both packages; undone after the
    test, every ``OpSpec.fn`` restored."""
    def init(dtype):
        jmx.amp.init(dtype)
        mx.amp.init(dtype)

    originals = {n: treg.get(n).fn for n in treg.list_all_ops()}
    try:
        yield init
    finally:
        jmx.amp._deinit_for_tests()
        mx.amp._deinit_for_tests()
    assert {n: treg.get(n).fn for n in treg.list_all_ops()} == originals


def test_amp_autocast_and_loss_scaler(amp_of):
    """The port of tests/test_infra.py's test of the same name."""
    amp_of("bfloat16")
    with mx.cpu():
        out = tnd.dot(tnd.ones((4, 8)), tnd.ones((8, 4)))
        assert out.dtype == np.float32
        assert np.allclose(out.asnumpy(), 8.0)
        sm = tnd.softmax(tnd.ones((2, 3), dtype="bfloat16"))
        assert str(sm.dtype) == "bfloat16"
        net = tgluon.nn.Dense(4, in_units=8)
        net.initialize()
        trainer = tgluon.Trainer(net.collect_params(), "sgd",
                                 {"learning_rate": 0.1})
        mx.amp.init_trainer(trainer)
        with tag.record():
            loss = net(tnd.ones((2, 8))).sum()
            with mx.amp.scale_loss(loss, trainer) as scaled:
                scaled.backward()
        assert not mx.amp.unscale(trainer)
        trainer.step(2)


def test_lists_equal_jax_and_are_registered():
    for name in ("TARGET_DTYPE_OPS", "FP32_OPS", "WIDEST_TYPE_CASTS"):
        assert getattr(tlists, name) == getattr(jlists, name)
        for op in getattr(tlists, name):
            assert treg.exists(op), op
    assert set(mx.amp.__all__) >= {"init", "init_trainer", "scale_loss",
                                   "unscale", "convert_model",
                                   "convert_hybrid_block", "LossScaler"}


def _a(shape, dtype, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32), \
        dtype


def _make(P, specs, **place):
    return [P.array(a, dtype="float32", **place).astype(d)
            for a, d in specs]


@pytest.mark.parametrize("op,specs", [
    ("dot", [_a((3, 4), "float32"), _a((4, 2), "bfloat16", 1)]),
    ("dot", [_a((3, 4), "bfloat16"), _a((4, 2), "float16", 1)]),
    ("dot", [_a((3, 4), "float16"), _a((4, 2), "bfloat16", 1)]),
    ("batch_dot", [_a((2, 3, 4), "float32"), _a((2, 4, 2), "float32", 1)]),
    ("softmax", [_a((2, 5), "bfloat16")]),
    ("exp", [_a((2, 5), "float16")]),
    ("sum", [_a((2, 5), "float32")]),
    ("log2", [_a((2, 5), "bfloat16")])])
def test_wrapped_dtypes_equal_jax(amp_of, op, specs):
    """The output dtype the wraps give on mixed inputs (the widest rule:
    the input that promotes to another type sets it), and the values."""
    amp_of("bfloat16")
    if op == "log2":
        specs = [(np.abs(specs[0][0]) + 0.1, specs[0][1])]
    want = getattr(jnd, op)(*_make(jnd, specs))
    got = getattr(tnd, op)(*_make(tnd, specs, ctx=mx.cpu()))
    assert str(got.dtype) == str(want.dtype)
    np.testing.assert_allclose(host(got), host(want), rtol=2e-2,
                               atol=2e-2 * np.abs(host(want)).max())


def test_gluon_dense_and_conv2d_run_through_the_wrap(amp_of):
    """Under amp.init("bfloat16") gluon's Dense and Conv2D compute in
    bf16 and return f32: bitwise the unwrapped op on bf16-cast inputs,
    and within bf16 rounding of the JAX layers with the same weights."""
    nets = {}
    for P, gl in (("jax", jgluon), ("port", tgluon)):
        net = gl.nn.HybridSequential()
        net.add(gl.nn.Conv2D(4, 3, in_channels=2),
                gl.nn.Dense(3, in_units=4 * 3 * 3))
        if P == "port":
            with mx.cpu():
                net.initialize()
        else:
            net.initialize()
        nets[P] = net
    copy_params(nets["jax"], nets["port"])
    x = np.random.RandomState(2).randn(2, 2, 5, 5).astype(np.float32)
    amp_of("bfloat16")
    want = nets["jax"](jnd.array(x))
    with mx.cpu():
        got = nets["port"](tnd.array(x))
    assert str(got.dtype) == "float32"
    np.testing.assert_allclose(host(got), host(want), rtol=2e-2,
                               atol=2e-2 * np.abs(host(want)).max())
    conv, dense = nets["port"][0], nets["port"][1]
    with torch.no_grad():
        bf = [torch.from_numpy(x).bfloat16()] + [
            p.data()._data.bfloat16()
            for p in conv.collect_params().values()]
        y = torch.nn.functional.conv2d(bf[0], bf[1], bf[2]).float()
        z = torch.nn.functional.linear(
            y.reshape(2, -1).bfloat16(),
            *[p.data()._data.bfloat16()
              for p in dense.collect_params().values()]).float()
    np.testing.assert_array_equal(host(got), z.numpy())


@pytest.mark.parametrize("dtype,scale", [("bfloat16", 1.0),
                                         ("float16", 2.0 ** 16)])
def test_init_trainer_scale_and_guard_warning(amp_of, dtype, scale):
    amp_of(dtype)
    with mx.cpu():
        net = tgluon.nn.Dense(2, in_units=3)
        net.initialize()
        tr = tgluon.Trainer(net.collect_params(), "sgd")
        mx.amp.init_trainer(tr)
        assert tr.loss_scaler.loss_scale == scale
        bare = tgluon.Trainer(net.collect_params(), "sgd", fuse_step=False)
        with pytest.warns(UserWarning, match="guard"):
            mx.amp.init_trainer(bare)
    jnet = jgluon.nn.Dense(2, in_units=3)
    jnet.initialize()
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd")
    jmx.amp.init_trainer(jtr)
    assert jtr._amp_loss_scaler.loss_scale == scale


def test_float16_overflow_skips_and_halves_as_jax(amp_of):
    """amp.init("float16"): a batch with an inf skips the step (weights
    and momentum bitwise kept) and halves the scale, the clean steps
    apply; weights, losses and scales step for step the JAX trainer's."""
    rng = np.random.RandomState(5)
    batches = [rng.randn(4, 8).astype(np.float32) for _ in range(3)]
    batches[1][0, 0] = np.inf
    jnet, tnet = _pair()
    amp_of("float16")
    out = {}
    for tag_, net, P in (("jax", jnet, JAX), ("port", tnet, PORT)):
        amp = jmx.amp if tag_ == "jax" else mx.amp
        with P.ctx():
            tr = P.gluon.Trainer(net.collect_params(), "sgd",
                                 {"learning_rate": 0.1, "momentum": 0.9})
            amp.init_trainer(tr)
            rows = []
            for b in batches:
                x = P.nd.array(b)
                with P.ag.record():
                    loss = (net(x) ** 2).mean()
                    with amp.scale_loss(loss, tr) as scaled:
                        scaled.backward()
                before = [host(p.data()) for p in
                          net.collect_params().values()]
                tr.step(4)
                after = [host(p.data()) for p in
                         net.collect_params().values()]
                rows.append((float(host(loss)), tr.loss_scaler.loss_scale
                             if hasattr(tr, "loss_scaler")
                             else tr._amp_loss_scaler.loss_scale,
                             before, after))
        out[tag_] = rows
    for (jl, js, _, ja), (tl, ts, tb, ta) in zip(out["jax"], out["port"]):
        assert ts == js
        np.testing.assert_allclose(tl, jl, rtol=1e-2)
        for a, b in zip(ta, ja):
            np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-3)
    scales = [r[1] for r in out["port"]]
    assert scales == [2.0 ** 16, 2.0 ** 15, 2.0 ** 15]
    skipped = out["port"][1]
    for b, a in zip(skipped[2], skipped[3]):
        np.testing.assert_array_equal(a, b)
