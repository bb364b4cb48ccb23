"""The port's ``Module`` / ``BucketingModule`` against the JAX package's,
on the CPU (the cases of ``tests/test_module.py``; its LibSVM one is in
``tests/test_torch_sparse.py``).

  - ``fit`` on the MLP (``NDArrayIter``, ``shuffle=False``, SGD with
    momentum, 2 epochs of 6 batches from the same initial parameters):
    the per-batch cross-entropy and the final parameters equal the JAX
    ``Module``'s at rtol 1e-5; ``score`` and ``predict`` equal too;
  - input gradients, ``BucketingModule`` over three buckets (outputs and
    the shared parameters after each update), ``allow_missing``, and
    ``set_params`` reaching every bucket;
  - a checkpoint the JAX ``Module`` wrote (``.params`` in the JAX
    package's layout and in MXNet 1.x's, ``.states`` as the capsule)
    loads in the port and resumes with the JAX run's parameters;
  - a resnet18_v1 exported by the JAX package (32 x 32, B=4) reloads in
    the port and binds through ``simple_bind`` and ``Module.bind``: the
    logits equal the JAX executor's over the in-memory ``trace_block``
    graph at 1e-5 (the JAX package cannot bind its reloaded file: ROADMAP
    Known hazards), and ``SymbolBlock.imports`` of the port's own export
    equals the block.
"""

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd as jnd

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon, nd
from incubator_mxnet_tpu_torch.base import MXNetError

from test_torch_parity import assert_close, host
from test_torch_symbol import fresh

RTOL = 1e-5


def mlp_sym(m, num_hidden=16, num_classes=3):
    data = m.sym.Variable("data")
    label = m.sym.Variable("softmax_label")
    h = m.sym.FullyConnected(data, m.sym.Variable("fc1_weight"),
                             m.sym.Variable("fc1_bias"),
                             num_hidden=num_hidden, name="fc1")
    h = m.sym.relu(h)
    o = m.sym.FullyConnected(h, m.sym.Variable("fc2_weight"),
                             m.sym.Variable("fc2_bias"),
                             num_hidden=num_classes, name="fc2")
    return m.sym.SoftmaxOutput(o, label, normalization="batch",
                               name="softmax")


def toy_data(n=96, dim=8, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, dim).astype(np.float32)
    W = rng.randn(dim, classes).astype(np.float32)
    return X, np.argmax(X @ W, axis=1).astype(np.float32)


def toy_iter(m, batch=16, **kw):
    X, y = toy_data(**kw)
    return m.io.NDArrayIter(X, y, batch_size=batch, shuffle=False,
                            label_name="softmax_label")


def init_params(seed=1):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(16, 8).astype(np.float32) * 0.3,
            "fc1_bias": rng.randn(16).astype(np.float32) * 0.1,
            "fc2_weight": rng.randn(3, 16).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(3, np.float32)}


def run_fit(m, arrays, ctx, epochs=2):
    """fit with a per-batch cross-entropy record."""
    losses = []
    metric = m.metric.CrossEntropy()

    def record(param):
        losses.append(param.eval_metric.get()[1])
        param.eval_metric.reset()
    fresh()
    mod = m.mod.Module(mlp_sym(m), context=ctx)
    mod.fit(toy_iter(m), eval_metric=metric, batch_end_callback=record,
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: arrays(v) for k, v in init_params().items()},
            num_epoch=epochs)
    return mod, losses


@pytest.fixture(scope="module")
def fitted():
    jmod, jl = run_fit(jmx, jnd.array, jmx.cpu())
    with mx.cpu():
        tmod, tl = run_fit(mx, lambda v: nd.array(v), mx.cpu())
    return jmod, jl, tmod, tl


def test_fit_matches_jax(fitted):
    jmod, jl, tmod, tl = fitted
    assert len(tl) == len(jl) == 12
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert tl[-1] < 0.5 * tl[0]
    ja, jx = jmod.get_params()
    ta, tx = tmod.get_params()
    assert sorted(ta) == sorted(ja) and not tx and not jx
    for n in ja:
        assert_close(ta[n], ja[n], rtol=RTOL, atol=1e-6)
    # one fused train signature and one training forward never built
    assert tmod._exec.signature_counts() == {
        k: f._cache_size() for k, f in jmod._exec._jit_cache.items()}


def test_score_and_predict_match_jax(fitted):
    jmod, _, tmod, _ = fitted
    with mx.cpu():
        ts = dict(tmod.score(toy_iter(mx), "acc"))
        tp = tmod.predict(toy_iter(mx, batch=20))   # the last batch padded
    js = dict(jmod.score(toy_iter(jmx), "acc"))
    jp = jmod.predict(toy_iter(jmx, batch=20))
    assert ts == pytest.approx(js) and ts["accuracy"] > 0.8
    assert tp.shape == (96, 3)
    assert_close(tp, jp, rtol=RTOL, atol=1e-6)
    assert tmod.output_shapes == [("softmax_output", (16, 3))]


def test_input_grads_match_jax():
    def grads(m, arrays, ctx):
        fresh()
        mod = m.mod.Module(mlp_sym(m), context=ctx)
        it = toy_iter(m)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
                 inputs_need_grad=True)
        mod.init_params(arg_params={k: arrays(v)
                                    for k, v in init_params().items()})
        mod.forward(next(iter(it)), is_train=True)
        mod.backward()
        return mod.get_input_grads()[0]
    with mx.cpu():
        tg = grads(mx, nd.array, mx.cpu())
    jg = grads(jmx, jnd.array, jmx.cpu())
    assert tg.shape == (16, 8) and float(np.abs(host(tg)).sum()) > 0
    assert_close(tg, jg, rtol=RTOL, atol=1e-7)
    mod = mx.mod.Module(mlp_sym(mx), context=mx.cpu())
    with pytest.raises(MXNetError, match="inputs_need_grad"):
        mod.get_input_grads()


def test_bucketing_module_matches_jax():
    def sym_gen(m):
        def gen(seq_len):
            data = m.sym.Variable("data")
            pooled = m.sym.mean(data, axis=1)
            o = m.sym.FullyConnected(pooled, m.sym.Variable("out_weight"),
                                     m.sym.Variable("out_bias"),
                                     num_hidden=2, name="out")
            return m.sym.SoftmaxOutput(o, m.sym.Variable("softmax_label"),
                                       name="softmax"), \
                ("data",), ("softmax_label",)
        return gen

    def run(m, arrays, ctx):
        bm = m.mod.BucketingModule(sym_gen(m), default_bucket_key=8,
                                   context=ctx)
        bm.bind(data_shapes=[("data", (4, 8, 4))],
                label_shapes=[("softmax_label", (4,))])
        rng = np.random.RandomState(5)
        bm.init_params(arg_params={
            "out_weight": arrays(rng.randn(2, 4).astype(np.float32)),
            "out_bias": arrays(np.zeros(2, np.float32))})
        bm.init_optimizer(optimizer="sgd",
                          optimizer_params={"learning_rate": 0.1})
        outs = []
        for seq_len in (8, 5, 8, 3):
            batch = m.io.DataBatch(
                data=[arrays(rng.randn(4, seq_len, 4).astype(np.float32))],
                label=[arrays(rng.randint(0, 2, (4,)).astype(np.float32))],
                bucket_key=seq_len,
                provide_data=[("data", (4, seq_len, 4))],
                provide_label=[("softmax_label", (4,))])
            bm.forward(batch, is_train=True)
            bm.backward()
            bm.update()
            outs.append(host(bm.get_outputs()[0]))
        return bm, outs
    with mx.cpu():
        tb, to = run(mx, nd.array, mx.cpu())
    jb, jo = run(jmx, jnd.array, jmx.cpu())
    assert set(tb._buckets) == set(jb._buckets) == {8, 5, 3}
    np.testing.assert_allclose(to, jo, rtol=RTOL)
    ta, ja = tb.get_params()[0], jb.get_params()[0]
    for n in ja:
        assert_close(ta[n], ja[n], rtol=RTOL)
    # the parameters are shared by reference across buckets
    assert tb._buckets[5]._exec.arg_dict["out_weight"] is \
        tb._buckets[8]._exec.arg_dict["out_weight"]


def test_bucketing_set_params_reaches_existing_buckets():
    def sym_gen(seq_len):
        o = mx.sym.FullyConnected(mx.sym.Variable("data"),
                                  mx.sym.Variable("fc_weight"),
                                  mx.sym.Variable("fc_bias"), num_hidden=3,
                                  name="fc")
        return mx.sym.SoftmaxOutput(o, mx.sym.Variable("softmax_label"),
                                    name="softmax"), ["data"], \
            ["softmax_label"]

    class Batch:
        def __init__(self, key, n):
            self.bucket_key = key
            self.data = [nd.ones((n, 4))]
            self.label = [nd.zeros((n,))]
            self.provide_data = [("data", (n, 4))]
            self.provide_label = [("softmax_label", (n,))]
    with mx.cpu():
        bm = mx.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                    context=mx.cpu())
        bm.bind(data_shapes=[("data", (2, 4))],
                label_shapes=[("softmax_label", (2,))])
        bm.init_params()
        bm.forward(Batch(4, 4), is_train=False)
        before = bm.get_outputs()[0].asnumpy()
        arg, aux = bm.get_params()
        bm.set_params({n: nd.array(np.full(a.shape, 0.3, np.float32))
                       for n, a in arg.items()}, aux)
        bm.forward(Batch(4, 4), is_train=False)
        after = bm.get_outputs()[0].asnumpy()
    assert not np.allclose(before, after)
    np.testing.assert_allclose(after, np.full_like(after, 1 / 3), atol=1e-6)


def test_init_params_allow_missing_enforced():
    with mx.cpu():
        mod = mx.mod.Module(mlp_sym(mx), context=mx.cpu())
        it = toy_iter(mx)
        with pytest.raises(MXNetError, match="bind first"):
            mod.init_params()
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        partial = {"fc1_weight": nd.zeros((16, 8))}
        with pytest.raises(MXNetError, match="allow_missing"):
            mod.init_params(arg_params=partial, allow_missing=False)
        mod.init_params(arg_params=partial, allow_missing=True)
        assert mod.params_initialized
        assert float(np.abs(host(mod.get_params()[0]["fc1_weight"])).sum()) \
            == 0.0
        assert float(np.abs(host(mod.get_params()[0]["fc2_weight"])).sum()) \
            > 0.0
        with pytest.raises(MXNetError, match="shape"):
            mod.set_params({"fc1_weight": nd.zeros((3, 3))})
        with pytest.raises(MXNetError, match="unknown"):
            mod.set_params({"nope": nd.zeros((3, 3))})
        with pytest.raises(MXNetError, match="init_optimizer"):
            mod.update()


@pytest.mark.parametrize("fmt", ["mxtpu", "mxnet"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, fmt):
    """1 epoch in the JAX Module, its checkpoint (``.params`` in ``fmt``,
    ``.states`` the capsule), then 1 more epoch in each package."""
    jmod, _ = run_fit(jmx, jnd.array, jmx.cpu(), epochs=1)
    prefix = str(tmp_path / "ck")
    jmod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    arg, aux = jmod.get_params()
    jmx.model.save_checkpoint(prefix, 1, jmod.symbol, arg, aux, format=fmt)
    jmod.fit(toy_iter(jmx), num_epoch=2, begin_epoch=1)
    with mx.cpu():
        tmod = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                  context=mx.cpu())
        it = toy_iter(mx)
        tmod.fit(it, num_epoch=2, begin_epoch=1, optimizer="sgd",
                 optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    assert tmod._optimizer.num_update == jmod._optimizer.num_update == 12
    ja, ta = jmod.get_params()[0], tmod.get_params()[0]
    for n in ja:
        assert_close(ta[n], ja[n], rtol=RTOL, atol=1e-6)
    # the port's own checkpoint round trip (and the JAX package reads it)
    with mx.cpu():
        tmod.save_checkpoint(str(tmp_path / "pt"), 2,
                             save_optimizer_states=True)
        sym, arg2, _ = mx.model.load_checkpoint(str(tmp_path / "pt"), 2)
    _, jarg, _ = jmx.model.load_checkpoint(str(tmp_path / "pt"), 2)
    for n in ta:
        np.testing.assert_array_equal(host(arg2[n]), host(ta[n]))
        np.testing.assert_array_equal(host(jarg[n]), host(ta[n]))


# --------------------------------------------------------------------- #
# an exported resnet18_v1 across the packages
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def exported_resnet(tmp_path_factory):
    """The JAX resnet18_v1 (the port's random weights, by name), exported
    after one inference forward; the JAX executor over its in-memory
    ``trace_block`` graph and its logits on a seeded batch."""
    from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
    from test_torch_model_zoo import _FromPort
    x = np.random.RandomState(0).rand(4, 3, 32, 32).astype(np.float32)
    mx.random.seed(0)
    fresh()
    with mx.cpu():
        tnet = tvision.resnet18_v1()
        tnet.initialize()
        tnet(nd.array(x[:1]))
    fresh()
    jnet = jvision.resnet18_v1()
    jnet.initialize(_FromPort(tnet))
    jnet.hybridize()
    jnet(jnd.array(x[:1]))
    path = str(tmp_path_factory.mktemp("rn") / "resnet18")
    jnet.export(path)
    jsym, names = jmx.sym.trace_block(jnet)
    params = {p.name: p.data() for p in jnet.collect_params().values()}
    aux = set(jsym.list_auxiliary_states())
    je = jsym.bind(args={**{k: v for k, v in params.items()
                            if k not in aux}, "data": jnd.array(x)},
                   aux_states={k: v for k, v in params.items() if k in aux},
                   grad_req="null")
    logits = je.forward(is_train=False)[0].asnumpy()
    return path, x, logits, tnet


def test_jax_export_binds_in_the_port(exported_resnet):
    path, x, logits, _ = exported_resnet
    sym = mx.sym.load(path + "-symbol.json")
    with mx.cpu():
        params = nd.load(path + "-0000.params")
        arg = {k[4:]: v for k, v in params.items() if k.startswith("arg:")}
        aux = {k[4:]: v for k, v in params.items() if k.startswith("aux:")}
        exe = sym.simple_bind(mx.cpu(), grad_req="null", data=x.shape)
        exe.copy_params_from(arg, aux)
        out = exe.forward(data=nd.array(x))[0]
        assert_close(out, logits, rtol=RTOL, atol=1e-5)
        net = mx.sym.SoftmaxOutput(sym, mx.sym.Variable("softmax_label"),
                                   normalization="batch")
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", (4,))], for_training=False)
        mod.set_params(arg, aux)
        mod.forward(mx.io.DataBatch([nd.array(x)], [nd.zeros((4,))]),
                    is_train=False)
        probs = host(mod.get_outputs()[0])
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    np.testing.assert_allclose(probs, e / e.sum(axis=1, keepdims=True),
                               rtol=RTOL, atol=1e-7)


def test_port_export_reloads_as_symbolblock(exported_resnet, tmp_path):
    _, x, logits, tnet = exported_resnet
    with mx.cpu():
        want = tnet(nd.array(x))
        assert_close(want, logits, rtol=RTOL, atol=1e-5)
        path = str(tmp_path / "port")
        tnet.export(path, epoch=2)
        blk = gluon.SymbolBlock.imports(path + "-symbol.json", ["data"],
                                        path + "-0002.params")
        assert_close(blk(nd.array(x)), want, rtol=RTOL, atol=1e-6)
        blk.hybridize()
        assert_close(blk(nd.array(x)), want, rtol=RTOL, atol=1e-6)
    # the port writes MXNet 1.x's layout; the JAX package reads it
    jparams = jnd.load(path + "-0002.params")
    assert all(k.startswith(("arg:", "aux:")) for k in jparams)
    assert len(jparams) == len(blk.collect_params())


def test_fit_callbacks_checkpoint_and_log(tmp_path, caplog):
    """``do_checkpoint`` writes each epoch's files (the JAX package reads
    them); ``Speedometer``, ``log_train_metric`` and ``ProgressBar`` run
    at their batch periods."""
    import logging
    prefix = str(tmp_path / "cb")
    bars = []
    with mx.cpu(), caplog.at_level(logging.INFO):
        mod = mx.mod.Module(mlp_sym(mx), context=mx.cpu())
        mod.fit(toy_iter(mx), num_epoch=2,
                arg_params={k: nd.array(v)
                            for k, v in init_params().items()},
                epoch_end_callback=mx.callback.do_checkpoint(prefix),
                batch_end_callback=[
                    mx.callback.Speedometer(16, frequent=2),
                    mx.callback.log_train_metric(3),
                    lambda p: bars.append(p.nbatch),
                    mx.callback.ProgressBar(total=6, length=10)])
    for epoch in (1, 2):
        sym, arg, _ = jmx.model.load_checkpoint(prefix, epoch)
        assert sym.list_arguments() == mod.symbol.list_arguments()
    for n, v in mod.get_params()[0].items():
        np.testing.assert_array_equal(host(arg[n]), host(v))
    assert "samples/sec" in caplog.text and "Train-accuracy" in caplog.text
    assert bars == list(range(6)) * 2
