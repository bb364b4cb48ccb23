"""The port's ``contrib.svrg``, ``contrib.text`` and ``contrib.onnx``
against the JAX package's, on the CPU.

  - ``SVRGModule``: right after a snapshot the variance-reduced gradient
    equals the full gradient mu (rtol 1e-5), as in both packages; ``fit``
    (``update_freq=2``, 4 epochs of 4 batches from constant weights) gives
    the JAX module's per-batch cross-entropy and final parameters at rtol
    1e-5;
  - ``count_tokens_from_str``, ``Vocabulary``, ``CustomEmbedding`` and a
    file-backed ``TokenEmbedding``: the same counters, indices, tokens and
    vectors, lookups on the current context;
  - ONNX: the files both packages write for the JAX tests' LeNet symbol
    and for ``resnet18_v1(classes=10)`` at 32 x 32 (traced by
    ``mx.sym.trace_block`` from the same weights) are byte-equal; the
    JAX-written resnet imported by the port and bound by its Executor
    gives the JAX block's logits within 1e-5; the IR round trip holds;
    an unsupported op raises; the vendored wire layer's primitives read
    back what they wrote.
"""

import collections

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.contrib import onnx as jonnx
from incubator_mxnet_tpu.contrib import text as jtext

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.contrib import SVRGModule
from incubator_mxnet_tpu_torch.contrib import _onnx_proto as top
from incubator_mxnet_tpu_torch.contrib import onnx as tonnx
from incubator_mxnet_tpu_torch.contrib import text as ttext

from test_torch_parity import assert_close
from test_torch_symbol import fresh


# --------------------------------------------------------------------- #
# SVRG
# --------------------------------------------------------------------- #
def _lin_sym(m):
    data = m.sym.Variable("data")
    label = m.sym.Variable("softmax_label")
    o = m.sym.FullyConnected(data, m.sym.Variable("w"), m.sym.Variable("b"),
                             num_hidden=3, name="fc")
    return m.sym.SoftmaxOutput(o, label, normalization="batch",
                               name="softmax")


def _iter(m, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(64, 8).astype(np.float32)
    W = rng.randn(8, 3).astype(np.float32)
    y = np.argmax(X @ W, 1).astype(np.float32)
    return m.io.NDArrayIter(X, y, batch_size=16, shuffle=False,
                            label_name="softmax_label")


def _svrg_fit(m, mod_cls):
    losses = []

    def record(param):
        losses.append(param.eval_metric.get()[1])
        param.eval_metric.reset()
    fresh()
    mod = mod_cls(_lin_sym(m), update_freq=2)
    mod.fit(_iter(m), eval_metric=m.metric.CrossEntropy(), optimizer="sgd",
            optimizer_params={"learning_rate": 0.5}, num_epoch=4,
            batch_end_callback=record,
            initializer=m.initializer.Constant(0.05))
    return mod, losses


def test_svrg_fit_matches_jax():
    from incubator_mxnet_tpu.contrib import SVRGModule as JSVRG
    jmod, jl = _svrg_fit(jmx, JSVRG)
    with mx.cpu():
        tmod, tl = _svrg_fit(mx, SVRGModule)
    assert len(tl) == len(jl) == 16
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    ja = jmod.get_params()[0]
    for n, v in tmod.get_params()[0].items():
        assert_close(v, ja[n], rtol=1e-5, atol=1e-7)
    assert tmod._snapshot is not None and tmod._mu is not None


def test_svrg_gradient_is_exact_at_the_snapshot():
    with mx.cpu():
        fresh()
        mod = SVRGModule(_lin_sym(mx), update_freq=1)
        it = _iter(mx)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
                 for_training=True)
        mod.init_params(initializer=mx.initializer.Xavier())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.0})
        assert mod.is_update_epoch(0) and mod.is_update_epoch(3)
        mod.update_full_grads(it)
        it.reset()
        mod.forward_backward(next(iter(it)))
        for name, mu in mod._mu.items():
            assert_close(mod._exec.grad_dict[name], mu, rtol=1e-5,
                         atol=1e-6)
        with pytest.raises(MXNetError, match="update_freq"):
            SVRGModule(_lin_sym(mx), update_freq=0)


# --------------------------------------------------------------------- #
# text
# --------------------------------------------------------------------- #
def test_text_matches_jax(tmp_path):
    src = "a b b c c c\nd d d d  e"
    tc = ttext.count_tokens_from_str(src, to_lower=True)
    jc = jtext.count_tokens_from_str(src, to_lower=True)
    assert tc == jc == collections.Counter(
        {"d": 4, "c": 3, "b": 2, "a": 1, "e": 1})
    kw = dict(most_freq_count=3, min_freq=2, reserved_tokens=["<pad>"])
    tv, jv = ttext.Vocabulary(tc, **kw), jtext.Vocabulary(jc, **kw)
    assert tv.idx_to_token == jv.idx_to_token
    assert tv.token_to_idx == jv.token_to_idx and len(tv) == len(jv)
    assert tv.to_indices(["d", "zzz", "b"]) == jv.to_indices(
        ["d", "zzz", "b"]) == [2, 0, 4]
    assert tv.to_tokens([2, 3]) == jv.to_tokens([2, 3])
    with pytest.raises(MXNetError, match="out of vocabulary"):
        tv.to_tokens(99)
    p = tmp_path / "glove.txt"
    p.write_text("the 0.1 0.2 0.3\nof 0.4 0.5 0.6\nand -1 0 2.5\n")
    with mx.cpu():
        te = ttext.TokenEmbedding.from_file(str(p))
        je = jtext.TokenEmbedding.from_file(str(p))
        assert te.vec_len == je.vec_len == 3
        assert te.idx_to_token == je.idx_to_token
        np.testing.assert_array_equal(te.idx_to_vec.asnumpy(),
                                      je.idx_to_vec.asnumpy())
        toks = ["of", "missing", "The", "and"]
        got = te.get_vecs_by_tokens(toks, lower_case_backup=True)
        assert got.context == mx.cpu()
        np.testing.assert_array_equal(
            got.asnumpy(), je.get_vecs_by_tokens(
                toks, lower_case_backup=True).asnumpy())
        vecs = {"hot": [1.0, 0.0], "cold": [0.0, 1.0]}
        tce = ttext.CustomEmbedding(vecs)
        jce = jtext.CustomEmbedding(vecs)
        tce.update_token_vectors("hot", nd.array([[0.5, 0.5]]))
        jce.update_token_vectors("hot", jnd.array([[0.5, 0.5]]))
        np.testing.assert_array_equal(
            tce.get_vecs_by_tokens(["hot", "cold", "x"]).asnumpy(),
            jce.get_vecs_by_tokens(["hot", "cold", "x"]).asnumpy())
        with pytest.raises(MXNetError, match="not in the embedding"):
            tce.update_token_vectors("x", [[1.0, 1.0]])
    from incubator_mxnet_tpu_torch.contrib.text import embedding, vocab
    assert embedding.CustomEmbedding is ttext.CustomEmbedding and \
        vocab.Vocabulary is ttext.Vocabulary


# --------------------------------------------------------------------- #
# ONNX
# --------------------------------------------------------------------- #
def _lenet_symbol(m):
    d = m.sym.Variable("data")
    c1 = m.sym.Convolution(d, m.sym.Variable("c1w"), m.sym.Variable("c1b"),
                           kernel=(5, 5), num_filter=6, pad=(2, 2),
                           name="c1")
    a1 = m.sym.Activation(c1, act_type="tanh", name="a1")
    p1 = m.sym.Pooling(a1, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="p1")
    f = m.sym.flatten(p1, name="flat")
    fc1 = m.sym.FullyConnected(f, m.sym.Variable("f1w"),
                               m.sym.Variable("f1b"), num_hidden=32,
                               flatten=False, name="fc1")
    a2 = m.sym.Activation(fc1, act_type="relu", name="a2")
    fc2 = m.sym.FullyConnected(a2, m.sym.Variable("f2w"),
                               m.sym.Variable("f2b"), num_hidden=10,
                               flatten=False, name="fc2")
    return m.sym.softmax(fc2, name="sm")


def _lenet_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"c1w": rng.randn(6, 1, 5, 5).astype(np.float32) * 0.1,
            "c1b": rng.randn(6).astype(np.float32) * 0.1,
            "f1w": rng.randn(32, 6 * 14 * 14).astype(np.float32) * 0.01,
            "f1b": np.zeros(32, np.float32),
            "f2w": rng.randn(10, 32).astype(np.float32) * 0.1,
            "f2b": np.zeros(10, np.float32)}


def _bind(sym, arg_params, x):
    """The port's Executor over an imported symbol; the BatchNorm
    statistics come back in ``arg_params`` and are its aux states."""
    aux_names = set(sym.list_auxiliary_states())
    exe = sym.simple_bind(mx.cpu(), grad_req="null", data=x.shape)
    exe.copy_params_from(
        {k: v for k, v in arg_params.items() if k not in aux_names},
        {k: v for k, v in arg_params.items() if k in aux_names})
    return exe.forward(is_train=False, data=nd.array(x))[0]


def test_lenet_onnx_byte_equal_and_round_trip(tmp_path):
    p = _lenet_params()
    x = np.random.RandomState(1).randn(2, 1, 28, 28).astype(np.float32)
    shapes = {"data": (2, 1, 28, 28)}
    jf = jonnx.export_model(_lenet_symbol(jmx),
                            {k: jnd.array(v) for k, v in p.items()}, shapes,
                            str(tmp_path / "j.onnx"))
    with mx.cpu():
        tparams = {k: nd.array(v) for k, v in p.items()}
        tf = tonnx.export_model(_lenet_symbol(mx), tparams, shapes,
                                str(tmp_path / "t.onnx"))
        assert open(tf, "rb").read() == open(jf, "rb").read()
        ir = tonnx.graph_to_ir(_lenet_symbol(mx), tparams, shapes)
        jir = jonnx.graph_to_ir(
            _lenet_symbol(jmx), {k: jnd.array(v) for k, v in p.items()},
            shapes)
        for key in ("nodes", "inputs", "outputs"):
            assert ir[key] == jir[key]
        assert list(ir["initializers"]) == list(jir["initializers"])
        for k, v in ir["initializers"].items():
            np.testing.assert_array_equal(v, jir["initializers"][k])
        want = _lenet_symbol(mx).eval(data=nd.array(x), **tparams)[0]
        sym2, args2 = tonnx.ir_to_symbol(ir["nodes"], ir["inputs"],
                                         ir["initializers"])
        assert_close(_bind(sym2, args2, x), want, rtol=1e-5, atol=1e-6)
        sym3, args3, aux3 = tonnx.import_model(jf)
        assert aux3 == {}
        assert_close(_bind(sym3, args3, x), want, rtol=1e-5, atol=1e-6)
        s = mx.sym.topk(mx.sym.Variable("data"), k=2)
        with pytest.raises(MXNetError, match="unsupported op"):
            tonnx.graph_to_ir(s, {}, {"data": (2, 4)})
        with pytest.raises(MXNetError, match="unsupported op"):
            tonnx.ir_to_symbol([{"op_type": "Einsum", "name": "e",
                                 "inputs": ["data"], "outputs": ["y"]}],
                               [{"name": "data", "shape": [2]}], {})


@pytest.fixture(scope="module")
def resnet_pair():
    """resnet18_v1(classes=10) in both packages (the port's random
    weights, carried by name), one inference forward at 32 x 32; the
    JAX block's logits."""
    from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
    from test_torch_model_zoo import _FromPort
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    mx.random.seed(0)
    fresh()
    with mx.cpu():
        tnet = tvision.resnet18_v1(classes=10)
        tnet.initialize()
        tnet(nd.array(x))
    fresh()
    jnet = jvision.resnet18_v1(classes=10)
    jnet.initialize(_FromPort(tnet))
    jnet.hybridize()
    logits = jnet(jnd.array(x)).asnumpy()
    return x, tnet, jnet, logits


def _export(m, net, path, x):
    sym, _ = m.sym.trace_block(net)
    params = {p.name: p.data() for p in net.collect_params().values()}
    return m.contrib.onnx.export_model(sym, params, {"data": x.shape}, path)


def test_resnet18_onnx_byte_equal_and_imported(resnet_pair, tmp_path):
    x, tnet, jnet, logits = resnet_pair
    jf = _export(jmx, jnet, str(tmp_path / "j.onnx"), x)
    with mx.cpu():
        tf = _export(mx, tnet, str(tmp_path / "t.onnx"), x)
        assert open(tf, "rb").read() == open(jf, "rb").read()
        sym, args, _ = mx.contrib.onnx.import_model(jf)
        assert_close(_bind(sym, args, x), logits, rtol=1e-5, atol=1e-5)
    ops = {n["op_type"] for n in top.parse_model(
        open(tf, "rb").read())["graph"]["nodes"]}
    assert {"Conv", "BatchNormalization", "Relu", "Add", "Gemm"} <= ops


def test_vendored_proto_primitives():
    for arr in (np.arange(12, dtype=np.float32).reshape(3, 4),
                np.array([-3, 0, 7], np.int64)):
        name, back = top.parse_tensor(top.tensor_bytes("t", arr))
        assert name == "t" and back.dtype == arr.dtype
        np.testing.assert_array_equal(back, arr)
    nb = top.node_bytes("Conv", ["x", "w"], ["y"], name="conv0",
                        attrs={"group": 1, "epsilon": 0.5,
                               "kernel_shape": [5, 5], "pad_mode": "VALID",
                               "neg": -2})
    from incubator_mxnet_tpu.contrib import _onnx_proto as jop
    assert nb == jop.node_bytes("Conv", ["x", "w"], ["y"], name="conv0",
                                attrs={"group": 1, "epsilon": 0.5,
                                       "kernel_shape": [5, 5],
                                       "pad_mode": "VALID", "neg": -2})
    node = top.parse_node(nb)
    a = node["attrs"]
    assert node["op_type"] == "Conv" and a["neg"] == -2 and \
        a["kernel_shape"] == [5, 5] and a["pad_mode"] == b"VALID"
    vi = top.parse_value_info(top.value_info_bytes("in0", top.FLOAT,
                                                   (1, 3, 8, 8)))
    assert vi == {"name": "in0", "shape": [1, 3, 8, 8]}
