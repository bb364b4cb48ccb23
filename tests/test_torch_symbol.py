"""The port's symbolic front end (``mx.sym``, the Executor, passes, name
and attribute scopes, ``print_summary``) against the JAX package's, on
the CPU.

  - the same graph built in both packages introspects alike, infers the
    same shapes and dtypes, and writes the same JSON; each package loads
    the other's file, and a file as MXNet 1.x writes it (every attribute
    a string, ``"(..)"`` shapes, ``__dtype__`` a type code) binds in the
    port through ``simple_bind``;
  - ``mx.sym`` has one function per name of the port's registry, under
    the JAX package's names;
  - the Executor's forward and backward under grad_req write, add and
    null equal the JAX executor's (rtol 1e-5: one matmul's summation
    order), BatchNorm's running statistics after a step equal the JAX
    executor's with and without a read of ``outputs`` before
    ``backward``; ``reshape`` shares the parameters; the signatures under
    each key equal the JAX jits' ``_cache_size()``;
  - the passes, the scopes' names and attributes, and ``print_summary``'s
    table equal the JAX package's.
"""

import json

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.symbol import symbol as jsymbol

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import registry
from incubator_mxnet_tpu_torch.symbol import symbol as tsymbol

from test_torch_parity import assert_close, fresh_names, host

RTOL = 1e-5


def fresh():
    """Both packages' symbol and block name counters back to zero."""
    jsymbol._name_counters.clear()
    tsymbol._name_counters.clear()
    fresh_names()


def mlp(m):
    data = m.sym.Variable("data")
    h = m.sym.FullyConnected(data, m.sym.Variable("w1"),
                             m.sym.Variable("b1"), num_hidden=8, name="fc1")
    h = m.sym.relu(h, name="act1")
    return m.sym.FullyConnected(h, m.sym.Variable("w2"), None, no_bias=True,
                                num_hidden=3, name="fc2")


def mlp_args(seed=0, batch=4):
    rng = np.random.RandomState(seed)
    return {"data": rng.randn(batch, 16).astype(np.float32),
            "w1": (rng.randn(8, 16) * 0.1).astype(np.float32),
            "b1": rng.randn(8).astype(np.float32),
            "w2": (rng.randn(3, 8) * 0.1).astype(np.float32)}


def both(build):
    fresh()
    j = build(jmx)
    fresh()
    return j, build(mx)


def jax_counts(exe):
    return {k: f._cache_size() for k, f in exe._jit_cache.items()}


# --------------------------------------------------------------------- #
# graphs, inference, files
# --------------------------------------------------------------------- #

def test_compose_and_introspect():
    j, t = both(mlp)
    for f in ("list_arguments", "list_outputs", "list_inputs",
              "list_auxiliary_states"):
        assert getattr(t, f)() == getattr(j, f)(), f
    assert t.name == j.name == "fc2"
    ti, ji = t.get_internals(), j.get_internals()
    assert ti.list_outputs() == ji.list_outputs()
    assert ti["act1_output"].list_arguments() == ["data", "w1", "b1"]
    assert t.get_children().list_outputs() == j.get_children().list_outputs()
    g = mx.sym.Group([t, ti["act1_output"]])
    assert g.name == "grouped" and len(g) == 2
    with pytest.raises(MXNetError, match="no output"):
        t["nope"]


def test_infer_shape_and_type():
    j, t = both(mlp)
    full = dict(data=(4, 16), w1=(8, 16), b1=(8,), w2=(3, 8))
    assert t.infer_shape(**full) == j.infer_shape(**full)
    assert t.infer_shape(data=(4, 16)) == j.infer_shape(data=(4, 16)) == \
        ([(4, 16), (8, 16), (8,), (3, 8)], [(4, 3)], [])
    assert t.infer_shape((4, 16)) == j.infer_shape((4, 16))
    free = mx.sym.Variable("a") + mx.sym.Variable("b")
    assert free.infer_shape(a=(2, 2)) == (None, None, None)
    types = dict(data="float32", w1="float32", b1="float32", w2="float32")
    assert t.infer_type(**types) == j.infer_type(**types)
    fresh()
    jt = (jmx.sym.Variable("a") + jmx.sym.Variable("b")).infer_type(
        a="float32", b="float16")
    tt = (mx.sym.Variable("a") + mx.sym.Variable("b")).infer_type(
        a="float32", b="float16")
    assert tt == jt
    assert t.infer_type(data="float32") == (None, None, None)


def test_json_round_trip_both_ways(tmp_path):
    def build(m):
        data = m.sym.Variable("data")
        x = m.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1))
        x = m.sym.BatchNorm(x, fix_gamma=False)
        x = m.sym.Activation(x, act_type="relu")
        x = m.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
        x = m.sym.FullyConnected(m.sym.flatten(x), num_hidden=5)
        return m.sym.SoftmaxOutput(x, m.sym.Variable("softmax_label"),
                                   name="softmax")
    j, t = both(build)
    assert json.loads(t.tojson()) == json.loads(j.tojson())
    j.save(str(tmp_path / "j-symbol.json"))
    t.save(str(tmp_path / "t-symbol.json"))
    tj = mx.sym.load(str(tmp_path / "j-symbol.json"))
    jt = jmx.sym.load(str(tmp_path / "t-symbol.json"))
    assert tj.tojson() == t.tojson() and jt.tojson() == j.tojson()
    shapes = dict(data=(2, 3, 8, 8), softmax_label=(2,))
    assert tj.infer_shape(**shapes) == j.infer_shape(**shapes)
    assert tj.list_auxiliary_states() == j.list_auxiliary_states()
    # the loaded graph runs as the JAX one does
    rng = np.random.RandomState(0)
    arg_shapes, _, aux_shapes = j.infer_shape(**shapes)
    vals = {n: rng.randn(*s).astype(np.float32) * 0.3
            for n, s in zip(j.list_arguments(), arg_shapes)}
    vals["softmax_label"] = np.array([1, 3], np.float32)
    aux = {n: (np.ones if "var" in n else np.zeros)(s, np.float32)
           for n, s in zip(j.list_auxiliary_states(), aux_shapes)}
    je = j.bind(args={k: jnd.array(v) for k, v in vals.items()},
                aux_states={k: jnd.array(v) for k, v in aux.items()})
    with mx.cpu():
        te = tj.bind(args={k: nd.array(v) for k, v in vals.items()},
                     aux_states={k: nd.array(v) for k, v in aux.items()})
        assert_close(te.forward()[0], je.forward()[0], rtol=RTOL)


def test_file_as_mxnet_writes_it_binds_in_the_port(tmp_path):
    """Every attribute a string, ``"(..)"`` shapes, ``__dtype__`` MXNet's
    type code 0: the port infers and binds from the file alone."""
    ref = {
        "nodes": [
            {"op": "null", "name": "data", "inputs": []},
            {"op": "null", "name": "fc1_weight",
             "attrs": {"__dtype__": "0", "__shape__": "(4, 5)"},
             "inputs": []},
            {"op": "null", "name": "fc1_bias",
             "attrs": {"__shape__": "(4,)"}, "inputs": []},
            {"op": "FullyConnected", "name": "fc1",
             "attrs": {"num_hidden": "4", "no_bias": "False",
                       "flatten": "True"},
             "inputs": [[0, 0, 0], [1, 0, 0], [2, 0, 0]]},
            {"op": "Activation", "name": "relu1",
             "attrs": {"act_type": "relu"}, "inputs": [[3, 0, 0]]},
        ],
        "arg_nodes": [0, 1, 2],
        "node_row_ptr": [0, 1, 2, 3, 4, 5],
        "heads": [[4, 0, 0]],
        "attrs": {"mxnet_version": ["int", 10902]},
    }
    p = tmp_path / "net-symbol.json"
    p.write_text(json.dumps(ref))
    sym = mx.sym.load(str(p))
    # dunder attributes stay strings (MXNet's attribute API)
    assert sym.get_internals()["fc1_weight_output"].attr("__shape__") == \
        "(4, 5)"
    assert sym.infer_shape(data=(2, 5)) == \
        ([(2, 5), (4, 5), (4,)], [(2, 4)], [])
    from incubator_mxnet_tpu_torch.symbol.executor import infer_types
    assert infer_types(sym, {"data": "float16"}) == {
        "args": {"data": "float16", "fc1_weight": "float32",
                 "fc1_bias": "float32"}, "outs": ["float32"]}
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5).astype(np.float32)
    w = rng.randn(4, 5).astype(np.float32)
    with mx.cpu():
        exe = sym.simple_bind(mx.cpu(), data=(2, 5))
        exe.copy_params_from({"fc1_weight": nd.array(w),
                              "fc1_bias": nd.zeros((4,))})
        out = exe.forward(data=nd.array(x))[0].asnumpy()
    np.testing.assert_allclose(out, np.maximum(x @ w.T, 0), rtol=RTOL,
                               atol=1e-6)


def test_sym_has_one_function_per_registry_name():
    names = registry.list_all_names()
    jnames = set(dir(jmx.sym))
    for n in names:
        f = getattr(mx.sym, n)
        assert callable(f) and f.__name__ == n, n
        assert n in jnames, n              # the JAX package's name too
    short = [n[len("_contrib_"):] for n in names
             if n.startswith("_contrib_")]
    assert short and all(hasattr(mx.sym.contrib, s) for s in short)
    assert all(hasattr(jmx.sym.contrib, s) for s in short)


def test_implicit_parameter_variables():
    def build(m):
        data = m.sym.Variable("data")
        return [m.sym.FullyConnected(data, name="fc1", num_hidden=3),
                m.sym.FullyConnected(data, name="fc2", num_hidden=3,
                                     no_bias=True),
                m.sym.BatchNorm(data, name="bn1"),
                m.sym.Deconvolution(data, name="dc", kernel=(2, 2),
                                    num_filter=4),
                m.sym.LeakyReLU(data, name="pr", act_type="prelu"),
                m.sym.LeakyReLU(data, name="lk")]
    j, t = both(build)
    for a, b in zip(t, j):
        assert a.list_arguments() == b.list_arguments()
        assert a.list_auxiliary_states() == b.list_auxiliary_states()
    assert t[2].list_auxiliary_states() == ["bn1_moving_mean",
                                            "bn1_moving_var"]


def test_gluon_trace_writes_the_jax_graph():
    from incubator_mxnet_tpu.gluon import nn as jnn
    from incubator_mxnet_tpu_torch.gluon import nn as tnn

    def build(nn, m):
        net = nn.HybridSequential()
        net.add(nn.Dense(4, in_units=3), nn.BatchNorm(in_channels=4),
                nn.Activation("relu"), nn.Dense(2, in_units=4))
        return net(m.sym.Variable("data"))
    fresh()
    j = build(jnn, jmx)
    fresh()
    with mx.cpu():
        t = build(tnn, mx)
    assert json.loads(t.tojson()) == json.loads(j.tojson())
    assert t.list_auxiliary_states() == j.list_auxiliary_states() == [
        "batchnorm0_running_mean", "batchnorm0_running_var"]


# --------------------------------------------------------------------- #
# the executor against the JAX executor
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_executor_forward_backward_matches_jax(req):
    j, t = both(mlp)
    vals = mlp_args()
    cot = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    je = j.bind(args={k: jnd.array(v) for k, v in vals.items()},
                grad_req=req)
    with mx.cpu():
        te = t.bind(args={k: nd.array(v) for k, v in vals.items()},
                    grad_req=req)
        for step in range(2):
            if req == "null":
                assert_close(te.forward(is_train=True)[0],
                             je.forward(is_train=True)[0], rtol=RTOL)
                te.backward()
                assert te.grad_arrays == [None] * 4
                continue
            te.forward(is_train=True)
            je.forward(is_train=True)
            te.backward(nd.array(cot))
            je.backward(jnd.array(cot))
            assert_close(te.outputs[0], je.outputs[0], rtol=RTOL)
            for n in vals:
                assert_close(te.grad_dict[n], je.grad_dict[n], rtol=RTOL,
                             atol=1e-6)
        assert te.signature_counts() == jax_counts(je)
    if req == "add":               # two backwards summed
        ones = mlp(mx)
        with mx.cpu():
            e1 = ones.bind(args={k: nd.array(v) for k, v in vals.items()})
            e1.forward(is_train=True)
            e1.backward(nd.array(cot))
            np.testing.assert_allclose(host(te.grad_dict["w1"]),
                                       2 * host(e1.grad_dict["w1"]),
                                       rtol=RTOL)


def _bn_graph(m):
    data = m.sym.Variable("data")
    x = m.sym.FullyConnected(data, num_hidden=6, name="fc")
    x = m.sym.BatchNorm(x, fix_gamma=False, momentum=0.8, name="bn")
    x = m.sym.Dropout(x, p=0.0, name="drop")
    return m.sym.sum(m.sym.relu(x, name="act") * 1.5, name="loss")


@pytest.mark.parametrize("read_outputs", [False, True])
def test_batchnorm_running_statistics_match_jax(read_outputs):
    j, t = both(_bn_graph)
    rng = np.random.RandomState(3)
    vals = {"data": rng.randn(8, 5).astype(np.float32),
            "fc_weight": rng.randn(6, 5).astype(np.float32) * 0.5,
            "fc_bias": rng.randn(6).astype(np.float32),
            "bn_gamma": rng.rand(6).astype(np.float32) + 0.5,
            "bn_beta": rng.randn(6).astype(np.float32)}
    aux = {"bn_moving_mean": rng.randn(6).astype(np.float32),
           "bn_moving_var": rng.rand(6).astype(np.float32) + 0.5}
    assert t.list_auxiliary_states() == sorted(aux)
    je = j.bind(args={k: jnd.array(v) for k, v in vals.items()},
                aux_states={k: jnd.array(v) for k, v in aux.items()})
    with mx.cpu():
        te = t.bind(args={k: nd.array(v) for k, v in vals.items()},
                    aux_states={k: nd.array(v) for k, v in aux.items()})
        for step in range(3):
            x = rng.randn(8, 5).astype(np.float32)
            jo = je.forward(is_train=True, data=jnd.array(x))
            to = te.forward(is_train=True, data=nd.array(x))
            if read_outputs:
                assert_close(to[0], jo[0], rtol=RTOL)
            je.backward()
            te.backward()
            for n in aux:
                assert_close(te.aux_dict[n], je.aux_dict[n], rtol=RTOL)
            for n in vals:       # fc_bias's gradient is 0 up to rounding
                assert_close(te.grad_dict[n], je.grad_dict[n], rtol=1e-4,
                             atol=1e-5)
        # an unconsumed training forward lands its update at the next one
        te.forward(is_train=True)
        je.forward(is_train=True)
        te.forward(is_train=False)
        je.forward(is_train=False)
        for n in aux:
            assert_close(te.aux_dict[n], je.aux_dict[n], rtol=RTOL)
        assert_close(te.outputs[0], je.outputs[0], rtol=RTOL)
        assert te.signature_counts() == jax_counts(je)


def test_signatures_per_key_and_reshape_match_jax():
    j, t = both(mlp)
    vals = mlp_args()
    je = j.simple_bind(data=(4, 16))
    je.copy_params_from({k: jnd.array(v) for k, v in vals.items()
                         if k != "data"})
    with mx.cpu():
        te = t.simple_bind(mx.cpu(), data=(4, 16))
        te.copy_params_from({k: nd.array(v) for k, v in vals.items()
                             if k != "data"})
        w1 = te.arg_dict["w1"]._data
        for batch, train in ((4, False), (4, False), (6, False),
                             (4, True), (6, True), (4, True), (4, False)):
            x = np.random.RandomState(batch).randn(batch, 16) \
                .astype(np.float32)
            je.forward(is_train=train, data=jnd.array(x))
            te.forward(is_train=train, data=nd.array(x))
            if train:
                je.backward()
                te.backward()
            assert_close(te.outputs[0], je.outputs[0], rtol=RTOL)
        # the parameters stay bound by address across signatures
        assert te.arg_dict["w1"]._data is w1
        assert te.signature_counts() == jax_counts(je)
        assert te.signature_counts() == {
            False: 2, ("train", ("data", "w1", "b1", "w2"), True): 2}
        # reshape shares the parameter arrays
        with torch.no_grad():
            te.arg_dict["w1"]._data += 1.5
        te2 = te.reshape(data=(5, 16))
        assert te2.arg_dict["w1"] is te.arg_dict["w1"]
        te2.forward(data=nd.ones((5, 16)))
        assert te2.outputs[0].shape == (5, 3)
        with pytest.raises(MXNetError, match="changed shape"):
            te.reshape(data=(5, 17))
        # an entry replaced behind the executor's back is read
        te.arg_dict["w2"] = nd.zeros((3, 8))
        np.testing.assert_array_equal(
            te.forward(data=nd.ones((4, 16)))[0].asnumpy(), 0.0)


def test_backward_errors_and_multi_output():
    j, t = both(lambda m: m.sym.Group([mlp(m), m.sym.Variable("data") * 2]))
    with mx.cpu():
        te = t.simple_bind(mx.cpu(), data=(4, 16))
        with pytest.raises(MXNetError, match="before forward"):
            te.backward()
        te.forward(is_train=True)
        with pytest.raises(MXNetError, match="out_grads"):
            te.backward()
        te.backward([nd.ones((4, 3)), nd.ones((4, 16))])
        np.testing.assert_allclose(te.grad_dict["data"].asnumpy().sum(),
                                   te.grad_dict["data"].asnumpy().sum())
        assert len(te.outputs) == 2


# --------------------------------------------------------------------- #
# passes, scopes, summary, sugar
# --------------------------------------------------------------------- #

def test_passes_match_jax():
    def build(m):
        x = m.sym.Variable("x")
        y = m.sym.identity(m.sym.transpose(
            m.sym.transpose(x, axes=(1, 0, 2)), axes=(1, 0, 2)))
        return m.sym.relu(m.sym._copy(y) + 1.0)
    j, t = both(build)
    for name in ("EliminateIdentity", "FoldTransposePairs"):
        assert json.loads(mx.sym.apply_pass(t, name).tojson()) == \
            json.loads(jmx.sym.apply_pass(j, name).tojson())
    assert mx.sym.apply_pass(t, "CountOps") == \
        jmx.sym.apply_pass(j, "CountOps")
    r = mx.sym.apply_pass(t, "ReplaceOp", from_op="relu", to_op="sigmoid")
    rj = jmx.sym.apply_pass(j, "ReplaceOp", from_op="relu", to_op="sigmoid")
    assert json.loads(r.tojson()) == json.loads(rj.tojson())
    assert mx.sym.list_passes() == jmx.sym.list_passes()
    x = np.random.RandomState(0).randn(2, 3, 4).astype(np.float32)
    folded = mx.sym.apply_pass(t, "FoldTransposePairs")
    with mx.cpu():
        assert_close(folded.eval(x=nd.array(x))[0],
                     np.maximum(x + 1.0, 0.0), rtol=RTOL)
    with pytest.raises(MXNetError, match="unknown pass"):
        mx.sym.apply_pass(t, "Nope")


def test_name_and_attr_scopes_match_jax():
    def build(m):
        with m.name.Prefix("stage1_"):
            a = m.sym.Variable("data")
            b = m.sym.relu(a)
            c = m.sym.exp(b)
        with m.AttrScope(ctx_group="dev1"):
            d = m.sym.relu(c)
            v = m.sym.Variable("w")
        with m.AttrScope(g="1"):
            with m.AttrScope(g="2"):
                e = m.sym.relu(d + v)
        return e
    j, t = both(build)
    assert json.loads(t.tojson()) == json.loads(j.tojson())
    assert t.attr("g") == "2"
    t2 = mx.sym.fromjson(t.tojson())
    t2._set_attr(stage="3")
    assert t2.attr("stage") == "3" and t2.attr_dict()[t2.name]["g"] == "2"
    with mx.cpu():
        out = t.eval(data=nd.array([-1.0, 2.0]), w=nd.zeros((2,)))[0]
    np.testing.assert_allclose(out.asnumpy(),
                               np.maximum(np.exp(np.maximum([-1.0, 2.0],
                                                            0)), 0),
                               rtol=RTOL)


def test_print_summary_matches_jax(capsys):
    def build(m):
        data = m.sym.Variable("data")
        fc1 = m.sym.FullyConnected(data, m.sym.Variable("w1"),
                                   m.sym.Variable("b1"), num_hidden=16,
                                   name="fc1")
        act = m.sym.relu(fc1, name="act1")
        return m.sym.FullyConnected(act, m.sym.Variable("w2"),
                                    m.sym.Variable("b2"), num_hidden=3,
                                    name="fc2")
    j, t = both(build)
    total = mx.viz.print_summary(t, shape={"data": (1, 8)})
    mine = capsys.readouterr().out
    assert total == jmx.viz.print_summary(j, shape={"data": (1, 8)}) == \
        (16 * 8 + 16) + (3 * 16 + 3)
    assert mine == capsys.readouterr().out
    try:
        assert hasattr(mx.viz.plot_network(t), "source")
    except MXNetError as err:
        assert "graphviz" in str(err)


def test_eval_sugar_and_split():
    a = mx.sym.Variable("a")
    b = mx.sym.Variable("b")
    with mx.cpu():
        (res,) = ((a * 2.0 + b) / 4.0).eval(a=nd.ones((2, 2)),
                                               b=nd.full((2, 2), 6.0))
        np.testing.assert_allclose(res.asnumpy(), 2.0)
        (v,) = (1.0 - a).eval(a=nd.array([1.0, 2.0]))
        np.testing.assert_allclose(v.asnumpy(), [0.0, -1.0])
        (p,) = (a ** 2.0).eval(a=nd.array([1.0, 2.0]))
        np.testing.assert_allclose(p.asnumpy(), [1.0, 4.0])
        sp = mx.sym.split(mx.sym.Variable("x"), num_outputs=2, axis=1)
        assert len(sp.list_outputs()) == 2
        (v,) = sp[1].eval(x=nd.array(np.arange(8.0).reshape(2, 4)))
        np.testing.assert_allclose(v.asnumpy(), [[2, 3], [6, 7]])
    with pytest.raises(MXNetError, match="deprecated"):
        a.grad("a")
