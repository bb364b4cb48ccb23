"""The port's sparse storage against the JAX package's, on the CPU.

  - ``nd.sparse``: row-sparse and CSR round trips, ``cast_storage`` both
    ways, ``zeros``, ``array`` (scipy input too) and ``retain`` (absent
    rows come back as zero rows): dense values, indices, data and indptr
    bitwise; ``dot`` in its four forms within 1e-5 relative;
  - the lazy updates: SGD (momentum 0 and 0.9) and Adam over 5 steps on
    changing active rows, against the JAX optimizers at rtol 1e-6, the
    rows outside each step's active set bitwise untouched in the weight
    and the state;
  - ``Embedding(sparse_grad=True)`` and ``SparseEmbedding`` (vocabulary
    50, width 8, under a Dense layer) trained 3 steps by ``gluon.Trainer``
    in both packages: losses and weights within 1e-5 relative, the fused
    applier's capture counts equal the JAX applier's trace counts, and a
    non-finite embedding gradient skips the step with every parameter
    bitwise unchanged in both;
  - ``KVStore.row_sparse_pull`` (dedup, sort, clip) bitwise;
  - ``LibSVMIter`` batches bitwise (the padded last batch, label files,
    ``reset`` / ``tell`` / ``set_position``); ``Module.fit`` over it
    (the JAX ``tests/test_module.py`` LibSVM case) at rtol 1e-5 with the
    executor's signatures equal to the JAX jits';
  - MXNet ``.params`` records of a sparse storage type are still refused
    by both packages' loaders.
"""

import struct

import numpy as np
import pytest
import scipy.sparse as sps

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.ndarray import sparse as jsp

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, nd
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ndarray import sparse as tsp

from test_torch_parity import assert_close, build_pair
from test_torch_symbol import fresh


def same(t, j):
    """Bitwise: values, dtype and shape."""
    a, b = t.asnumpy(), j.asnumpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def same_sparse(t, j):
    assert t.stype == j.stype and t.shape == j.shape and t.nnz == j.nnz
    same(t, j)
    same(t.indices, j.indices)
    same(t.data, j.data)
    if t.stype == "csr":
        same(t.indptr, j.indptr)


def _dense(rng, shape=(6, 5), density=0.4):
    return ((rng.rand(*shape) < density) * rng.randn(*shape)) \
        .astype(np.float32)


# --------------------------------------------------------------------- #
# storage
# --------------------------------------------------------------------- #
def test_storage_round_trips_bitwise():
    rng = np.random.RandomState(0)
    vals = rng.randn(3, 4).astype(np.float32)
    dense = _dense(rng)
    dense[2] = 0.0                           # an all-zero row
    with mx.cpu():
        cases = [
            (tsp.row_sparse_array((vals, [4, 0, 2]), shape=(6, 4)),
             jsp.row_sparse_array((vals, [4, 0, 2]), shape=(6, 4))),
            (tsp.row_sparse_array(dense), jsp.row_sparse_array(dense)),
            (tsp.csr_matrix(dense), jsp.csr_matrix(dense)),
            (nd.array(dense).tostype("row_sparse"),
             jnd.array(dense).tostype("row_sparse")),
            (nd.cast_storage(nd.array(dense), "csr"),
             jnd.cast_storage(jnd.array(dense), "csr")),
            (tsp.zeros("row_sparse", (4, 3)), jsp.zeros("row_sparse", (4, 3))),
            (tsp.zeros("csr", (4, 3)), jsp.zeros("csr", (4, 3))),
        ]
        m = sps.random(5, 4, density=0.4, format="csr", dtype=np.float32,
                       random_state=0)
        cases.append((tsp.array(m), jsp.array(m)))
        cases.append((tsp.array(dense), jsp.array(dense)))
        csr = tsp.csr_matrix(dense)
        cases.append((tsp.csr_matrix((csr.data.asnumpy(),
                                      csr.indices.asnumpy(),
                                      csr.indptr.asnumpy()), shape=(6, 5)),
                      jsp.csr_matrix(dense)))
        for t, j in cases:
            same_sparse(t, j)
            assert t.context == mx.cpu()
            back, jback = t.tostype("default"), j.tostype("default")
            assert back.stype == jback.stype == "default"
            same(back, jback)
            # across storage types, through the dense value
            other = "csr" if t.stype == "row_sparse" else "row_sparse"
            same_sparse(t.tostype(other), j.tostype(other))
        z = tsp.zeros("default", (2, 3))
        assert z.stype == "default" and z.asnumpy().sum() == 0
        # a sparse array IS its dense value to every dense op
        r, jr = cases[0]
        same(r * 2 + 1, jr * 2 + 1)
        with pytest.raises(MXNetError, match="needs shape"):
            tsp.row_sparse_array((vals, [0, 1, 2]))
        with pytest.raises(MXNetError, match="unknown storage type"):
            tsp.zeros("coo", (2, 2))


def test_retain_bitwise_with_absent_rows():
    rng = np.random.RandomState(1)
    vals = rng.randn(3, 2).astype(np.float32)
    with mx.cpu():
        t = tsp.row_sparse_array((vals, [0, 2, 3]), shape=(6, 2))
        j = jsp.row_sparse_array((vals, [0, 2, 3]), shape=(6, 2))
        for want in ([3, 2], [5, 1, 2], [4], []):
            kept = tsp.retain(t, want)
            same_sparse(kept, jsp.retain(j, want))
        same_sparse(t.retain([1, 3]), j.retain([1, 3]))
        empty = tsp.zeros("row_sparse", (6, 2))
        same_sparse(tsp.retain(empty, [1, 4]),
                    jsp.retain(jsp.zeros("row_sparse", (6, 2)), [1, 4]))
        with pytest.raises(MXNetError, match="RowSparseNDArray"):
            tsp.retain(nd.array(vals), [0])


def test_dot_four_forms():
    rng = np.random.RandomState(2)
    a = _dense(rng, (6, 5), 0.5)
    b = rng.randn(5, 3).astype(np.float32)
    c = rng.randn(6, 3).astype(np.float32)
    with mx.cpu():
        forms = [
            ((tsp.csr_matrix(a), nd.array(b)), (jsp.csr_matrix(a),
                                                jnd.array(b)), {}),
            ((tsp.csr_matrix(a), nd.array(c)), (jsp.csr_matrix(a),
                                                jnd.array(c)),
             {"transpose_a": True}),
            ((tsp.row_sparse_array(a), nd.array(b)),
             (jsp.row_sparse_array(a), jnd.array(b)), {}),
            ((nd.array(a), nd.array(b.T)), (jnd.array(a), jnd.array(b.T)),
             {"transpose_b": True}),
        ]
        for targs, jargs, kw in forms:
            got = tsp.dot(*targs, **kw)
            want = jsp.dot(*jargs, **kw)
            assert_close(got, want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------- #
# lazy updates
# --------------------------------------------------------------------- #
LAZY = [("sgd", {"learning_rate": 0.1}),
        ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
        ("adam", {"learning_rate": 0.05, "wd": 1e-3})]


@pytest.mark.parametrize("name,kw", LAZY,
                         ids=["sgd", "sgd_momentum", "adam"])
def test_lazy_updates_match_jax(name, kw):
    rng = np.random.RandomState(3)
    w0 = rng.randn(8, 3).astype(np.float32)
    topt = mx.optimizer.create(name, lazy_update=True, **kw)
    jopt = jmx.optimizer.create(name, lazy_update=True, **kw)
    with mx.cpu():
        tw = nd.array(w0)
        jw = jnd.array(w0)
        tstate = topt.create_state(0, tw._data)
        jstate = jopt.create_state(0, jw)
        ptrs = [tw._data.data_ptr()] + [
            s.data_ptr() for s in mx.optimizer.fused.tree_leaves(tstate)]
        for step in range(5):
            rows = sorted(rng.choice(8, 3, replace=False).tolist())
            g = rng.randn(3, 3).astype(np.float32)
            before = [tw.asnumpy()] + [
                s.numpy().copy()
                for s in mx.optimizer.fused.tree_leaves(tstate)]
            topt.update(0, tw._data, tsp.row_sparse_array(
                (g, rows), shape=(8, 3)), tstate)
            jopt.update(0, jw, jsp.row_sparse_array((g, rows), shape=(8, 3)),
                        jstate)
            assert_close(tw, jw, rtol=1e-6, atol=1e-7)
            after = [tw.asnumpy()] + [
                s.numpy() for s in mx.optimizer.fused.tree_leaves(tstate)]
            idle = [r for r in range(8) if r not in rows]
            for b, a in zip(before, after):
                np.testing.assert_array_equal(a[idle], b[idle])
        jleaves = [jstate] if not isinstance(jstate, tuple) else \
            list(jstate)
        for t, j in zip(mx.optimizer.fused.tree_leaves(tstate),
                        [s for s in jleaves if s is not None]):
            assert_close(t, j, rtol=1e-6, atol=1e-7)
        # written in place: the same tensors throughout
        assert ptrs == [tw._data.data_ptr()] + [
            s.data_ptr() for s in mx.optimizer.fused.tree_leaves(tstate)]


def test_dense_gradient_and_lazy_off_are_dense_updates():
    """``lazy_update=False`` (and AdamW, which has no lazy form) update
    every row from a row-sparse gradient, as the JAX optimizers do."""
    rng = np.random.RandomState(4)
    w0 = rng.randn(5, 2).astype(np.float32)
    g = rng.randn(2, 2).astype(np.float32)
    for name, lazy in (("sgd", False), ("adam", False), ("adamw", True)):
        topt = mx.optimizer.create(name, learning_rate=0.1, wd=0.1,
                                   lazy_update=lazy)
        jopt = jmx.optimizer.create(name, learning_rate=0.1, wd=0.1,
                                    lazy_update=lazy)
        with mx.cpu():
            tw, jw = nd.array(w0), jnd.array(w0)
            upd = mx.optimizer.get_updater(topt)
            upd(0, tsp.row_sparse_array((g, [1, 3]), shape=(5, 2)), tw)
            jmx.optimizer.get_updater(jopt)(
                0, jsp.row_sparse_array((g, [1, 3]), shape=(5, 2)), jw)
            assert_close(tw, jw, rtol=1e-6, atol=1e-7)
            assert not np.array_equal(tw.asnumpy()[0], w0[0])


# --------------------------------------------------------------------- #
# embedding training through gluon.Trainer
# --------------------------------------------------------------------- #
def _emb_net(g, kind, opt):
    class Net(g.nn.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.emb = g.nn.Embedding(50, 8, sparse_grad=True) \
                    if kind == "embedding" else \
                    g.contrib.nn.SparseEmbedding(50, 8)
                self.out = g.nn.Dense(1, in_units=8, flatten=False)

        def hybrid_forward(self, F, x, scale):
            return self.out(self.emb(x) * scale)
    return Net()


EMB_CASES = [("embedding", "sgd", {"learning_rate": 0.5, "momentum": 0.9}),
             ("sparse_embedding", "adam", {"learning_rate": 0.05})]


def _train(pkg, ag, net, opt, kw, batches, tr=None):
    if tr is None:
        tr = pkg.gluon.Trainer(net.collect_params(), opt, kw)
    losses = []
    for ids, scale, y in batches:
        with ag.record():
            out = net(ids, scale)
            L = ((out - y) ** 2).mean()
        L.backward()
        tr.step(1)
        losses.append(float(L.asnumpy()))
    return tr, losses


def _batches(pkg_nd, rng_seed, n=3, poison_at=None):
    rng = np.random.RandomState(rng_seed)
    out = []
    for k in range(n):
        ids = rng.randint(0, 50, (6, 4)).astype(np.float32)
        scale = np.ones((1, 1, 8), np.float32)
        if k == poison_at:
            scale[0, 0, 3] = np.nan
        y = rng.randn(6, 4, 1).astype(np.float32)
        out.append((pkg_nd.array(ids), pkg_nd.array(scale),
                    pkg_nd.array(y)))
    return out


@pytest.mark.parametrize("kind,opt,kw", EMB_CASES,
                         ids=["embedding_sgd", "sparse_embedding_adam"])
def test_embedding_training_matches_jax(kind, opt, kw):
    rng = np.random.RandomState(5)
    x0 = [rng.randint(0, 50, (6, 4)).astype(np.float32),
          np.ones((1, 1, 8), np.float32)]
    jnet, tnet = build_pair(lambda: _emb_net(jgluon, kind, opt),
                            lambda: _emb_net(gluon, kind, opt), x0)
    assert sorted(tnet._collect_params_with_prefix()) == \
        sorted(jnet._collect_params_with_prefix())
    weight = [p for n, p in tnet.collect_params().items()
              if n.endswith("weight") and p.shape == (50, 8)][0]
    assert weight._grad_stype == "row_sparse"
    jtr, jl = _train(jmx, jautograd, jnet, opt, kw, _batches(jnd, 6))
    with mx.cpu():
        w_ptr = weight.data()._data.data_ptr()
        w_before = weight.data().asnumpy()
        ttr, tl = _train(mx, autograd, tnet, opt, kw, _batches(nd, 6))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jp = jnet._collect_params_with_prefix()
    for name, p in tnet._collect_params_with_prefix().items():
        assert_close(p.data(), jp[name].data(), rtol=1e-5, atol=1e-7)
    # rows no batch looked up: bitwise unchanged
    rng = np.random.RandomState(6)
    seen = set()
    for _ in range(3):
        seen |= set(rng.randint(0, 50, (6, 4)).ravel().tolist())
        rng.randn(6, 4, 1)
    idle = [r for r in range(50) if r not in seen]
    np.testing.assert_array_equal(weight.data().asnumpy()[idle],
                                  w_before[idle])
    assert weight.data()._data.data_ptr() == w_ptr
    # the fused applier's programs: as many as the JAX applier's traces
    t, j = ttr._fused, jtr._fused
    assert (t.trace_count, t.guard_trace_count, t.skipped_steps) == \
        (j.trace_count, j.guard_trace_count, j.skipped_steps)


@pytest.mark.parametrize("dense_too", [True, False],
                         ids=["with_dense", "all_sparse"])
def test_nonfinite_sparse_gradient_skips_the_step(dense_too):
    kind, opt, kw = EMB_CASES[0]
    rng = np.random.RandomState(7)
    x0 = [rng.randint(0, 50, (6, 4)).astype(np.float32),
          np.ones((1, 1, 8), np.float32)]
    jnet, tnet = build_pair(lambda: _emb_net(jgluon, kind, opt),
                            lambda: _emb_net(gluon, kind, opt), x0)
    if not dense_too:
        for net in (jnet, tnet):
            net.out.collect_params().setattr("grad_req", "null")
    jb = _batches(jnd, 8, n=3, poison_at=1)
    jtr, _ = _train(jmx, jautograd, jnet, opt, kw, jb[:1])
    with mx.cpu():
        tb = _batches(nd, 8, n=3, poison_at=1)
        ttr, _ = _train(mx, autograd, tnet, opt, kw, tb[:1])
        before = {n: p.data().asnumpy().copy()
                  for n, p in tnet._collect_params_with_prefix().items()}
        _train(mx, autograd, tnet, opt, kw, tb[1:2], ttr)
        for n, p in tnet._collect_params_with_prefix().items():
            np.testing.assert_array_equal(p.data().asnumpy(), before[n])
        _train(mx, autograd, tnet, opt, kw, tb[2:], ttr)
    _train(jmx, jautograd, jnet, opt, kw, jb[1:], jtr)
    assert ttr._fused.skipped_steps == jtr._fused.skipped_steps == 1
    assert ttr.last_outcome.value == jtr.last_outcome.value == "APPLIED"
    t, j = ttr._fused, jtr._fused
    assert (t.trace_count, t.guard_trace_count) == \
        (j.trace_count, j.guard_trace_count)
    jp = jnet._collect_params_with_prefix()
    for name, p in tnet._collect_params_with_prefix().items():
        assert_close(p.data(), jp[name].data(), rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------- #
# kvstore, iterator, Module
# --------------------------------------------------------------------- #
def test_row_sparse_pull_bitwise():
    table = np.arange(24, dtype=np.float32).reshape(12, 2)
    with mx.cpu():
        tkv, jkv = mx.kv.create("local"), jmx.kv.create("local")
        tkv.init("emb", nd.array(table))
        jkv.init("emb", jnd.array(table))
        for ids in ([5.0, 2.0, 2.0], [11.0, 0.0], [3.0, 15.0, 3.0]):
            tout = tsp.zeros("row_sparse", (12, 2))
            jout = jsp.zeros("row_sparse", (12, 2))
            ptr = tout._data.data_ptr()
            tkv.row_sparse_pull("emb", out=tout, row_ids=nd.array(ids))
            jkv.row_sparse_pull("emb", out=jout, row_ids=jnd.array(ids))
            same_sparse(tout, jout)
            assert tout._data.data_ptr() == ptr
            dense = nd.ones((12, 2))
            jdense = jnd.ones((12, 2))
            tkv.row_sparse_pull("emb", out=dense, row_ids=nd.array(ids))
            jkv.row_sparse_pull("emb", out=jdense, row_ids=jnd.array(ids))
            same(dense, jdense)
        # a list of keys and outputs; without row_ids it is pull
        tkv.init("b", nd.array(table * 2))
        jkv.init("b", jnd.array(table * 2))
        touts = [tsp.zeros("row_sparse", (12, 2)) for _ in range(2)]
        jouts = [jsp.zeros("row_sparse", (12, 2)) for _ in range(2)]
        tkv.row_sparse_pull(["emb", "b"], out=touts,
                            row_ids=[nd.array([1.0]), nd.array([7.0, 4.0])])
        jkv.row_sparse_pull(["emb", "b"], out=jouts,
                            row_ids=[jnd.array([1.0]), jnd.array([7.0, 4.0])])
        for t, j in zip(touts, jouts):
            same_sparse(t, j)
        whole = nd.zeros((12, 2))
        tkv.row_sparse_pull("emb", out=whole)
        np.testing.assert_array_equal(whole.asnumpy(), table)


def _write_libsvm(path, rng, n, dim, nnz, labels=True):
    with open(path, "w") as f:
        for _ in range(n):
            cols = np.sort(rng.choice(dim, nnz, replace=False))
            vals = rng.randn(nnz)
            lab = int(vals.sum() > 0) if labels else 0
            f.write(f"{lab} " + " ".join(
                f"{c}:{v:.4f}" for c, v in zip(cols, vals)) + "\n")


def test_libsvm_iter_batches_bitwise(tmp_path):
    rng = np.random.RandomState(9)
    data = str(tmp_path / "d.libsvm")
    _write_libsvm(data, rng, 11, 7, 3)
    label = str(tmp_path / "l.libsvm")
    with open(label, "w") as f:
        for k in range(11):
            f.write(f"0 {k % 3}:1.5 {(k + 1) % 3}:-2\n")
    for kw in ({}, {"label_libsvm": label, "label_shape": (3,)},
               {"round_batch": False}):
        tit = mx.io.LibSVMIter(data_libsvm=data, data_shape=(7,),
                               batch_size=4, **kw)
        jit = jmx.io.LibSVMIter(data_libsvm=data, data_shape=(7,),
                                batch_size=4, **kw)
        assert [(d.name, d.shape) for d in tit.provide_data] == \
            [(d.name, d.shape) for d in jit.provide_data]
        assert [(d.name, d.shape) for d in tit.provide_label] == \
            [(d.name, d.shape) for d in jit.provide_label]
        for epoch in range(2):
            tb, jb = list(tit), list(jit)
            assert len(tb) == len(jb) == (2 if kw.get("round_batch") is
                                          False else 3)
            for t, j in zip(tb, jb):
                same_sparse(t.data[0], j.data[0])
                assert t.data[0].context == mx.cpu()
                same(t.label[0], j.label[0])
                assert t.pad == j.pad
            tit.reset()
            jit.reset()
        tit.next()
        jit.next()
        assert tit.tell() == jit.tell()
        pos = tit.tell()
        second = tit.next()
        tit.set_position(pos)
        same_sparse(tit.next().data[0], second.data[0])


def _svm_sym(m):
    data = m.sym.Variable("data")
    net = m.sym.FullyConnected(data, name="fc1", num_hidden=16)
    net = m.sym.Activation(net, act_type="relu")
    net = m.sym.FullyConnected(net, name="fc2", num_hidden=2)
    return m.sym.SoftmaxOutput(net, m.sym.Variable("softmax_label"),
                               name="softmax")


def _svm_fit(m, path, arrays, ctx):
    losses = []

    def record(param):
        losses.append(param.eval_metric.get()[1])
        param.eval_metric.reset()
    rng = np.random.RandomState(1)
    params = {"fc1_weight": rng.randn(16, 6) * 0.3,
              "fc1_bias": rng.randn(16) * 0.1,
              "fc2_weight": rng.randn(2, 16) * 0.3,
              "fc2_bias": np.zeros(2)}
    fresh()
    it = m.io.LibSVMIter(data_libsvm=path, data_shape=(6,), batch_size=8)
    mod = m.mod.Module(_svm_sym(m), context=ctx)
    mod.fit(it, eval_metric=m.metric.CrossEntropy(),
            batch_end_callback=record, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5},
            arg_params={k: arrays(v.astype(np.float32))
                        for k, v in params.items()}, num_epoch=2)
    it.reset()
    return mod, losses, dict(mod.score(it, "acc"))["accuracy"]


def test_module_fit_over_libsvm_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    path = str(tmp_path / "train.libsvm")
    with open(path, "w") as f:
        for _ in range(60):
            x = np.zeros(6, np.float32)
            nz = rng.choice(6, 3, replace=False)
            x[nz] = rng.randn(3)
            f.write(f"{int(x.sum() > 0)} "
                    + " ".join(f"{i}:{x[i]:.4f}" for i in nz) + "\n")
    jmod, jl, jacc = _svm_fit(jmx, path, jnd.array, jmx.cpu())
    with mx.cpu():
        tmod, tl, tacc = _svm_fit(mx, path, lambda v: nd.array(v),
                                  mx.cpu())
    assert len(tl) == len(jl) == 16
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0] and tacc == pytest.approx(jacc)
    ja, _ = jmod.get_params()
    for n, v in tmod.get_params()[0].items():
        assert_close(v, ja[n], rtol=1e-5, atol=1e-6)
    assert tmod._exec.signature_counts() == {
        k: f._cache_size() for k, f in jmod._exec._jit_cache.items()}


def test_serialization_still_refuses_sparse_records(tmp_path):
    path = str(tmp_path / "x.params")
    with mx.cpu():
        nd.save(path, {"w": nd.ones((2, 2))}, format="mxnet")
        raw = bytearray(open(path, "rb").read())
        assert struct.unpack_from("<i", raw, 28)[0] == 0    # dense
        struct.pack_into("<i", raw, 28, 1)                  # row_sparse
        open(path, "wb").write(bytes(raw))
        with pytest.raises(MXNetError, match="sparse storage type 1"):
            nd.load(path)
    with pytest.raises(jmx.MXNetError, match="sparse storage type 1"):
        jnd.load(path)
