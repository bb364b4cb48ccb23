"""The port's ``mx.io`` iterators and ``mx.kv`` store against the JAX
package's, on the CPU.

  - ``NDArrayIter`` (``last_batch_handle`` pad, discard and roll_over,
    two epochs, one and two data arrays), ``CSVIter``, ``ResizeIter`` and
    ``PrefetchingIter``: the same batches, pads and descriptions as the
    JAX iterators on the same numpy arrays (``shuffle=False``: the
    packages draw shuffles from different streams); a shuffled epoch is
    a permutation; a host array gives host batches; the prefetcher
    retries transient read errors and propagates a persistent one;
    ``LibSVMIter``'s CSR batch equals the JAX iterator's and the MNIST
    reader reads;
  - the local store: ``init`` / ``push`` (a list summed) / ``pull`` /
    ``pushpull`` / ``broadcast`` equal the JAX ``KVStore``'s, as do the
    updates of an optimizer set on the store, and its optimizer states
    cross the packages both ways through ``save_optimizer_states`` /
    ``load_optimizer_states``; the multi-worker types and compression
    refuse, as does ``row_sparse_pull`` of a key never initialized.
"""

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd as jnd

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.base import MXNetError

from test_torch_parity import host

_RNG = np.random.RandomState(0)
X = _RNG.randn(23, 3, 2).astype(np.float32)
X2 = _RNG.randint(0, 9, (23, 4)).astype(np.int32)
Y = _RNG.randint(0, 4, (23,)).astype(np.float32)


def batches(it, epochs=2):
    out = []
    for _ in range(epochs):
        it.reset()
        for b in it:
            out.append(([host(d) for d in b.data],
                        [host(lab) for lab in b.label or []], b.pad))
    return out


def same_batches(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for a, b in zip(gd + gl, wd + wl):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("last", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("two", [False, True])
def test_ndarrayiter_batches_equal_jax(last, two):
    data = {"a": X, "b": X2} if two else X
    t = mx.io.NDArrayIter(data, Y, batch_size=5, last_batch_handle=last)
    j = jmx.io.NDArrayIter(data, Y, batch_size=5, last_batch_handle=last)
    assert t.provide_data == j.provide_data
    assert t.provide_label == j.provide_label
    got = batches(t)
    same_batches(got, batches(j))
    assert all(d.device.type == "cpu" for b in t for d in
               [x._data for x in b.data])


def test_shuffled_epoch_is_a_permutation_and_resumes():
    it = mx.io.NDArrayIter(X, np.arange(23, dtype=np.float32),
                           batch_size=23, shuffle=True)
    mx.random.seed(3)
    it.reset()
    a = host(next(it).label[0])
    assert sorted(a.tolist()) == list(range(23))
    assert a.tolist() != list(range(23))
    it.reset()
    pos = it.tell()
    b = host(next(it).label[0])
    it2 = mx.io.NDArrayIter(X, np.arange(23, dtype=np.float32),
                            batch_size=23, shuffle=True)
    it2.set_position(pos)
    np.testing.assert_array_equal(host(next(it2).label[0]), b)
    with pytest.raises(MXNetError, match="samples"):
        mx.io.NDArrayIter(X[:4], batch_size=2).set_position(pos)


def test_csv_and_resize_iters_equal_jax(tmp_path):
    dpath, lpath = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dpath, X.reshape(23, 6), delimiter=",")
    np.savetxt(lpath, Y, delimiter=",")
    for round_batch in (True, False):
        kw = dict(data_csv=dpath, data_shape=(3, 2), label_csv=lpath,
                  batch_size=4, round_batch=round_batch)
        same_batches(batches(mx.io.CSVIter(**kw)),
                     batches(jmx.io.CSVIter(**kw)))
    kw = dict(data_csv=dpath, data_shape=(6,), batch_size=4)
    same_batches(batches(mx.io.CSVIter(**kw)), batches(jmx.io.CSVIter(**kw)))
    for size in (3, 9):
        same_batches(
            batches(mx.io.ResizeIter(mx.io.NDArrayIter(X, Y, 5), size)),
            batches(jmx.io.ResizeIter(jmx.io.NDArrayIter(X, Y, 5), size)))


def test_prefetching_iter_equals_jax_and_fails_loudly(monkeypatch):
    t = mx.io.PrefetchingIter(mx.io.NDArrayIter(X, Y, batch_size=4))
    j = jmx.io.PrefetchingIter(jmx.io.NDArrayIter(X, Y, batch_size=4))
    same_batches(batches(t), batches(j))
    monkeypatch.setenv("MXTPU_IO_RETRY_BACKOFF", "0.001")
    monkeypatch.setenv("MXTPU_IO_FAIL_READS", "2")
    pf = mx.io.PrefetchingIter(mx.io.NDArrayIter(X, Y, batch_size=4))
    assert len(list(pf)) == 6 and pf.read_retries == 2
    monkeypatch.setenv("MXTPU_IO_FAIL_READS", "3")
    pf = mx.io.PrefetchingIter(mx.io.NDArrayIter(X, Y, batch_size=4))
    with pytest.raises(OSError, match="injected"):
        next(pf)

    monkeypatch.delenv("MXTPU_IO_FAIL_READS")

    class Broken(mx.io.DataIter):
        def next(self):
            raise ValueError("bad record")
    with pytest.raises(ValueError, match="bad record"):
        next(mx.io.PrefetchingIter(Broken(4)))


def test_image_and_sparse_iterators_refuse(tmp_path):
    """The iterators that refused before the image and sparse paths were
    ported read now: LibSVMIter's CSR batches equal the JAX iterator's
    (``tests/test_torch_sparse.py`` holds more), the record and MNIST
    readers read (``tests/test_torch_image.py`` holds them against the
    JAX package's)."""
    path = str(tmp_path / "a.libsvm")
    with open(path, "w") as f:
        f.write("1 0:1.5 3:-2\n0 2:0.5\n1 1:2\n")
    tb = mx.io.LibSVMIter(data_libsvm=path, data_shape=(4,),
                          batch_size=2).next()
    jb = jmx.io.LibSVMIter(data_libsvm=path, data_shape=(4,),
                           batch_size=2).next()
    assert tb.data[0].stype == jb.data[0].stype == "csr"
    for part in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(
            getattr(tb.data[0], part).asnumpy(),
            getattr(jb.data[0], part).asnumpy())
    np.testing.assert_array_equal(tb.label[0].asnumpy(),
                                  jb.label[0].asnumpy())
    with mx.cpu():
        it = mx.io.MNISTIter(image=str(tmp_path / "train-images-idx3-ubyte"),
                             batch_size=4)
        assert it.next().data[0].shape == (4, 1, 28, 28)
        missing = str(tmp_path / "missing.rec")
        with pytest.raises(OSError):
            mx.io.ImageRecordIter(missing, (3, 8, 8), 4)
        with pytest.raises(OSError):
            mx.io.ImageDetRecordIter(path_imgrec=missing,
                                     data_shape=(3, 8, 8), batch_size=4)


# --------------------------------------------------------------------- #
# kvstore
# --------------------------------------------------------------------- #

def test_kvstore_ops_equal_jax():
    rng = np.random.RandomState(1)
    vals = [rng.randn(3, 4).astype(np.float32) for _ in range(3)]
    res = {}
    for m, arr, zeros in ((mx, lambda v: nd.array(v, ctx=mx.cpu()),
                           lambda: nd.zeros((3, 4), ctx=mx.cpu())),
                          (jmx, jnd.array, lambda: jnd.zeros((3, 4)))):
        kv = m.kv.create("local")
        assert kv.type == "local" and kv.rank == 0 and kv.num_workers == 1
        kv.init(3, arr(vals[0]))
        kv.init(["a", "b"], [arr(vals[1]), arr(vals[2])])
        outs = [zeros(), zeros()]
        kv.pull(3, out=outs)
        kv.push(3, [arr(v) for v in vals])       # summed
        pulled = zeros()
        kv.pull(3, out=pulled)
        pp = [zeros(), zeros()]
        kv.pushpull(["a", "b"], [[arr(vals[0]), arr(vals[1])],
                                 arr(vals[2])], out=pp)
        bc = zeros()
        kv.broadcast("c", arr(vals[1]), out=bc)
        res[m] = [host(o) for o in outs + [pulled] + pp + [bc]]
        with pytest.raises(Exception, match="not initialized"):
            kv.pull(99, out=zeros())
    for a, b in zip(res[mx], res[jmx]):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_kvstore_optimizer_and_states_cross_packages(tmp_path):
    rng = np.random.RandomState(2)
    w0 = rng.randn(5).astype(np.float32)
    grads = [rng.randn(5).astype(np.float32) for _ in range(3)]
    stores = {}
    for m, arr in ((mx, lambda v: nd.array(v, ctx=mx.cpu())),
                   (jmx, jnd.array)):
        kv = m.kv.create("device")
        kv.set_optimizer(m.optimizer.create("sgd", learning_rate=0.1,
                                            momentum=0.9))
        kv.init(0, arr(w0))
        for g in grads[:2]:
            kv.push(0, arr(g))
        stores[m] = (kv, arr)
    for m in (mx, jmx):
        stores[m][0].save_optimizer_states(str(tmp_path / m.__name__))
    # each package continues from the other's states
    finals = {}
    for m, other in ((mx, jmx), (jmx, mx)):
        kv, arr = stores[m]
        kv.load_optimizer_states(str(tmp_path / other.__name__))
        kv.push(0, arr(grads[2]))
        out = arr(np.zeros(5, np.float32))
        kv.pull(0, out=out)
        finals[m] = host(out)
    np.testing.assert_allclose(finals[mx], finals[jmx], rtol=1e-6)
    assert stores[mx][0]._optimizer.num_update == 3


def test_kvstore_refusals():
    # ported: the dist_* and horovod stores (one worker in one process,
    # as the JAX package's single-process tests run them) and compression
    for t in ("dist_sync", "dist_async", "dist_sync_device", "horovod"):
        kv = mx.kv.create(t)
        assert (kv.type, kv.rank, kv.num_workers) == (t, 0, 1)
    with pytest.raises(MXNetError, match="unknown kvstore"):
        mx.kv.create("nope")
    kv = mx.kv.create()
    kv.set_gradient_compression({"type": "2bit"})
    with pytest.raises(MXNetError, match="compression type"):
        kv.set_gradient_compression({"type": "4bit"})
    # row_sparse_pull is ported (tests/test_torch_sparse.py): a key
    # that was never initialized is refused, as pull refuses it
    with pytest.raises(MXNetError, match="not initialized"):
        kv.row_sparse_pull(0, out=nd.zeros((2, 2), ctx=mx.cpu()),
                           row_ids=nd.array([1.0], ctx=mx.cpu()))
    with pytest.raises(MXNetError, match="no optimizer"):
        kv.save_optimizer_states("x")
