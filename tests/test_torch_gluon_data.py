"""The port's ``gluon.data`` (datasets, samplers, DataLoader, vision
datasets and transforms), ``metric`` and ``gluon.utils`` against the JAX
package's, on the CPU.

  - ``ArrayDataset`` / ``SimpleDataset`` / ``transform`` /
    ``transform_first`` / ``filter`` / ``take`` / ``shard``, the samplers
    and ``BatchSampler``'s ``last_batch`` modes equal the JAX ones;
  - ``DataLoader`` batches equal the JAX loader's with ``shuffle=False``
    (in the calling process, a thread pool and a process pool, which
    starts with ``forkserver`` or ``spawn``, never ``fork``); a shuffled
    epoch is a permutation that ``mx.random.seed`` repeats (the port's
    ``np_rng`` is not the JAX package's threefry-derived stream); batches
    land on the current context (none without CUDA unless the caller asks
    for the CPU);
  - ``MNIST`` / ``FashionMNIST`` / ``CIFAR10`` / ``CIFAR100``: the
    synthetic stand-ins and the standard files equal the JAX datasets'
    (``RecordFileDataset`` and the record and folder image datasets are
    held in ``tests/test_torch_image.py``);
  - every transform's output equals the JAX transform's (the random ones
    by their properties);
  - every metric's value equals the JAX metric's on the same inputs
    (rtol 1e-6), by class and through ``create``;
  - ``split_data`` / ``split_and_load`` / ``clip_global_norm`` /
    ``check_sha1`` / ``download`` (from a ``file://`` URL) equal the JAX
    ones;
  - the classic gluon loop (LeNet over ``DataLoader(MNIST(synthetic=True)
    .transform_first(ToTensor()))``, ``split_and_load``,
    ``autograd.record()``, ``gluon.Trainer("sgd")``, ``metric.Accuracy``)
    learns.
"""

import gzip
import hashlib
import os
import pickle
import struct

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import metric as jmetric
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.gluon import data as jdata
from incubator_mxnet_tpu.gluon import utils as jutils
from incubator_mxnet_tpu.gluon.data.vision import datasets as jds
from incubator_mxnet_tpu.gluon.data.vision import transforms as jtf

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, metric, nd
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon import data as tdata
from incubator_mxnet_tpu_torch.gluon import utils as tutils
from incubator_mxnet_tpu_torch.gluon.data.vision import datasets as tds
from incubator_mxnet_tpu_torch.gluon.data.vision import transforms as ttf

from test_torch_parity import host

RS = np.random.RandomState


def _xs(n=23):
    return (np.arange(n * 3, dtype=np.float32).reshape(n, 3),
            (np.arange(n) % 4).astype(np.int32))


def _items(ds):
    return [tuple(np.asarray(v) for v in (s if isinstance(s, tuple)
                                          else (s,)))
            for s in (ds[i] for i in range(len(ds)))]


def _same_items(a, b):
    ia, ib = _items(a), _items(b)
    assert len(ia) == len(ib)
    for x, y in zip(ia, ib):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def _double(x):
    return x * 2


def _odd_label(sample):
    return sample[1] % 2 == 1


def test_datasets_equal_jax():
    x, y = _xs()
    for mod in (jdata, tdata):
        with pytest.raises(Exception, match="same length"):
            mod.ArrayDataset(x, y[:-1])
    pairs = [(jdata.ArrayDataset(x, y), tdata.ArrayDataset(x, y)),
             (jdata.ArrayDataset(x), tdata.ArrayDataset(x)),
             (jdata.SimpleDataset(list(y)), tdata.SimpleDataset(list(y)))]
    for j, t in pairs[:1]:
        pairs += [(j.transform_first(_double), t.transform_first(_double)),
                  (j.transform(lambda a, b: (b, a)),
                   t.transform(lambda a, b: (b, a))),
                  (j.transform_first(_double, lazy=False),
                   t.transform_first(_double, lazy=False)),
                  (j.filter(_odd_label), t.filter(_odd_label)),
                  (j.take(5), t.take(5)), (j.shard(3, 1), t.shard(3, 1))]
    for j, t in pairs:
        _same_items(j, t)
    with pytest.raises(MXNetError, match="out of range"):
        tdata.ArrayDataset(x).shard(2, 2)
    with pytest.raises(FileNotFoundError):  # a reader now (test_torch_image)
        tdata.RecordFileDataset("no.rec")


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_equal_jax(last_batch):
    def epochs(mod):
        bs = mod.BatchSampler(mod.SequentialSampler(10, start=2), 4,
                              last_batch)
        return [list(bs), list(bs), len(bs)]
    assert epochs(tdata) == epochs(jdata)
    ds = tdata.ArrayDataset(*_xs())
    for cls, args in ((tdata.sampler.IntervalSampler, (10, 3)),
                      (tdata.sampler.IntervalSampler, (10, 3, False))):
        jcls = getattr(jdata.sampler, cls.__name__)
        assert list(cls(*args)) == list(jcls(*args))
        assert len(cls(*args)) == len(jcls(*args))
    assert list(tdata.sampler.FilterSampler(_odd_label, ds)) == \
        list(jdata.sampler.FilterSampler(_odd_label,
                                         jdata.ArrayDataset(*_xs())))
    with pytest.raises(MXNetError, match="last_batch"):
        tdata.BatchSampler(tdata.SequentialSampler(3), 2, "pad")


def _batches(loader):
    return [tuple(host(b) for b in batch) for batch in loader]


@pytest.mark.parametrize("workers", ["none", "threads", "processes"])
def test_dataloader_batches_equal_jax(workers):
    x, y = _xs()
    kw = {"none": {}, "threads": dict(num_workers=2, thread_pool=True),
          "processes": dict(num_workers=2)}[workers]
    want = _batches(jdata.DataLoader(jdata.ArrayDataset(x, y),
                                     batch_size=5, last_batch="rollover"))
    loader = tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=5,
                              last_batch="rollover", **kw)
    if workers == "processes":
        assert loader._pool._ctx.get_start_method() in ("forkserver",
                                                        "spawn")
    with mx.cpu():
        got = _batches(loader)
        batch = next(iter(loader))
    assert len(got) == len(want) == len(loader) == 4
    for g, w in zip(got, want):
        for u, v in zip(g, w):
            np.testing.assert_array_equal(u, v)
    assert batch[0].context == mx.cpu(0)
    assert str(batch[0].dtype) == "float32" and str(batch[1].dtype) == "int32"


def test_dataloader_shuffle_and_context():
    x, y = _xs(40)
    loader = tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=8,
                              shuffle=True)
    with mx.cpu():
        mx.random.seed(3)
        first = np.concatenate([host(b[1]) for b in loader])
        e1 = np.concatenate([host(b[0])[:, 0] for b in loader])
        mx.random.seed(3)
        again = np.concatenate([host(b[1]) for b in loader])
    np.testing.assert_array_equal(first, again)
    assert sorted(e1 // 3) == list(range(40))
    assert list(e1 // 3) != list(range(40))
    rng1, rng2 = mx.random.np_rng(), mx.random.np_rng()
    assert rng1.randint(1 << 30) != rng2.randint(1 << 30)
    with pytest.raises(MXNetError, match="batch_size"):
        tdata.DataLoader(tdata.ArrayDataset(x))
    with pytest.raises(MXNetError, match="shuffle"):
        tdata.DataLoader(tdata.ArrayDataset(x), batch_size=2, shuffle=True,
                         sampler=tdata.SequentialSampler(40))
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            next(iter(tdata.DataLoader(tdata.ArrayDataset(x),
                                       batch_size=2)))


def _write_idx(path, arr):
    header = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with gzip.open(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


def _write_cifar(root, fine):
    rng = RS(5)
    if fine:
        base = os.path.join(root, "cifar-100-python")
        os.makedirs(base)
        for name, n in (("train", 6), ("test", 3)):
            with open(os.path.join(base, name), "wb") as f:
                pickle.dump({"data": rng.randint(0, 255, (n, 3072)),
                             "fine_labels": list(rng.randint(0, 100, n)),
                             "coarse_labels": list(rng.randint(0, 20, n))},
                            f)
        return
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({"data": rng.randint(0, 255, (2, 3072)),
                         "labels": list(rng.randint(0, 10, 2))}, f)


def test_vision_datasets_equal_jax(tmp_path):
    for name in ("MNIST", "FashionMNIST", "CIFAR10", "CIFAR100"):
        for train in (True, False):
            kw = dict(root=str(tmp_path / "none"), train=train,
                      synthetic=True, synthetic_size=60)
            _same_items(getattr(jds, name)(**kw), getattr(tds, name)(**kw))
    with pytest.raises(MXNetError, match="synthetic=True"):
        tds.MNIST(root=str(tmp_path / "none"))
    mnist = tmp_path / "mnist"
    mnist.mkdir()
    rng = RS(4)
    _write_idx(mnist / "train-images-idx3-ubyte.gz",
               rng.randint(0, 255, (5, 28, 28)))
    _write_idx(mnist / "train-labels-idx1-ubyte.gz", rng.randint(0, 10, 5))
    _same_items(jds.MNIST(root=str(mnist)), tds.MNIST(root=str(mnist)))
    for fine in (True, False):
        root = str(tmp_path / f"cifar{fine}")
        _write_cifar(root, fine)
        cls = "CIFAR100" if fine else "CIFAR10"
        for train in (True, False):
            _same_items(getattr(jds, cls)(root=root, train=train),
                        getattr(tds, cls)(root=root, train=train))
    tf = lambda img, label: (img.mean(), label + 1)  # noqa: E731
    _same_items(jds.MNIST(root=str(mnist), transform=tf),
                tds.MNIST(root=str(mnist), transform=tf))


def _img(h=10, w=12, seed=0):
    return (RS(seed).rand(h, w, 3) * 255).astype(np.uint8)


TRANSFORMS = {
    "ToTensor": lambda t: t.ToTensor(),
    "Normalize": lambda t: t.Compose([t.ToTensor(), t.Normalize(
        [0.5, 0.4, 0.3], [0.2, 0.3, 0.4])]),
    "Normalize-scalar": lambda t: t.Compose([t.Cast(), t.Normalize(3.0,
                                                                   2.0)]),
    "Resize": lambda t: t.Resize(7),
    "Resize-wh": lambda t: t.Resize((5, 8)),
    "CenterCrop": lambda t: t.CenterCrop((6, 4)),
    "Cast": lambda t: t.Cast("float16"),
    "Lambda": lambda t: t.Lambda(lambda x: x[::2]),
    "Compose": lambda t: t.Compose([t.Resize(8), t.CenterCrop(6),
                                    t.ToTensor()]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_equals_jax(name):
    img = _img()
    want = TRANSFORMS[name](jtf)(img)
    got = TRANSFORMS[name](ttf)(img)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, np.asarray(want))
    with mx.cpu():
        from_nd = TRANSFORMS[name](ttf)(nd.array(img, dtype="uint8"), 7)
    np.testing.assert_array_equal(from_nd[0], got)
    assert from_nd[1] == 7


def test_random_transforms():
    img = _img()
    mx.random.seed(1)
    crops = [ttf.RandomCrop(5, pad=2)(img) for _ in range(8)]
    assert all(c.shape == (5, 5, 3) for c in crops)
    assert len({c.tobytes() for c in crops}) > 1
    flips = [ttf.RandomFlipLeftRight()(img) for _ in range(16)]
    assert all(np.array_equal(f, img) or np.array_equal(f, img[:, ::-1])
               for f in flips)
    assert any(not np.array_equal(f, img) for f in flips)
    tb = [ttf.RandomFlipTopBottom()(img) for _ in range(16)]
    assert all(np.array_equal(f, img) or np.array_equal(f, img[::-1])
               for f in tb)
    rrc = ttf.RandomResizedCrop(6)(img)
    assert rrc.shape == (6, 6, 3)
    mx.random.seed(1)
    assert np.array_equal(ttf.RandomCrop(5, pad=2)(img), crops[0])


def _cls_inputs(seed, n=12, k=4):
    rng = RS(seed)
    p = rng.rand(n, k).astype(np.float32)
    return rng.randint(0, k, (n,)).astype(np.float32), p / p.sum(1,
                                                                 keepdims=True)


def _bin_inputs(seed, n=20):
    rng = RS(seed)
    return (rng.randint(0, 2, (n,)).astype(np.float32),
            rng.rand(n, 2).astype(np.float32))


def _reg_inputs(seed, shape=(6, 3)):
    rng = RS(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _mae_np(label, pred):
    return float(np.abs(label - pred).sum()), label.size


METRICS = {
    "Accuracy": (lambda m: m.Accuracy(), _cls_inputs),
    "Accuracy-col": (lambda m: m.Accuracy(), lambda s: (
        _cls_inputs(s)[0][:, None], _cls_inputs(s)[1])),
    "TopKAccuracy": (lambda m: m.TopKAccuracy(top_k=2), _cls_inputs),
    "F1": (lambda m: m.F1(), _bin_inputs),
    "MCC": (lambda m: m.MCC(), _bin_inputs),
    "MAE": (lambda m: m.MAE(), _reg_inputs),
    "MSE": (lambda m: m.MSE(), _reg_inputs),
    "RMSE": (lambda m: m.RMSE(), lambda s: _reg_inputs(s, (7,))),
    "CrossEntropy": (lambda m: m.CrossEntropy(), _cls_inputs),
    "NegativeLogLikelihood": (lambda m: m.NegativeLogLikelihood(),
                              _cls_inputs),
    "Perplexity": (lambda m: m.Perplexity(ignore_label=1), _cls_inputs),
    "Perplexity-all": (lambda m: m.Perplexity(), _cls_inputs),
    "PearsonCorrelation": (lambda m: m.PearsonCorrelation(),
                           lambda s: _reg_inputs(s, (9,))),
    "Loss": (lambda m: m.Loss(), lambda s: (None, _reg_inputs(s)[1])),
    "CustomMetric": (lambda m: m.CustomMetric(_mae_np), _reg_inputs),
    "np_metric": (lambda m: m.np_metric(name="l1")(_mae_np), _reg_inputs),
    "create-acc": (lambda m: m.create("acc"), _cls_inputs),
    "create-list": (lambda m: m.create(["mse", "mae"]), _reg_inputs),
    "create-fn": (lambda m: m.create(_mae_np), _reg_inputs),
    "Composite": (lambda m: m.CompositeEvalMetric(["rmse", m.MAE()]),
                  _reg_inputs),
    "Torch": (lambda m: m.create("torch"), lambda s: (None,
                                                      _reg_inputs(s)[1])),
}


def _nd(pkg, a):
    if a is None:
        return None
    return pkg.array(a) if pkg is jnd else pkg.array(a, ctx=mx.cpu())


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_equals_jax(name):
    make, inputs = METRICS[name]
    with mx.cpu():
        jm, tm = make(jmetric), make(metric)
        for seed in (0, 1):
            label, pred = inputs(seed)
            jm.update(_nd(jnd, label), _nd(jnd, pred))
            if seed:
                tm.update(_nd(nd, label), _nd(nd, pred))
            else:   # a list of pairs, and plain tensors
                tm.update([torch.tensor(label) if label is not None
                           else None], [torch.tensor(pred)])
        jn, jv = jm.get()
        tn, tv = tm.get()
        assert tn == jn
        np.testing.assert_allclose(tv, jv, rtol=1e-6)
        assert tm.get_name_value() == [tuple(v) for v in
                                       zip(*(([tn], [tv]) if isinstance(
                                           tn, str) else (tn, tv)))]
        tm.reset()
        assert isinstance(tm, metric.CompositeEvalMetric) or \
            tm.num_inst == 0


def test_metric_surface():
    with mx.cpu():
        acc = metric.Accuracy()
        assert acc.sum_metric.device.type == "cpu"
        assert np.isnan(acc.get()[1])
        with pytest.raises(MXNetError, match="not registered"):
            metric.create("no-such-metric")
        with pytest.raises(MXNetError, match="pair up"):
            acc.update([nd.ones((2,))], nd.ones((2, 3)))
        assert "accuracy" in str(acc)
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            metric.Accuracy()


def test_gluon_utils_equal_jax(tmp_path):
    x = RS(0).randn(6, 4).astype(np.float32)
    with mx.cpu():
        for n, even in ((3, True), (4, False)):
            want = jutils.split_data(jnd.array(x), n, even_split=even)
            got = tutils.split_data(nd.array(x), n, even_split=even)
            assert [g.shape for g in got] == [w.shape for w in want]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(host(g), host(w))
        with pytest.raises(MXNetError, match="evenly"):
            tutils.split_data(nd.array(x), 4)
        parts = tutils.split_and_load(x, [mx.cpu(0), mx.cpu(1)],
                                      batch_axis=1)
        assert [p.shape for p in parts] == [(6, 2), (6, 2)]
        np.testing.assert_array_equal(
            host(tutils.split_and_load(nd.array(x), [mx.cpu()])[0]), x)
        assert gluon.split_and_load is tutils.split_and_load
        for max_norm in (0.5, 100.0):
            arrays = [RS(i).randn(3, 2).astype(np.float32) for i in range(3)]
            jarr = [jnd.array(a) for a in arrays]
            tarr = [nd.array(a) for a in arrays]
            jn = jutils.clip_global_norm(jarr, max_norm)
            tn = tutils.clip_global_norm(tarr, max_norm)
            np.testing.assert_allclose(tn, jn, rtol=1e-6)
            for t, j in zip(tarr, jarr):
                np.testing.assert_allclose(host(t), host(j), rtol=1e-6)
        with pytest.warns(UserWarning, match="nan or inf"):
            tutils.clip_global_norm([nd.array([np.inf, 1.0])], 1.0)
    src = tmp_path / "blob.bin"
    src.write_bytes(b"abc" * 1000)
    sha = hashlib.sha1(src.read_bytes()).hexdigest()
    assert tutils.check_sha1(str(src), sha) == jutils.check_sha1(str(src),
                                                                 sha)
    assert not tutils.check_sha1(str(src), "0" * 40)
    out = tutils.download("file://" + str(src), path=str(tmp_path / "d"),
                          sha1_hash=sha)
    assert out == str(tmp_path / "d") and tutils.check_sha1(out, sha)
    assert tutils.download("file://" + str(src), path=out) == out
    with pytest.raises(OSError):
        tutils.download("file://" + str(tmp_path / "missing"),
                        path=str(tmp_path / "m"), retries=1)


def test_classic_gluon_loop_learns():
    with mx.cpu():
        mx.random.seed(0)
        data = tdata.DataLoader(
            tds.MNIST(synthetic=True, synthetic_size=1920)
            .transform_first(ttf.ToTensor()), batch_size=64)
        net = mx.models.LeNet()
        net.initialize(mx.init.Xavier())
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        acc = metric.Accuracy()
        losses = []
        for epoch in range(2):
            acc.reset()
            for x, y in data:
                x = gluon.utils.split_and_load(x, [mx.cpu()])[0]
                y = gluon.utils.split_and_load(y, [mx.cpu()])[0]
                with autograd.record():
                    out = net(x)
                    L = loss_fn(out, y)
                L.backward()
                trainer.step(x.shape[0])
                acc.update(y, out)
                losses.append(float(L.mean().asscalar()))
    assert np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5])
    assert acc.get()[1] > 0.5
