"""The port's small modules against the JAX package's, on the CPU:
``monitor``, ``profiler``, ``operator`` (``nd.Custom``), ``engine``,
``util``, ``test_utils``, ``rtc`` and the top-level names.

  - ``Monitor`` on the same block and input: the JAX Monitor's rows
    (batch, name) and stats within 1e-6, ``interval`` and ``pattern``
    honored;
  - the profiler's dump has the JAX dump's top-level keys, event names,
    categories, phases and event keys (host events; no device trace
    without CUDA), ``dumps`` the same table rows, ``mfu`` the same value;
  - a Custom op's forward and backward (one and two outputs) equal the
    JAX op's; an unknown type raises; inside a CUDA graph capture it
    raises ``MXNetError`` naming the capture (``cuda``-marked: a
    departure by design, ROADMAP);
  - ``engine``, ``util`` and ``test_utils`` behave as the JAX tests
    (``tests/test_infra.py``, ``tests/test_custom_launch.py``) state;
    ``check_consistency``'s function form compares ``cpu()`` with
    ``gpu(0)`` by default (``cuda``-marked);
  - ``rtc.CudaModule`` refuses; ``cpu_pinned``, ``gpu_memory_info``,
    ``num_devices`` and the lazy modules exist at the top level;
    ``num_tpus()`` is 0 and ``tpu()`` raises naming ``gpu()``;
  - ``tools/phase_times.py`` runs a checkout's ``chip_smoke.py`` with
    each ``phase_*`` call timed in order, and passes its exit code on.
"""

import json
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, nd
from incubator_mxnet_tpu_torch.base import MXNetError

from test_torch_parity import assert_close, build_pair


def _mlp(g):
    net = g.nn.HybridSequential()
    net.add(g.nn.Dense(8, activation="relu", in_units=5),
            g.nn.Dense(3, in_units=8))
    return net


def test_monitor_rows_equal_jax():
    x = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    jnet, tnet = build_pair(lambda: _mlp(jgluon), lambda: _mlp(gluon))
    rows = {}
    for name, m, net, arr in (("jax", jmx, jnet, jnd.array(x)),
                              ("port", mx, tnet, None)):
        with mx.cpu():
            a = arr if arr is not None else nd.array(x)
            mon = m.monitor.Monitor(interval=2, pattern=".*output",
                                    sort=True).install(net)
            got = []
            for _ in range(3):
                mon.tic()
                net(a)
                got.append(mon.toc())
            rows[name] = got
    assert [len(r) for r in rows["port"]] == [len(r) for r in rows["jax"]]
    counts = [len(r) for r in rows["port"]]
    assert counts[0] == counts[2] > 0 and counts[1] == 0
    for tr, jr in zip(rows["port"], rows["jax"]):
        for (ts, tn, tv), (js, jn, jv) in zip(tr, jr):
            assert (ts, tn) == (js, jn)
            np.testing.assert_allclose(tv, jv, rtol=1e-6)
    assert mx.mon.Monitor is mx.monitor.Monitor


def _profile(m, path):
    prof = m.profiler
    prof.set_config(filename=path, aggregate_stats=True)
    prof.start()
    with prof.scope("fwd"):
        m.nd.ones((8, 8)).sum().asnumpy()
    ev = prof.ProfileEvent("manual")
    ev.start()
    ev.stop()
    task = prof.Task(prof.Domain("train"), "step")
    task.start()
    task.stop()
    prof.Frame("frame0").start()
    c = prof.Counter("batches")
    c.increment(3)
    c.decrement()
    prof.Marker("epoch_end").mark()
    prof.pause()
    with prof.scope("paused"):
        pass
    prof.resume()
    assert prof.state_string() == "run"
    prof.stop()
    with open(prof.dump()) as f:
        trace = json.load(f)
    return trace, prof.dumps(reset=True)


def test_profiler_dump_equals_jax(tmp_path):
    jt, jtab = _profile(jmx, str(tmp_path / "j.json"))
    with mx.cpu():
        tt, ttab = _profile(mx, str(tmp_path / "t.json"))
    assert sorted(tt) == sorted(jt) and tt["displayTimeUnit"] == \
        jt["displayTimeUnit"]

    def shape(trace):
        return [(e["name"], e.get("cat"), e["ph"], sorted(e))
                for e in trace["traceEvents"]]
    assert shape(tt) == shape(jt)
    assert [r.split()[:2] for r in ttab.splitlines()] == \
        [r.split()[:2] for r in jtab.splitlines()]
    assert mx.profiler.mfu(1e12, 1.0, n_chips=2, peak_flops_per_chip=2e12) \
        == jmx.profiler.mfu(1e12, 1.0, n_chips=2,
                            peak_flops_per_chip=2e12) == 0.25
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.profiler.mfu(1e12, 1.0)          # the card's peak: needs a card
    with pytest.raises(MXNetError, match="unknown state"):
        mx.profiler.set_state("maybe")


class _Scale:
    def __init__(self, f):
        self.f = f

    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0], in_data[0] * self.f)
        if len(out_data) > 1:
            self.assign(out_data[1], req[1], in_data[0] + in_data[1])

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        g = out_grad[0] * self.f
        if len(out_grad) > 1:
            self.assign(in_grad[1], req[1], out_grad[1])
            g = g + out_grad[1]
        self.assign(in_grad[0], req[0], g)


def _register(m):
    op_cls = type("ScaleOp", (_Scale, m.operator.CustomOp), {})

    class OneProp(m.operator.CustomOpProp):
        def __init__(self, factor=2.0):
            super().__init__(need_top_grad=True)
            self.factor = float(factor)

        def create_operator(self, ctx, shapes, dtypes):
            return op_cls(self.factor)

    class TwoProp(OneProp):
        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["scaled", "sum"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

    m.operator.register("torch_test_scale")(OneProp)
    m.operator.register("torch_test_pair")(TwoProp)


def _custom_run(m, ag, ndm, a, b):
    x, y = ndm.array(a), ndm.array(b)
    x.attach_grad()
    y.attach_grad()
    with ag.record():
        one = ndm.Custom(x, op_type="torch_test_scale", factor=3.0)
        s, t = ndm.Custom(x, y, op_type="torch_test_pair", factor=0.5)
        loss = (one * one).sum() + (s * t).sum()
    loss.backward()
    return [one, s, t, x.grad, y.grad]


def test_custom_op_equals_jax():
    _register(jmx)
    _register(mx)
    rng = np.random.RandomState(2)
    a = rng.randn(2, 3).astype(np.float32)
    b = rng.randn(2, 3).astype(np.float32)
    want = _custom_run(jmx, jautograd, jnd, a, b)
    with mx.cpu():
        got = _custom_run(mx, autograd, nd, a, b)
    for g, w in zip(got, want):
        assert_close(g, w, rtol=1e-6)
    assert {"torch_test_scale", "torch_test_pair"} <= \
        set(mx.operator.get_all_registered())
    with mx.cpu(), pytest.raises(MXNetError, match="not registered"):
        nd.Custom(nd.ones((2,)), op_type="nope")
    with pytest.raises(MXNetError, match="op_type"):
        nd.Custom(nd.ones((2,), ctx=mx.cpu()))
    with pytest.raises(MXNetError, match="CustomOpProp"):
        mx.operator.register("bad")(object)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return mx.gpu(0)


@pytest.mark.cuda
def test_custom_op_refuses_inside_a_capture(card):
    _register(mx)
    x = nd.ones((4,), ctx=card)
    g = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        with pytest.raises(MXNetError, match="CUDA graph capture"):
            with torch.cuda.graph(g):
                nd.Custom(x, op_type="torch_test_scale", factor=2.0)


def test_engine_and_util_behave_as_jax():
    for m in (jmx, mx):
        prev = m.engine.set_sync(True)
        try:
            assert m.engine.is_sync()
            with mx.cpu():
                y = (m.nd.ones((4, 4)) * 2).sum()
            assert float(y.asnumpy()) == 32.0
        finally:
            m.engine.set_sync(prev)
        assert m.engine.is_sync() == prev
        m.engine.wait_all()
        with m.engine.bulk(16):
            assert m.engine.set_bulk_size(16) == 16
        assert m.engine.set_bulk_size(0) == 0
        assert os.environ.get("MXTPU_TEST_KNOB") is None
        with m.util.environment("MXTPU_TEST_KNOB", "7"):
            assert m.util.getenv("MXTPU_TEST_KNOB") == "7"
            with m.util.environment({"MXTPU_TEST_KNOB": None}):
                assert m.util.getenv("MXTPU_TEST_KNOB") is None
        assert os.environ.get("MXTPU_TEST_KNOB") is None
        m.util.setenv("MXTPU_TEST_KNOB", "1")
        m.util.setenv("MXTPU_TEST_KNOB", None)
        assert not m.util.is_np_array()
        with m.util.np_array(True):
            assert m.util.is_np_array()
        with m.util.np_shape(True):
            assert m.util.is_np_shape()
        m.util.set_np()
        assert m.util.is_np_array() and m.util.is_np_shape()
        m.util.reset_np()
        assert not m.util.is_np_array() and not m.util.is_np_shape()
        with pytest.raises(ValueError):
            m.util.set_np(shape=False, array=True)

        @m.util.use_np
        def inside():
            return m.util.is_np_array(), m.util.is_np_shape()
        assert inside() == (True, True) and not m.util.is_np_array()


def test_test_utils_behave_as_jax():
    from incubator_mxnet_tpu import test_utils as jtu
    from incubator_mxnet_tpu_torch import test_utils as ttu
    with mx.cpu():
        assert ttu.default_context() == mx.cpu()
        a = np.float32([1.0, 2.0])
        b = a + np.float32(5e-6)
        for tu in (ttu, jtu):
            assert tu.same(a, a.copy()) and not tu.same(a, b)
            assert tu.almost_equal(a, b)
            tu.assert_almost_equal(a, b)
            with pytest.raises(AssertionError, match="differ"):
                tu.assert_almost_equal(a, a + 1)
        r = ttu.rand_ndarray((3, 2), low=0.0, high=0.5)
        assert r.shape == (3, 2) and 0 <= r.asnumpy().min() and \
            r.asnumpy().max() <= 0.5 and r.context == mx.cpu()
        x = nd.array(np.random.RandomState(0).rand(2, 3) + 0.5)
        ttu.check_numeric_gradient(lambda v: nd.sin(v * v), [x])
        with pytest.raises(AssertionError, match="analytic_grad"):
            ttu.check_numeric_gradient(
                lambda v: autograd_wrong(v), [x])
        sym = mx.sym.FullyConnected(mx.sym.Variable("data"), name="fc",
                                    num_hidden=4)
        ttu.check_consistency(sym, [
            {"ctx": mx.cpu(), "data": (2, 3),
             "type_dict": {"data": np.float32}},
            {"ctx": mx.cpu(), "data": (2, 3),
             "type_dict": {"data": np.float16}}])
        with pytest.raises(MXNetError, match="must agree on shapes"):
            ttu.check_consistency(sym, [{"ctx": mx.cpu(), "data": (2, 3)},
                                        {"ctx": mx.cpu(), "data": (2, 4)}])
        ms = mx.sym.split(mx.sym.Variable("data"), num_outputs=2, axis=1)
        ttu.check_consistency(ms, [
            {"ctx": mx.cpu(), "data": (2, 4)},
            {"ctx": mx.cpu(), "data": (2, 4),
             "type_dict": {"data": np.float16}}])
        es = mx.sym.Embedding(mx.sym.Variable("data"), name="emb",
                              input_dim=4, output_dim=3)
        ttu.check_consistency(es, [
            {"ctx": mx.cpu(), "data": (5,),
             "type_dict": {"data": np.int32}},
            {"ctx": mx.cpu(), "data": (5,),
             "type_dict": {"data": np.int32}}])
        ttu.check_consistency(lambda v: nd.relu(v) * 2,
                              [np.float32([-1.0, 2.0])],
                              ctx_list=[mx.cpu(), mx.cpu()])
    seen = []

    @ttu.with_seed(11)
    def draw():
        seen.append(np.random.rand())
    draw()
    draw()
    assert seen[0] == seen[1]
    with ttu.environment("MXTPU_TEST_KNOB", "3"):
        assert os.environ["MXTPU_TEST_KNOB"] == "3"
    assert os.environ.get("MXTPU_TEST_KNOB") is None


class _WrongGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v):
        return v * 2

    @staticmethod
    def backward(ctx, g):
        return g * 3


def autograd_wrong(v):
    """2 v with a wrong (3) gradient, for check_numeric_gradient."""
    return mx.NDArray(_WrongGrad.apply(v._data))


@pytest.mark.cuda
def test_check_consistency_compares_cpu_with_the_card(card):
    from incubator_mxnet_tpu_torch import test_utils as ttu
    ttu.check_consistency(lambda v: nd.softmax(v * 3),
                          [np.random.RandomState(0).randn(4, 5)
                           .astype(np.float32)])
    free, total = mx.gpu_memory_info(0)
    assert 0 < free <= total


def test_rtc_and_top_level_names():
    with pytest.raises(MXNetError, match="csrc/"):
        mx.rtc.CudaModule("__global__ void k() {}")
    with pytest.raises(jmx.MXNetError):
        jmx.rtc.CudaModule("__global__ void k() {}")
    for name in ("monitor", "mon", "profiler", "operator", "engine",
                 "util", "test_utils", "rtc", "contrib", "cpu_pinned",
                 "gpu_memory_info", "num_devices", "num_tpus", "tpu"):
        assert hasattr(mx, name) and hasattr(jmx, name), name
    assert mx.cpu_pinned(0).device_type == jmx.cpu_pinned(0).device_type \
        == "cpu_pinned"
    assert mx.num_devices() == 1 + mx.num_gpus()
    # the decision: the port has no TPU context
    assert mx.num_tpus() == 0
    with pytest.raises(MXNetError, match=r"mx\.gpu\(1\)"):
        mx.tpu(1)
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            mx.gpu_memory_info()
    assert {"quantize_net", "onnx", "text", "SVRGModule"} <= \
        set(mx.contrib.__all__) == set(jmx.contrib.__all__)


def test_phase_times_times_each_phase(tmp_path):
    import subprocess
    import sys
    (tmp_path / "chip_smoke.py").write_text(
        "import sys, time\n"
        "def phase_wait():\n    time.sleep(0.05)\n"
        "def phase_echo(x):\n    return x\n"
        "def main():\n"
        "    phase_wait(); phase_echo(1); phase_wait()\n"
        "    return 0 if sys.argv[1:] == [] else 3\n")
    out = tmp_path / "times.json"
    tool = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "incubator_mxnet_tpu_torch", "tools",
        "phase_times.py")
    proc = subprocess.run([sys.executable, tool, str(tmp_path), "--out",
                           str(out)], capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(out.read_text())
    assert [name for name, _ in res["phases"]] == ["wait", "echo", "wait"]
    assert res["phases"][0][1] >= 0.05 and res["rc"] == 0
    assert res["total_s"] >= res["phases"][0][1] + res["phases"][2][1]
    assert "[phase_times] " in proc.stdout
