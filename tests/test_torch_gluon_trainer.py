"""The port's ``gluon.Trainer`` and its fused applier against the JAX
package's, on the CPU (where each applier program runs its body eagerly
every call and a build is counted at a signature's first meeting, as the
JAX jit counts traces; on the card each build is a CUDA graph capture,
held by ``chip_smoke.py`` and ``tests/test_torch_train_graphs.py``).

The same small Dense net (the JAX tests' ``_build_net``: 8 -> 16 relu ->
4) is built in both packages, the JAX net's weights copied across:

  - every optimizer of the registry, 3 steps through each package's
    Trainer: the losses at rtol 1e-5 and the weights at the stated
    tolerance (SGLD, whose noise comes from each package's own
    generator, by the noise's spread); the trace counts equal;
  - the fused path equals the eager per-parameter path
    (``fuse_step=False``), as ``test_fused_matches_eager`` holds it;
  - ``trace_count``, ``guard_trace_count``, ``accum_trace_count`` and
    ``call_count`` equal the JAX applier's in the JAX tests' scenarios:
    steady state and an lr change (``tests/test_fused_step.py:61-82``), a
    wd change and mixed dtypes (``:111-164``), non-finite skips under a
    loss scaler (``tests/test_train_resilience.py:135-136``, ``:234-235``)
    and ``accumulate_grads`` (``tests/test_train_perf.py:314``, ``:340``);
  - a skipped step leaves the weights and the optimizer state
    bit-identical with one ``SKIPPED_NONFINITE`` outcome; the loss scale
    halves on overflow and doubles after ``scale_window`` clean steps,
    step for step as the JAX Trainer's; consecutive skips halt; stale
    gradients warn or skip;
  - ``save_states`` / ``load_states`` restore into the live state
    tensors, the options the port does not have are refused, and the
    checkpoint entry points run.
"""

import contextlib
import warnings

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.amp import LossScaler as JLossScaler
from incubator_mxnet_tpu.base import MXNetError as JMXNetError

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd as tag
from incubator_mxnet_tpu_torch import gluon as tgluon
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch.amp import LossScaler as TLossScaler
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.checkpoint import CheckpointManager
from incubator_mxnet_tpu_torch.train import StepOutcome

from test_torch_parity import copy_params


class Pkg:
    def __init__(self, mxm, nd, ag, gluon, scaler, err, ctx):
        self.mx, self.nd, self.ag, self.gluon = mxm, nd, ag, gluon
        self.LossScaler, self.Error, self.ctx = scaler, err, ctx


JAX = Pkg(jmx, jnd, jag, jgluon, JLossScaler, JMXNetError,
          contextlib.nullcontext)
PORT = Pkg(mx, tnd, tag, tgluon, TLossScaler, MXNetError, mx.cpu)


def _net(P, dtype="float32", seed=0):
    P.mx.random.seed(seed)
    net = P.gluon.nn.Sequential()
    net.add(P.gluon.nn.Dense(16, in_units=8, activation="relu",
                             dtype=dtype),
            P.gluon.nn.Dense(4, in_units=16, dtype=dtype))
    with P.ctx():
        net.initialize()
    return net


def _pair(dtype="float32", seed=0):
    jnet = _net(JAX, dtype, seed)
    tnet = _net(PORT, dtype, seed)
    copy_params(jnet, tnet)
    return jnet, tnet


def _poison(P, net):
    """A NaN in the first parameter's gradient (after backward)."""
    g = next(iter(net.collect_params().values())).grad()
    if P is JAX:
        g._data = g._data.at[0, 0].set(np.nan)
    else:
        g._data[0, 0] = float("nan")


def _run(P, net, tr, steps, poison_at=(), accum=None, seed=1,
         scaled=False):
    """``steps`` steps of MSE on seeded data; ``accum`` = microbatches per
    step. Returns the losses, the outcomes and the loss scales."""
    rng = np.random.RandomState(seed)
    losses, outcomes, scales = [], [], []
    with P.ctx():
        for step in range(steps):
            k = accum or 1
            for _ in range(k):
                x = P.nd.array(rng.randn(8, 8).astype(np.float32))
                y = P.nd.array(rng.randn(8, 4).astype(np.float32))
                with P.ag.record():
                    loss = ((net(x) - y) ** 2).mean()
                if scaled:
                    tr.backward(loss)
                else:
                    loss.backward()
                if step in poison_at:
                    _poison(P, net)
                if accum:
                    tr.accumulate_grads()
            try:
                tr.step(k if accum else 8)
            except P.Error as e:
                assert "poisoned" in str(e)
            losses.append(float(loss.asnumpy()))
            outcomes.append(tr.last_outcome.value)
            scales.append(None if tr.loss_scaler is None
                          else tr.loss_scaler.loss_scale)
    return losses, outcomes, scales


def _weights(net):
    return [p.data().asnumpy().astype(np.float64)
            for p in net.collect_params().values()]


def _counts(tr):
    f = tr._fused
    return None if f is None else (f.trace_count, f.guard_trace_count,
                                   f.accum_trace_count, f.call_count)


OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}, 1e-6),
    ("sgd", {"learning_rate": 0.1, "clip_gradient": 0.05}, 1e-6),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}, 1e-6),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3}, 1e-5),
    ("adamw", {"learning_rate": 0.01, "wd": 0.01}, 1e-5),
    ("rmsprop", {"learning_rate": 0.01}, 1e-5),
    ("rmsprop", {"learning_rate": 0.01, "centered": True,
                 "clip_weights": 0.3}, 1e-5),
    ("ftrl", {"learning_rate": 0.1, "lamda1": 0.001}, 1e-5),
    ("signum", {"learning_rate": 0.01, "momentum": 0.0}, 1e-6),
    ("signum", {"learning_rate": 0.01, "wd_lh": 0.01}, 1e-6),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01}, 1e-5),
    ("lars", {"learning_rate": 0.1, "eta": 0.01}, 1e-5),
    ("ftml", {"learning_rate": 0.01}, 1e-5),
    ("adagrad", {"learning_rate": 0.1}, 1e-5),
    ("adadelta", {"rho": 0.95}, 1e-5),
    ("adamax", {"learning_rate": 0.01, "clip_gradient": 1.0}, 1e-5),
    ("nadam", {"learning_rate": 0.01}, 1e-5),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9}, 1e-5),
]


@pytest.mark.parametrize("opt,params,tol", OPTIMIZERS,
                         ids=[f"{o}-{i}" for i, (o, _, _) in
                              enumerate(OPTIMIZERS)])
def test_optimizer_steps_match_jax(opt, params, tol):
    jnet, tnet = _pair()
    jtr = jgluon.Trainer(jnet.collect_params(), opt, dict(params))
    ttr = tgluon.Trainer(tnet.collect_params(), opt, dict(params))
    jl, jo, _ = _run(JAX, jnet, jtr, 3)
    tl, to, _ = _run(PORT, tnet, ttr, 3)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert to == jo == ["APPLIED"] * 3
    for t, j in zip(_weights(tnet), _weights(jnet)):
        np.testing.assert_allclose(t, j, rtol=tol,
                                   atol=tol * float(np.abs(j).max()))
    assert _counts(ttr) == _counts(jtr)
    assert (ttr._fused is None) == (opt == "nadam")


def test_sgld_noise_has_the_jax_spread():
    jnet, tnet = _pair()
    lr = 1e-6
    jtr = jgluon.Trainer(jnet.collect_params(), "sgld",
                         {"learning_rate": lr})
    ttr = tgluon.Trainer(tnet.collect_params(), "sgld",
                         {"learning_rate": lr})
    _run(JAX, jnet, jtr, 3)
    _run(PORT, tnet, ttr, 3)
    assert ttr._fused is None and jtr._fused is None
    diff = np.concatenate([(t - j).ravel() for t, j in
                           zip(_weights(tnet), _weights(jnet))])
    # two independent sums of three N(0, lr) draws
    assert abs(diff.std() / (6 * lr) ** 0.5 - 1.0) < 0.1
    assert abs(diff.mean()) < 0.1 * (6 * lr) ** 0.5


@pytest.mark.parametrize("opt,params,tol", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 1e-6),
    ("adam", {"learning_rate": 0.01}, 1e-5),
    ("lamb", {"learning_rate": 0.01}, 1e-5)])
def test_fused_matches_eager(opt, params, tol):
    runs = []
    for fuse in (False, True):
        net = _net(PORT)
        tr = tgluon.Trainer(net.collect_params(), opt, dict(params),
                            fuse_step=fuse)
        losses, _, _ = _run(PORT, net, tr, 4)
        runs.append((losses, _weights(net), tr))
    assert runs[1][2]._fused is not None and runs[0][2]._fused is None
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-5)
    for wf, we in zip(runs[1][1], runs[0][1]):
        np.testing.assert_allclose(wf, we, rtol=tol, atol=tol)


# --------------------------------------------------------------------- #
# the applier's build counts against the JAX applier's traces
# --------------------------------------------------------------------- #

def _both(scenario):
    """``scenario(P)`` in both packages; returns (jax, port) results."""
    return scenario(JAX), scenario(PORT)


def test_steady_state_and_lr_change_counts_equal_jax():
    def scenario(P):
        net = _net(P)
        tr = P.gluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": 0.01})
        _run(P, net, tr, 3)
        steady = _counts(tr)
        for lr in (0.005, 0.0025):
            tr.set_learning_rate(lr)
            _run(P, net, tr, 1, seed=2)
        return steady, _counts(tr)
    j, t = _both(scenario)
    assert t == j == ((1, 1, 0, 3), (1, 1, 0, 5))


def test_wd_change_builds_once_more_as_jax():
    def scenario(P):
        net = _net(P)
        tr = P.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1, "wd": 0.0})
        _run(P, net, tr, 2)
        before = _counts(tr)
        tr.optimizer.wd = 1e-4
        _run(P, net, tr, 2, seed=2)
        return before, _counts(tr)
    j, t = _both(scenario)
    assert t == j and t[1][0] == 2


def test_mixed_dtype_groups_count_equal_jax():
    def scenario(P):
        rng = np.random.RandomState(5)
        params = []
        with P.ctx():
            for i, dt in enumerate(["float32", "float32", "float16",
                                    "float16"]):
                p = P.gluon.Parameter(f"p{i}", shape=(6, 6), dtype=dt)
                p.initialize()
                p.set_data(P.nd.array(rng.randn(6, 6).astype(np.float32))
                           .astype(dt))
                params.append(p)
            tr = P.gluon.Trainer(params, "sgd", {"learning_rate": 0.05},
                                 kvstore=None)
            grng = np.random.RandomState(6)
            for _ in range(3):
                for p in params:
                    g = p.grad()
                    new = P.nd.array(grng.randn(6, 6).astype(np.float32)) \
                        .astype(p.dtype)
                    if P is JAX:
                        g._data = new._data
                    else:
                        g._data.copy_(new._data)
                    g._fresh = True
                tr.step(1)
        programs = tr._fused._jits if P is JAX else tr._fused._programs
        return (_counts(tr), len(programs),
                [p.data().asnumpy().astype(np.float64) for p in params])
    (jc, jn, jw), (tc, tn, tw) = _both(scenario)
    assert tc == jc == (2, 1, 0, 6) and tn == jn == 2
    for t, j in zip(tw, jw):
        np.testing.assert_allclose(t, j, rtol=2e-3, atol=2e-3)


def test_guard_counts_and_scaler_across_faults_equal_jax():
    def scenario(P):
        net = _net(P)
        tr = P.gluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": 0.01},
                             loss_scaler=P.LossScaler(init_scale=16.0,
                                                      scale_window=2))
        _, outcomes, scales = _run(P, net, tr, 8, poison_at=(2, 5),
                                   scaled=True)
        return _counts(tr), outcomes, scales, dict(tr.health), \
            tr._fused.skipped_steps
    j, t = _both(scenario)
    assert t == j
    assert t[0][:3] == (1, 1, 0)
    assert t[1].count("SKIPPED_NONFINITE") == 2
    assert t[2] == [16.0, 32.0, 16.0, 16.0, 32.0, 16.0, 16.0, 32.0]


def test_accumulation_counts_equal_jax():
    nets = dict(zip((JAX, PORT), _pair()))

    def scenario(P):
        net = nets[P]
        tr = P.gluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": 0.01}, kvstore=None)
        out = []
        for k in (1, 4, 2):
            losses, outcomes, _ = _run(P, net, tr, 1, accum=k, seed=k)
            out.append((losses, outcomes))
        return _counts(tr), out, _weights(net)
    (jc, jo, jw), (tc, to, tw) = _both(scenario)
    assert tc == jc and tc[2] == 1
    assert [o for _, o in to] == [o for _, o in jo]
    for t, j in zip(tw, jw):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_accumulated_round_with_a_nan_skips_once():
    """A NaN in one microbatch of an accumulated round: one skipped
    apply, weights and state bit-identical, the scale halved once."""
    net = _net(PORT)
    tr = tgluon.Trainer(net.collect_params(), "adam",
                        {"learning_rate": 0.01}, kvstore=None,
                        loss_scaler=TLossScaler(init_scale=8.0,
                                                scale_window=100))
    _run(PORT, net, tr, 1, accum=2, scaled=True)
    before = _state(tr, net)
    _, outcomes, scales = _run(PORT, net, tr, 1, accum=3, poison_at=(0,),
                               scaled=True, seed=7)
    assert outcomes == ["SKIPPED_NONFINITE"] and scales == [4.0]
    assert all(torch.equal(a, b) for a, b in zip(before, _state(tr, net)))
    assert tr._fused.accum_trace_count == 1
    assert tr.health_snapshot()["accumulated_microbatches"] == 0


# --------------------------------------------------------------------- #
# skips, outcomes, states
# --------------------------------------------------------------------- #

def _state(tr, net):
    from incubator_mxnet_tpu_torch.optimizer.fused import tree_leaves
    return [p.detach().clone() for p in net.parameters()] + [
        x.clone() for s in tr._updaters[0].states.values()
        for x in tree_leaves(s)]


def test_skipped_step_is_bit_identical():
    net = _net(PORT)
    tr = tgluon.Trainer(net.collect_params(), "lamb",
                        {"learning_rate": 0.01, "wd": 0.01})
    _run(PORT, net, tr, 2)
    before = _state(tr, net)
    counts = dict(tr.optimizer._index_update_count)
    _, outcomes, _ = _run(PORT, net, tr, 1, poison_at=(0,), seed=3)
    assert outcomes == ["SKIPPED_NONFINITE"]
    assert all(torch.equal(a, b) for a, b in zip(before, _state(tr, net)))
    assert tr.optimizer._index_update_count == counts
    assert tr.health["SKIPPED_NONFINITE"] == 1 and \
        tr._fused.skipped_steps == 1
    assert "non-finite grads" in tr._recorder.last_detail
    _, outcomes, _ = _run(PORT, net, tr, 1, seed=4)
    assert outcomes == ["APPLIED"] and _counts(tr)[0] == 1


def test_consecutive_skips_halt_as_jax():
    def scenario(P):
        net = _net(P)
        tr = P.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1},
                             max_consecutive_nonfinite=2)
        _, outcomes, _ = _run(P, net, tr, 4, poison_at=(1, 2, 3))
        return outcomes
    j, t = _both(scenario)
    assert t == j and t[2] == StepOutcome.HALTED_POISONED.value


def test_stale_gradients_warn_or_skip_as_jax():
    def scenario(P):
        net = _net(P)
        tr = P.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1})
        _run(P, net, tr, 1)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tr.step(8)
        warned = any("has not been updated" in str(w.message)
                     for w in caught)
        tr.step(8, ignore_stale_grad=True)
        return warned, tr.last_outcome.value
    j, t = _both(scenario)
    assert t == j == (True, "SKIPPED_STALE")


def test_save_and_load_states_in_place(tmp_path):
    net = _net(PORT)
    tr = tgluon.Trainer(net.collect_params(), "adam",
                        {"learning_rate": 0.01})
    _run(PORT, net, tr, 2)
    path = str(tmp_path / "trainer.states")
    tr.save_states(path)
    saved = _state(tr, net)
    where = [x.data_ptr() for s in tr._updaters[0].states.values()
             for x in s]
    _run(PORT, net, tr, 1, seed=5)
    tr.load_states(path)
    assert [x.data_ptr() for s in tr._updaters[0].states.values()
            for x in s] == where
    n = len(list(net.parameters()))
    assert all(torch.equal(a, b) for a, b in
               zip(saved[n:], _state(tr, net)[n:]))
    assert tr.optimizer.num_update == 2
    fresh_net = _net(PORT)
    fresh = tgluon.Trainer(fresh_net.collect_params(), "adam",
                           {"learning_rate": 0.01})
    fresh.load_states(path)
    assert sorted(fresh._updaters[0].states) == \
        sorted(tr._updaters[0].states)


def test_backward_folds_the_loss_scale_into_the_head_gradient():
    grads = []
    for scaled in (False, True):
        net = _net(PORT)
        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1},
                            loss_scaler=TLossScaler(init_scale=4.0)
                            if scaled else None)
        with mx.cpu():
            x = tnd.ones((2, 8))
            with tag.record():
                loss = (net(x) ** 2).mean()
            tr.backward(loss)
            assert tr.scale_loss(loss) is loss or scaled
        grads.append(next(iter(net.collect_params().values()))
                     .grad().asnumpy())
    np.testing.assert_allclose(grads[1], 4.0 * grads[0], rtol=1e-6)


def test_refused_options(tmp_path):
    net = _net(PORT)
    params = net.collect_params()
    # ported: the multi-worker options, a step each on one worker
    # (over two workers: tests/test_torch_multiprocess.py)
    with mx.cpu():
        x = tnd.ones((2, 8))
        for kw in (dict(kvstore="dist_sync"),
                   dict(compression_params={"type": "2bit"}),
                   dict(int8_allreduce=True),
                   dict(overlap_allreduce=True)):
            tr = tgluon.Trainer(params, "sgd", **kw)
            with tag.record():
                loss = (net(x) ** 2).mean()
            loss.backward()
            tr.step(2)
            assert tr.last_outcome is StepOutcome.APPLIED, kw
            snap = tr.health_snapshot()
            assert snap["int8_allreduce"] is bool(kw.get("int8_allreduce"))
            assert snap["overlap_allreduce"] is \
                bool(kw.get("overlap_allreduce"))
        assert tr._kvstore.type == "device"
    for t in ("dist_sync", "dist_async"):
        kv = mx.kv.create(t)
        assert (kv.type, kv.rank, kv.num_workers) == (t, 0, 1)
        assert tgluon.Trainer(params, "sgd", kvstore=kv)._fused is not None
    for kv in (mx.kv.create("local"), mx.kv.create("device")):
        assert tgluon.Trainer(params, "sgd", kvstore=kv)._fused is not None
    tr = tgluon.Trainer(params, "sgd", kvstore="local")
    mgr = CheckpointManager(str(tmp_path))       # checkpointing runs
    assert tr.save_checkpoint(mgr, block=True) == 0
    assert tr.restore_checkpoint(mgr) == 0
    tr.install_preemption(mgr, exit_after=False)
    assert mgr.uninstall_preemption_hook() is not None
    with pytest.raises(MXNetError, match="Parameter"):
        tgluon.Trainer(["not a parameter"], "sgd")
    with pytest.warns(UserWarning, match="guard is off"):
        tgluon.Trainer(params, "sgd", fuse_step=False,
                       loss_scaler=TLossScaler())
    snap = tr.health_snapshot()
    assert snap["guard"] is True and snap["loss_scale"] is None
