"""``SPMDTrainer.step_microbatches`` (in-step gradient accumulation) and
``gluon.Trainer.set_grad_accumulation`` of the port, on the CPU, against
the JAX package's trainers and the contract its tests state
(``tests/test_train_perf.py``):

  - the JAX trainer's ``step_microbatches`` on a one-device mesh, from the
    same weights, over clean rounds, a round with a NaN microbatch and
    rounds of another count (with and without BatchNorm, Adam, a loss
    scaler): each round's loss at rtol 2e-4 and the parameters at rtol
    1e-3 of each tensor's largest entry (``tests/test_torch_trainer.py``'s
    tolerances for the plain step), the same outcomes and loss scales;
  - the port's own plain step on the concatenated batch (loss rtol 1e-5,
    parameters rtol 3e-6, as the JAX test holds its trainer);
  - one build across rounds of k = 1, 4 and 8 microbatches of one shape
    (``accum_step_trace_count``, ``last_accum_count`` in
    ``health_snapshot()``);
  - a NaN in any microbatch: parameters, optimizer state and BatchNorm
    statistics bitwise those at the round's start, one
    ``SKIPPED_NONFINITE``, the loss scale halved once, ``step_count``
    unchanged, the accumulators zero, and the next clean round applied by
    the same build; guarded clean rounds bitwise unguarded ones; halting
    after consecutive poisoned rounds;
  - the body reads nothing back from the device, keeps every tensor's
    address, and a round that dies leaves nothing accumulated;
  - ``set_grad_accumulation`` records the flag as the JAX Trainer does.
"""

import jax
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon, nd as jnd
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.amp.loss_scaler import LossScaler as JLossScaler
from incubator_mxnet_tpu.parallel import mesh as jmesh

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, nd, parallel
from incubator_mxnet_tpu_torch.amp import LossScaler
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models import convert
from incubator_mxnet_tpu_torch.optimizer.fused import tree_leaves
from incubator_mxnet_tpu_torch.train import StepOutcome

from test_torch_parity import fresh_names

ADAM = {"learning_rate": 0.01}
# (k, rows a microbatch, the microbatch with a NaN flag or None)
ROUNDS = [(4, 4, None), (4, 4, 1), (4, 4, None), (2, 4, None)]


def _flagged_mse(block, x, y, flag):
    """MSE with a poison channel: a NaN flag entry poisons the loss and
    every gradient as data (the JAX tests' objective)."""
    return ((block(x) - y) ** 2).mean() * flag.mean()


def _data(seed=1, n=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 8).astype(np.float32),
            rng.randn(n, 4).astype(np.float32))


def _micros(k, rows, nan_at=None, seed=1):
    X, Y = _data(seed, k * rows)
    out = []
    for m in range(k):
        flag = np.ones((rows,), np.float32)
        if m == nan_at:
            flag[0] = np.nan
        out.append((X[m * rows:(m + 1) * rows], Y[m * rows:(m + 1) * rows],
                    flag))
    return out


def _layers(nn, bn):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"))
    if bn:
        net.add(nn.BatchNorm(in_channels=16))
    net.add(nn.Dense(4, in_units=16))
    return net


def _port_net(seed=0, bn=False, params=None):
    fresh_names()
    mx.random.seed(seed)
    net = _layers(gluon.nn, bn)
    net.initialize(ctx=mx.cpu())
    if params is not None:
        net.load_state_dict(convert.block_params_from_jax(net, params))
    return net


def _port_trainer(net, scaler=None, guard=None):
    return parallel.SPMDTrainer(net, forward_loss=_flagged_mse,
                                optimizer="adam",
                                optimizer_params=dict(ADAM),
                                loss_scaler=scaler, guard=guard)


def _params(net):
    return [p.data().asnumpy().copy() for p in net.collect_params().values()]


def _port_round(tr, micros):
    with mx.cpu():
        return float(tr.step_microbatches(
            [tuple(nd.array(a) for a in m) for m in micros]).asnumpy())


@pytest.fixture(scope="module", params=[False, True], ids=["mlp", "bn"])
def jax_rounds(request):
    """The JAX trainer through ``ROUNDS`` on a one-device mesh: its initial
    weights, and after each round the loss, outcome, loss scale and
    parameters."""
    bn = request.param
    fresh_names()
    jmx.random.seed(0)
    net = _layers(jgluon.nn, bn)
    net.initialize()
    start = {k: p.data().asnumpy()
             for k, p in net._collect_params_with_prefix().items()}
    scaler = JLossScaler(init_scale=8.0, scale_window=100)
    tr = jparallel.SPMDTrainer(
        net, forward_loss=_flagged_mse, optimizer="adam",
        optimizer_params=dict(ADAM), loss_scaler=scaler,
        mesh=jmesh.build_mesh(devices=jax.devices()[:1],
                              axis_sizes={"dp": 1}))
    out = []
    for k, rows, nan_at in ROUNDS:
        loss = float(tr.step_microbatches(
            [tuple(jnd.array(a) for a in m)
             for m in _micros(k, rows, nan_at)]).asnumpy())
        out.append(dict(loss=loss, outcome=tr.last_outcome.value,
                        scale=scaler.loss_scale, step_count=tr.step_count,
                        params={k_: p.data().asnumpy() for k_, p in
                                net._collect_params_with_prefix().items()}))
    return dict(bn=bn, start=start, rounds=out)


def test_rounds_equal_the_jax_trainer(jax_rounds):
    net = _port_net(bn=jax_rounds["bn"], params=jax_rounds["start"])
    scaler = LossScaler(init_scale=8.0, scale_window=100)
    tr = _port_trainer(net, scaler)
    names = list(net._collect_params_with_prefix())
    for (k, rows, nan_at), want in zip(ROUNDS, jax_rounds["rounds"]):
        loss = _port_round(tr, _micros(k, rows, nan_at))
        if nan_at is None:
            np.testing.assert_allclose(loss, want["loss"], rtol=2e-4)
        else:
            assert np.isnan(loss) and np.isnan(want["loss"])
        assert tr.last_outcome.value == want["outcome"]
        assert scaler.loss_scale == want["scale"]
        assert tr.step_count == want["step_count"]
        got = {k_: p.data().asnumpy()
               for k_, p in net._collect_params_with_prefix().items()}
        ref = convert.block_params_from_jax(net, want["params"])
        for name in names:
            w = ref[name].numpy()
            np.testing.assert_allclose(
                got[name], w, rtol=1e-3,
                atol=1e-3 * float(np.abs(w).max()) + 1e-7, err_msg=name)
    assert tr.accum_step_trace_count == 1


def test_rounds_equal_the_plain_step_on_the_whole_batch():
    X, Y = _data(9, 16)
    flag = np.ones(16, np.float32)
    a = _port_trainer(_port_net(seed=9))
    b = _port_trainer(_port_net(seed=9))
    with mx.cpu():
        for _ in range(3):
            la = _port_round(a, _micros(4, 4, seed=9))
            lb = float(b.step(nd.array(X), nd.array(Y),
                              nd.array(flag)).asnumpy())
    np.testing.assert_allclose(la, lb, rtol=1e-5)
    for pa, pb in zip(a._params, b._params):
        np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(),
                                   rtol=3e-6, atol=3e-7)


def test_one_build_whatever_the_count():
    tr = _port_trainer(_port_net())
    for k in (1, 4, 8):
        assert np.isfinite(_port_round(tr, _micros(k, 2)))
    assert tr.accum_step_trace_count == 1 and len(tr._accum_programs) == 1
    assert tr.step_count == 3 and tr.health["APPLIED"] == 3
    snap = tr.health_snapshot()
    assert snap["accum_step_trace_count"] == 1
    assert snap["last_accum_count"] == 8
    # another microbatch shape is another build; the plain step its own
    _port_round(tr, _micros(2, 3))
    with mx.cpu():
        X, Y = _data(2, 4)
        tr.step(nd.array(X), nd.array(Y), nd.array(np.ones(4, np.float32)))
    assert tr.accum_step_trace_count == 2 and tr.step_trace_count == 1
    _port_round(tr, _micros(4, 2))
    assert tr.accum_step_trace_count == 2 and tr.step_count == 6
    with pytest.raises(MXNetError, match=">= 1 microbatch"):
        tr.step_microbatches([])


def _state(tr, net):
    return [p.detach().clone() for p in tr._params] + \
        [t.clone() for t in tree_leaves(tr._opt_state)] + \
        [b.clone() for b in net.buffers()]


@pytest.mark.parametrize("nan_at", [0, 1, 3])
def test_a_nan_microbatch_skips_the_round_bitwise(nan_at):
    net = _port_net(seed=15, bn=True)
    scaler = LossScaler(init_scale=8.0, scale_window=100)
    tr = _port_trainer(net, scaler)
    _port_round(tr, _micros(4, 4))
    before = _state(tr, net)
    stats = [p.data().asnumpy().copy()
             for k, p in net._collect_params_with_prefix().items()
             if "running_" in k]
    assert stats
    outcomes = sum(tr.health.values())
    steps = tr.step_count
    assert np.isnan(_port_round(tr, _micros(4, 4, nan_at)))
    assert tr.last_outcome is StepOutcome.SKIPPED_NONFINITE
    assert sum(tr.health.values()) == outcomes + 1
    assert tr.step_count == steps and scaler.loss_scale == 4.0
    for a, b in zip(_state(tr, net), before):
        assert torch.equal(a, b)
    for a, k in zip(stats, [k for k in net._collect_params_with_prefix()
                            if "running_" in k]):
        np.testing.assert_array_equal(
            net._collect_params_with_prefix()[k].data().asnumpy(), a)
    assert all(not a.any() for a in tr._accum.grads)
    assert float(tr._accum.ok) == 1.0 and float(tr._accum.loss) == 0.0
    _port_round(tr, _micros(4, 4))
    assert tr.last_outcome is StepOutcome.APPLIED
    assert tr.accum_step_trace_count == 1
    # an applied round moves the statistics
    assert any(not np.array_equal(
        net._collect_params_with_prefix()[k].data().asnumpy(), a)
        for a, k in zip(stats, [k for k in net._collect_params_with_prefix()
                                if "running_" in k]))


def test_guarded_clean_rounds_equal_unguarded_ones():
    finals = []
    for guard in (True, False):
        net = _port_net(seed=11)
        tr = _port_trainer(net, guard=guard)
        for _ in range(3):
            _port_round(tr, _micros(4, 4))
        finals.append(_params(net))
    for a, b in zip(*finals):
        np.testing.assert_array_equal(a, b)


def test_consecutive_poisoned_rounds_halt():
    tr = _port_trainer(_port_net(seed=17))
    tr._recorder.max_consecutive_nonfinite = 2
    _port_round(tr, _micros(2, 2))
    _port_round(tr, _micros(2, 2, nan_at=0))
    with pytest.raises(MXNetError, match="poisoned"):
        _port_round(tr, _micros(2, 2, nan_at=1))
    assert tr.health["HALTED_POISONED"] == 1


def _raise(*_a, **_k):
    raise AssertionError("host read inside the accumulation body")


def test_body_reads_nothing_back_and_keeps_addresses(monkeypatch):
    net = _port_net(seed=3, bn=True)
    tr = _port_trainer(net, LossScaler(init_scale=4.0))
    _port_round(tr, _micros(4, 4))
    prog = next(iter(tr._accum_programs.values()))
    tensors = list(tr._params) + tree_leaves(tr._opt_state) + \
        tr._accum.grads + tr._accum.snap + [tr._accum.ok, tr._accum.loss]
    ptrs = [t.data_ptr() for t in tensors]
    batch = [torch.as_tensor(a) for a in _micros(4, 4)[0]]
    prog.stage(batch, 2, 1e-2, 4.0, inv_k=0.5, first=1.0, last=0.0)
    trained = [tr._params[i] for i in tr._train_idx]
    before = [p.detach().clone() for p in trained]
    with monkeypatch.context() as m:
        for name in ("item", "tolist", "cpu", "numpy", "__bool__",
                     "__float__", "__int__"):
            m.setattr(torch.Tensor, name, _raise)
        tr._run_accum_body(prog, False)
    loss, ok = prog.read()
    assert np.isfinite(loss) and ok == 1.0
    for a, b in zip(before, trained):            # not the last: no apply
        assert torch.equal(a, b.detach())
    assert any(a.any() for a in tr._accum.grads)
    assert [t.data_ptr() for t in tensors] == ptrs
    tr._accum.restart()


def test_a_round_that_dies_leaves_nothing_accumulated():
    net = _port_net(seed=5)
    tr = _port_trainer(net)
    ref = _port_trainer(_port_net(seed=5))
    micros = _micros(4, 4)
    broken = list(micros)
    broken[2] = (np.zeros((4, 7), np.float32),) + micros[2][1:]
    with pytest.raises(Exception):
        _port_round(tr, broken)
    assert all(not a.any() for a in tr._accum.grads)
    assert sum(tr.health.values()) == 0 and tr.step_count == 0
    _port_round(tr, micros)
    _port_round(ref, micros)
    for a, b in zip(tr._params, ref._params):
        assert torch.equal(a.detach(), b.detach())


def test_set_grad_accumulation_records_the_flag():
    fresh_names()
    jnet = jgluon.nn.Dense(2, in_units=3)
    jnet.initialize()
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd",
                         {"learning_rate": 0.1})
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    params = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    net.load_state_dict(convert.block_params_from_jax(net, params))
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    for t in (tr, jtr):
        assert t._accum_mode is False
        t.set_grad_accumulation(True)
        assert t._accum_mode is True
        t.set_grad_accumulation(False)
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    with mx.cpu():
        for m in range(2):
            with autograd.record():
                L = (net(nd.array(x[m * 2:(m + 1) * 2])) ** 2).mean()
            L.backward()
            tr.accumulate_grads()
        tr.step(2)
    for m in range(2):
        with jmx.autograd.record():
            L = (jnet(jnd.array(x[m * 2:(m + 1) * 2])) ** 2).mean()
        L.backward()
        jtr.accumulate_grads()
    jtr.step(2)
    assert tr._accum_mode is True and jtr._accum_mode is True
    for k, p in net._collect_params_with_prefix().items():
        np.testing.assert_allclose(
            p.data().asnumpy(),
            jnet._collect_params_with_prefix()[k].data().asnumpy(),
            rtol=1e-6, atol=1e-7)
