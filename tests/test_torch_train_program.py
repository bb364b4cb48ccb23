"""The port's compiled-once train step on the CPU, against the JAX
package's ``SPMDTrainer`` on the same numpy inputs, and the learning-rate
schedulers against the JAX package's.

On the CPU the step program's body runs eagerly every step and
``step_trace_count`` counts the first meeting of each batch signature, as
the JAX jit counts traces. Held here (bert_tiny, f32, dropout 0, the
JAX model's weights carried across by ``convert.bert_params_from_jax``):

  - ``step_trace_count`` equals the JAX trainer's after 8 LAMB steps on
    one batch shape (1) and after a step on a second shape (2), the loss
    sequences at rtol 2e-4 (as in ``test_torch_trainer.py``), and the
    optimizer's host update counters move at builds only, as at JAX
    trace time; the run's LAMB follows a ``PolyScheduler`` with warmup,
    whose lr is staged each step;
  - the ports of ``test_spmd_skip_step_parity`` and
    ``test_spmd_scaler_and_halt``: a NaN batch leaves parameters and
    every optimizer-state tensor bitwise, the loss scale halves, a clean
    step applies through the same build, consecutive NaN batches halt,
    and ``step_trace_count`` stays 1, as the JAX trainer's does in the
    same scenario;
  - every scheduler class, warmup included, equals the JAX class at every
    update count in 0..50 (exactly: the same host arithmetic), and a
    ``PolyScheduler`` with warmup through ``SPMDTrainer(optimizer="lamb")``
    matches the JAX loss sequence at rtol 2e-4 with one build each (the
    first 8 steps of the run above);
  - the body reads nothing back (``Tensor.item``, ``tolist``, ``cpu``,
    ``numpy``, ``__bool__``, ``__float__`` and ``__int__`` patched to
    raise), for LAMB, Adam and SGD with momentum;
  - parameters and optimizer-state tensors keep their addresses across
    steps (a step graph holds them by address); three returned losses
    are tensors of their own with the per-step values;
  - the launch counters a replay adds to span both kernel families.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd, parallel as jparallel
from incubator_mxnet_tpu.amp import LossScaler as JLossScaler
from incubator_mxnet_tpu.base import MXNetError as JMXNetError
from incubator_mxnet_tpu.models import bert as jb
from incubator_mxnet_tpu.optimizer import lr_scheduler as jls

from incubator_mxnet_tpu_torch import amp
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models import bert as tb, convert
from incubator_mxnet_tpu_torch.ops import flash_attention as fa
from incubator_mxnet_tpu_torch.ops import ragged_attention as ra
from incubator_mxnet_tpu_torch.optimizer import lr_scheduler as tls
from incubator_mxnet_tpu_torch.optimizer.fused import tree_leaves
from incubator_mxnet_tpu_torch.parallel import SPMDTrainer
from incubator_mxnet_tpu_torch.serve.program import (add_launches,
                                                     launch_counts)
from incubator_mxnet_tpu_torch.train import StepOutcome

B, T, T2, M, V = 8, 16, 12, 4, 64
LAMB = {"learning_rate": 1e-2, "wd": 0.01}
NAN_AT = 5                     # masked_weights: a NaN loss and gradients


def _batch(rng, t=T):
    return (rng.randint(0, V, (B, t)), rng.randint(0, 2, (B, t)),
            rng.randint(8, t + 1, (B,)), rng.randint(0, 8, (B, M)),
            rng.randint(0, V, (B, M)), np.ones((B, M), np.float32),
            rng.randint(0, 2, (B,)))


def _poisoned(arrays):
    bad = [a.copy() for a in arrays]
    bad[NAN_AT][0, 0] = np.nan
    return bad


def _jax_batch(arrays):
    return [nd.array(a, dtype="float32" if a.dtype == np.float32
                     else "int32") for a in arrays]


def _jax_model():
    jmx.random.seed(0)
    jm = jb.bert_tiny(vocab_size=V, max_length=T, dropout=0.0)
    jm.initialize()
    jp = jb.BERTForPretraining(jm)
    jp.initialize()
    return jp


def _jax_trainer(optimizer_params, **kw):
    jp = _jax_model()
    return jparallel.SPMDTrainer(jp, forward_loss=jb.pretraining_loss,
                                 optimizer="lamb",
                                 optimizer_params=optimizer_params,
                                 sharding="replicated", **kw)


def _port_trainer(params, optimizer="lamb", optimizer_params=None, **kw):
    tp = tb.BERTForPretraining(tb.bert_tiny(vocab_size=V, max_length=T,
                                            dropout=0.0, device="cpu"))
    tp.load_state_dict(convert.bert_params_from_jax(tp, params))
    return SPMDTrainer(tp, forward_loss=tb.pretraining_loss,
                       optimizer=optimizer,
                       optimizer_params=dict(optimizer_params or LAMB),
                       sharding="replicated", **kw)


def _poly():
    return dict(max_update=8, pwr=2, final_lr=1e-4, warmup_steps=3,
                warmup_begin_lr=1e-3)


def _guard_scenario(clean, bad):
    """clean, clean, NaN (skipped), clean (applied), NaN, NaN (halts at
    two in a row)."""
    return [clean, clean, bad, clean, bad, bad]


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX trainer scenario, run once: the weights, and per
    scenario what each step gave."""
    params = {n: p.data().asnumpy()
              for n, p in _jax_model().collect_params().items()}
    rng = np.random.RandomState(0)
    a, b = _batch(rng), _batch(rng, T2)
    out = {"params": params, "a": a, "b": b}

    jt = _jax_trainer(dict(LAMB,
                           lr_scheduler=jls.PolyScheduler(**_poly())))
    losses = [float(jt.step(*_jax_batch(a)).asnumpy()) for _ in range(8)]
    count_a = jt.step_trace_count
    losses.append(float(jt.step(*_jax_batch(b)).asnumpy()))
    out["shapes"] = dict(
        losses=losses, counts=(count_a, jt.step_trace_count),
        update_counts=sorted(jt._optimizer._index_update_count.values()),
        num_update=jt._optimizer.num_update)

    jt = _jax_trainer(LAMB, loss_scaler=JLossScaler(init_scale=8.0,
                                                    scale_window=100),
                      max_consecutive_nonfinite=2)
    steps = []
    for arrays in _guard_scenario(a, _poisoned(a)):
        try:
            jt.step(*_jax_batch(arrays))
        except JMXNetError as e:
            assert "poisoned" in str(e)
        steps.append((jt.last_outcome.value, jt.step_count,
                      jt.loss_scaler.loss_scale, jt.step_trace_count))
    out["guard"] = steps
    return out


def _tensors(arrays):
    return [torch.tensor(x) for x in arrays]


def _state(tr):
    """Copies of every parameter and optimizer-state tensor."""
    return [p.detach().clone() for p in tr._params] + \
        [x.clone() for x in tree_leaves(tr._opt_state)]


def _addresses(tr):
    return [p.data_ptr() for p in tr._params] + \
        [x.data_ptr() for x in tree_leaves(tr._opt_state)]


# --------------------------------------------------------------------- #
# builds against the JAX trainer's traces
# --------------------------------------------------------------------- #

def _poly_trainer(params):
    return _port_trainer(params, optimizer_params=dict(
        LAMB, lr_scheduler=tls.PolyScheduler(**_poly())))


def test_step_trace_count_matches_jax_across_shapes(jax_runs):
    want = jax_runs["shapes"]
    tt = _poly_trainer(jax_runs["params"])
    assert tt.step_trace_count == 0
    losses = [float(tt.step(*_tensors(jax_runs["a"]))) for _ in range(8)]
    count_a = tt.step_trace_count
    losses.append(float(tt.step(*_tensors(jax_runs["b"]))))
    assert (count_a, tt.step_trace_count) == want["counts"] == (1, 2)
    assert tt.health_snapshot()["step_trace_count"] == 2
    np.testing.assert_allclose(losses, want["losses"], rtol=2e-4)
    assert losses[7] < losses[0] and tt.step_count == 9
    # the optimizer's host counters moved once per build, as per trace
    opt = tt._optimizer
    assert sorted(opt._index_update_count.values()) == \
        want["update_counts"] == [2] * len(tt._train_idx)
    assert opt.num_update == want["num_update"]
    assert sorted(p.replays for p in tt._programs.values()) == [0, 0]
    assert all(p.graph is None for p in tt._programs.values())


def _run_guard_scenario(jax_runs, upto):
    scaler = amp.LossScaler(init_scale=8.0, scale_window=100)
    tt = _port_trainer(jax_runs["params"], loss_scaler=scaler,
                       max_consecutive_nonfinite=2)
    a = jax_runs["a"]
    steps, states = [], []
    for arrays in _guard_scenario(a, _poisoned(a))[:upto]:
        states.append(_state(tt))
        try:
            tt.step(*_tensors(arrays))
        except MXNetError as e:
            assert "poisoned" in str(e)
        steps.append((tt.last_outcome.value, tt.step_count,
                      tt.loss_scaler.loss_scale, tt.step_trace_count))
    states.append(_state(tt))
    return tt, steps, states


def test_skip_step_parity(jax_runs):
    """Port of the JAX package's ``test_spmd_skip_step_parity``
    (replicated): the NaN batch leaves every parameter and every
    optimizer-state tensor bitwise, ``step_count`` does not move, the
    clean step after it applies through the same build."""
    tt, steps, states = _run_guard_scenario(jax_runs, 4)
    assert steps == jax_runs["guard"][:4]
    assert steps[2][:2] == (StepOutcome.SKIPPED_NONFINITE.value, 2)
    assert steps[3][:2] == (StepOutcome.APPLIED.value, 3)
    for before, after in zip(states[2], states[3]):
        assert torch.equal(before, after)
    assert any(not torch.equal(x, y) for x, y in zip(states[3], states[4]))
    assert tt.step_trace_count == 1 and sum(tt.health.values()) == 4


def test_scaler_and_halt(jax_runs):
    """Port of ``test_spmd_scaler_and_halt``: the scale halves on each
    NaN batch, two in a row halt the run, one build throughout."""
    tt, steps, states = _run_guard_scenario(jax_runs, 6)
    assert steps == jax_runs["guard"]
    assert [s[2] for s in steps] == [8.0, 8.0, 4.0, 4.0, 2.0, 1.0]
    assert steps[-1][0] == StepOutcome.HALTED_POISONED.value
    assert tt.health[StepOutcome.HALTED_POISONED.value] == 1
    assert {s[3] for s in steps} == {1}
    for before, after in zip(states[4], states[6]):
        assert torch.equal(before, after)


# --------------------------------------------------------------------- #
# learning-rate schedulers
# --------------------------------------------------------------------- #

SCHEDULES = [
    ("FactorScheduler", dict(step=7, factor=0.5, base_lr=0.1)),
    ("FactorScheduler", dict(step=3, factor=0.1, stop_factor_lr=1e-4,
                             base_lr=0.1, warmup_steps=5,
                             warmup_begin_lr=0.01)),
    ("MultiFactorScheduler", dict(step=[4, 10, 30], factor=0.3,
                                  base_lr=0.2)),
    ("MultiFactorScheduler", dict(step=[12, 20], factor=0.5, base_lr=0.2,
                                  warmup_steps=10, warmup_mode="constant",
                                  warmup_begin_lr=0.05)),
    ("PolyScheduler", dict(max_update=40, base_lr=0.1, pwr=2)),
    ("PolyScheduler", dict(max_update=40, base_lr=0.1, pwr=1.5,
                           final_lr=1e-3, warmup_steps=8,
                           warmup_begin_lr=1e-4)),
    ("CosineScheduler", dict(max_update=45, base_lr=0.1)),
    ("CosineScheduler", dict(max_update=45, base_lr=0.1, final_lr=0.01,
                             warmup_steps=6, warmup_mode="constant",
                             warmup_begin_lr=0.02)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULES)])
def test_scheduler_equals_jax(name, kw):
    ours, ref = getattr(tls, name)(**kw), getattr(jls, name)(**kw)
    assert [ours(n) for n in range(51)] == [ref(n) for n in range(51)]
    assert isinstance(ours, tls.LRScheduler)


@pytest.mark.parametrize("name,kw,match", [
    ("LRScheduler", dict(warmup_mode="cubic"), "unknown warmup_mode"),
    ("FactorScheduler", dict(step=0), "step must be >= 1"),
    ("MultiFactorScheduler", dict(step=[5, 5]), "increasing"),
])
def test_scheduler_errors_equal_jax(name, kw, match):
    with pytest.raises(JMXNetError, match=match):
        getattr(jls, name)(**kw)
    with pytest.raises(MXNetError, match=match):
        getattr(tls, name)(**kw)


def test_poly_schedule_through_trainer_matches_jax(jax_runs):
    """A schedule's lr is staged into the one build every step: the loss
    sequence follows the JAX trainer's, one build on each side."""
    want = jax_runs["shapes"]
    tt = _poly_trainer(jax_runs["params"])
    lrs, losses = [], []
    for _ in range(8):
        losses.append(float(tt.step(*_tensors(jax_runs["a"]))))
        lrs.append(float(next(iter(tt._programs.values())).inp.dev["lr"]))
    np.testing.assert_allclose(losses, want["losses"][:8], rtol=2e-4)
    assert tt.step_trace_count == want["counts"][0] == 1
    sched = tls.PolyScheduler(**_poly())
    sched.base_lr = LAMB["learning_rate"]
    assert lrs == [float(np.float32(sched(n))) for n in range(8)]
    assert len(set(lrs)) == 8
    with pytest.raises(MXNetError, match="lr_scheduler"):
        tt.set_learning_rate(0.5)


# --------------------------------------------------------------------- #
# the body and its buffers
# --------------------------------------------------------------------- #

def _raise(*_a, **_k):
    raise AssertionError("host read inside the train step's body")


@pytest.mark.parametrize("optimizer,kw", [
    ("lamb", dict(LAMB, clip_gradient=0.5, lower_bound=0.1,
                  upper_bound=5.0)),
    ("adam", dict(learning_rate=1e-3, wd=0.01)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9))])
def test_body_makes_no_host_read(jax_runs, optimizer, kw, monkeypatch):
    tt = _port_trainer(jax_runs["params"], optimizer=optimizer,
                       optimizer_params=kw,
                       loss_scaler=amp.LossScaler(init_scale=4.0))
    batch = _tensors(jax_runs["a"])
    tt.step(*batch)
    prog = next(iter(tt._programs.values()))
    prog.stage(batch, 2, 1e-3, 4.0)
    before = _state(tt)
    with monkeypatch.context() as m:
        for name in ("item", "tolist", "cpu", "numpy", "__bool__",
                     "__float__", "__int__"):
            m.setattr(torch.Tensor, name, _raise)
        tt._run_body(prog, False)
    loss, ok = prog.read()
    assert np.isfinite(loss) and ok == 1.0
    assert any(not torch.equal(x, y) for x, y in zip(before, _state(tt)))


def test_parameters_and_state_keep_their_addresses(jax_runs):
    tt = _port_trainer(jax_runs["params"],
                       optimizer_params=dict(LAMB, multi_precision=True))
    a = jax_runs["a"]
    tt.step(*_tensors(a))
    where = _addresses(tt)
    states = tt._opt_state
    for arrays in (a, _poisoned(a), a):
        tt.step(*_tensors(arrays))
        assert _addresses(tt) == where and tt._opt_state is states
    assert tt.step_count == 3 and tt.step_trace_count == 1


def test_returned_losses_are_tensors_of_their_own(jax_runs):
    a = _tensors(jax_runs["a"])
    tt = _port_trainer(jax_runs["params"])
    losses = [tt.step(*a) for _ in range(3)]
    ref = _port_trainer(jax_runs["params"])
    want = [float(ref.step(*a)) for _ in range(3)]
    assert [float(x) for x in losses] == want
    assert len(set(want)) == 3
    assert len({x.data_ptr() for x in losses}) == 3
    out = next(iter(tt._programs.values())).out.dev["loss"]
    assert all(x.data_ptr() != out.data_ptr() for x in losses)


def test_replay_adds_launches_to_both_counters():
    before = launch_counts()
    assert set(fa.LAUNCHES) <= set(before) and set(ra.LAUNCHES) <= \
        set(before)
    add_launches({"flash_fwd": 2, "flash_bwd_dkv": 2, "ragged_decode": 3})
    after = launch_counts()
    try:
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == \
            {"flash_fwd": 2, "flash_bwd_dkv": 2, "ragged_decode": 3}
    finally:
        fa.LAUNCHES.update({k: before[k] for k in fa.LAUNCHES})
        ra.LAUNCHES.update({k: before[k] for k in ra.LAUNCHES})


# --------------------------------------------------------------------- #
# module buffers on a skipped step; MXTPU_STEP_GUARD
# --------------------------------------------------------------------- #

def _bn_nets():
    """Dense(8->16, relu) -> BatchNorm(16) -> Dense(16->4) in both
    packages, the port's carrying the JAX net's weights."""
    from incubator_mxnet_tpu.gluon import nn as jnn
    jmx.random.seed(7)
    jnet = jnn.Sequential()
    jnet.add(jnn.Dense(16, in_units=8, activation="relu"),
             jnn.BatchNorm(in_channels=16), jnn.Dense(4, in_units=16))
    jnet.initialize()
    w = [p.data().asnumpy() for p in jnet.collect_params().values()]
    tnet = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                               torch.nn.BatchNorm1d(16),
                               torch.nn.Linear(16, 4))
    with torch.no_grad():
        for dst, src in zip((tnet[0].weight, tnet[0].bias, tnet[2].weight,
                             tnet[2].bias, tnet[2].running_mean,
                             tnet[2].running_var, tnet[3].weight,
                             tnet[3].bias), w):
            dst.copy_(torch.from_numpy(np.array(src)))
    return jnet, tnet


def _ce(out, y):
    return torch.nn.functional.cross_entropy(out, y.long())


def test_skipped_step_keeps_batchnorm_buffers_as_jax():
    """Port of ``test_spmd_skip_step_parity`` with a BatchNorm: two clean
    Adam steps (losses as the JAX trainer's), then the batch with one NaN
    is skipped by both trainers; the port leaves its parameters, its
    optimizer state AND the BatchNorm's running statistics and
    ``num_batches_tracked`` bitwise, as the JAX trainer leaves its
    running statistics; a clean step applies after it."""
    from incubator_mxnet_tpu import gluon as jgluon
    from incubator_mxnet_tpu.parallel import mesh as jmesh
    jnet, tnet = _bn_nets()
    opt = {"learning_rate": 0.01}
    jt = jparallel.SPMDTrainer(
        jnet, loss=jgluon.loss.SoftmaxCrossEntropyLoss(), optimizer="adam",
        optimizer_params=dict(opt),
        mesh=jmesh.build_mesh(axis_sizes={"dp": 8}), sharding="replicated")
    tt = SPMDTrainer(tnet, loss=_ce, optimizer="adam",
                     optimizer_params=dict(opt), sharding="replicated")
    rng = np.random.RandomState(2)
    X = rng.randn(16, 8).astype(np.float32)
    y = rng.randint(0, 4, size=(16,))
    bad = X.copy()
    bad[0, 0] = np.nan
    jl = [float(jt.step(nd.array(X), nd.array(y)).asnumpy())
          for _ in range(2)]
    tl = [float(tt.step(torch.tensor(X), torch.tensor(y)))
          for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)

    jstats = [p.data().asnumpy().copy()
              for n, p in jnet.collect_params().items() if "running" in n]
    before = _state(tt) + [b.clone() for b in tnet.buffers()]
    jt.step(nd.array(bad), nd.array(y))
    tt.step(torch.tensor(bad), torch.tensor(y))
    assert jt.last_outcome.value == tt.last_outcome.value == \
        StepOutcome.SKIPPED_NONFINITE.value
    for b, a in zip(jstats, [p.data().asnumpy() for n, p in
                             jnet.collect_params().items()
                             if "running" in n]):
        np.testing.assert_array_equal(a, b)
    after = _state(tt) + list(tnet.buffers())
    assert len(after) == len(before) and len(list(tnet.buffers())) == 3
    for b, a in zip(before, after):
        assert torch.equal(a, b)
    assert int(tnet[2].num_batches_tracked) == 2

    tt.step(torch.tensor(X), torch.tensor(y))
    assert tt.last_outcome is StepOutcome.APPLIED
    assert int(tnet[2].num_batches_tracked) == 3
    assert tt.step_trace_count == 1


@pytest.mark.parametrize("env,want", [("0", False), ("1", True),
                                      (None, True)])
def test_step_guard_reads_the_environment(monkeypatch, env, want):
    """``guard=None`` reads ``MXTPU_STEP_GUARD`` (default on), as the JAX
    trainer does; off, a NaN batch is applied, not skipped."""
    if env is None:
        monkeypatch.delenv("MXTPU_STEP_GUARD", raising=False)
    else:
        monkeypatch.setenv("MXTPU_STEP_GUARD", env)
    from incubator_mxnet_tpu.gluon import nn as jnn
    jnet = jnn.Dense(4, in_units=8)
    jnet.initialize()
    jt = jparallel.SPMDTrainer(jnet, loss=lambda o, y: (o - y) ** 2,
                               optimizer="sgd", sharding="replicated")
    tt = SPMDTrainer(torch.nn.Linear(8, 4),
                     loss=lambda o, y: ((o - y) ** 2).mean(),
                     optimizer="sgd")
    assert tt.guard is want and jt.guard is want
    assert tt.health_snapshot()["guard"] is want
    X = np.full((4, 8), np.nan, np.float32)
    tt.step(torch.tensor(X), torch.zeros(4, 4))
    assert tt.last_outcome is (StepOutcome.SKIPPED_NONFINITE if want
                               else StepOutcome.APPLIED)
