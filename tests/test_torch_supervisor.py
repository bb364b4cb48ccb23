"""The port's training resilience harness: ``train.Supervisor``,
``train.chaos`` and ``train.example_target``, on the CPU.

  - the unit cases of ``tests/test_supervisor.py`` on trivial children
    (no framework in them): completion, restarts across crashes, backoff
    doubling and its reset on progress, the hang watchdog, the give-up,
    the progress-signal requirement, death by signal;
  - the chaos injectors through ``run_train_chaos`` on the port's
    ``gluon.Trainer`` against the JAX package's on the same net and data:
    ``NaNGrad`` and ``OverflowStorm`` give the same outcomes and loss
    scales (losses at rtol 1e-5), a skipped step leaves the state
    bit-identical; ``NaNBatch`` poisons the same entries; ``SlowStep``
    sleeps in its window; ``KillSelf`` fires once across restarts;
  - the ``kill -9`` resume of the port's ``example_target`` (killed twice,
    the per-step losses equal an uninterrupted run's bitwise), ``slow`` as
    the JAX suite's ``test_kill9_twice_resumes_bit_exact`` is.
"""

import json
import os
import signal
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import train as jtrain

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import train
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.optimizer.fused import tree_leaves
from incubator_mxnet_tpu_torch.train import (KillSelf, NaNBatch, NaNGrad,
                                             SlowStep, StepOutcome,
                                             Supervisor)

from test_torch_gluon_trainer import JAX, PORT, _pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(tmp_path, body):
    p = tmp_path / "child.py"
    p.write_text(textwrap.dedent(body))
    return [sys.executable, str(p)]


# ------------------------------------------------------------------ #
# the supervisor on trivial children
# ------------------------------------------------------------------ #

def test_completes_without_restart(tmp_path):
    sup = Supervisor(_script(tmp_path, "raise SystemExit(0)"),
                     max_restarts=3, backoff_s=0.01)
    report = sup.run()
    assert report.completed and report.restarts == 0
    assert [a.reason for a in report.attempts] == ["completed"]


def test_restarts_across_crashes_then_completes(tmp_path):
    argv = _script(tmp_path, f"""
        import os
        c = {str(tmp_path / "count")!r}
        n = int(open(c).read()) if os.path.exists(c) else 0
        open(c, "w").write(str(n + 1))
        raise SystemExit(0 if n >= 2 else 1)
    """)
    report = Supervisor(argv, max_restarts=5, backoff_s=0.01).run()
    assert report.completed and report.restarts == 2
    assert [a.reason for a in report.attempts] == \
        ["crash", "crash", "completed"]


def test_backoff_doubles_without_progress(tmp_path):
    prog = tmp_path / "progress"
    prog.write_text("static\n")
    sup = Supervisor(_script(tmp_path, "raise SystemExit(1)"),
                     progress_file=str(prog), max_restarts=3,
                     backoff_s=0.02, backoff_max_s=0.05)
    report = sup.run(raise_on_failure=False)
    assert not report.completed and report.restarts == 3
    assert report.backoffs == [0.02, 0.04, 0.05]


def test_backoff_resets_on_progress(tmp_path):
    prog = tmp_path / "progress"
    argv = _script(tmp_path, f"""
        import os
        p = {str(prog)!r}
        n = int(open(p).read()) if os.path.exists(p) else 0
        open(p, "w").write(str(n + 1))
        raise SystemExit(0 if n >= 2 else 1)
    """)
    sup = Supervisor(argv, progress_file=str(prog), max_restarts=5,
                     backoff_s=0.02, hang_timeout_s=30.0)
    report = sup.run()
    assert report.completed and report.restarts == 2
    assert report.backoffs == [0.02, 0.02]


def test_hang_watchdog_converts_hang_into_restart(tmp_path):
    prog = tmp_path / "progress"
    argv = _script(tmp_path, f"""
        import os, time
        p = {str(prog)!r}
        m = {str(tmp_path / "hung_once")!r}
        if os.path.exists(m):
            raise SystemExit(0)
        open(m, "w").write("x")
        open(p, "a").write("alive\\n")
        time.sleep(3600)
    """)
    sup = Supervisor(argv, progress_file=str(prog), max_restarts=2,
                     backoff_s=0.01, hang_timeout_s=0.5, poll_s=0.02)
    report = sup.run()
    assert report.completed
    assert report.hang_kills == 1 and report.restarts == 1
    assert report.attempts[0].reason == "hang_kill"


def test_gives_up_loudly_after_budget(tmp_path):
    sup = Supervisor(_script(tmp_path, "raise SystemExit(3)"),
                     max_restarts=2, backoff_s=0.01)
    with pytest.raises(MXNetError, match="gave up after 2 restarts"):
        sup.run()
    report = sup.run(raise_on_failure=False)
    assert not report.completed
    assert len(report.attempts) == 3
    assert all(a.exit_code == 3 for a in report.attempts)


def test_watchdog_requires_progress_signal():
    with pytest.raises(MXNetError, match="progress signal"):
        Supervisor([sys.executable, "-c", "pass"], hang_timeout_s=1.0)


def test_death_by_signal_is_a_crash(tmp_path):
    argv = _script(tmp_path, f"""
        import os, signal
        m = {str(tmp_path / "killed")!r}
        if os.path.exists(m):
            raise SystemExit(0)
        open(m, "w").write("x")
        os.kill(os.getpid(), signal.SIGKILL)
    """)
    report = Supervisor(argv, max_restarts=2, backoff_s=0.01).run()
    assert report.completed and report.restarts == 1
    assert report.attempts[0].term_signal == signal.SIGKILL


# ------------------------------------------------------------------ #
# chaos injectors on gluon.Trainer, against the JAX package's
# ------------------------------------------------------------------ #

def _chaos(P, net, make_injectors, steps, scaler=None):
    tr = P.gluon.Trainer(net.collect_params(), "adam",
                         {"learning_rate": 0.01}, kvstore=None,
                         loss_scaler=scaler)
    rng = np.random.RandomState(1)
    X = rng.randn(8, 8).astype(np.float32)
    y = rng.randn(8, 4).astype(np.float32)
    T = jtrain if P is JAX else train
    injectors = make_injectors(T)
    with P.ctx():
        losses, outcomes = T.run_train_chaos(
            net, tr, lambda o, l: (o - l) ** 2, (X, y), steps, injectors)
    scale = None if scaler is None else tr.loss_scaler.loss_scale
    return losses, [o.value for o in outcomes], scale, tr, injectors


def _port_state(tr):
    return [p.data()._data.clone() for p in tr._params] + [
        x.clone() for i in sorted(tr._updaters[0].states)
        for x in tree_leaves(tr._updaters[0].states[i])]


def test_nan_grad_skips_as_jax_and_leaves_state_bit_identical():
    jnet, tnet = _pair()
    runs = {}
    for P, net in ((JAX, jnet), (PORT, tnet)):
        runs[P] = _chaos(P, net, lambda T: [T.NaNGrad(at_step=2, seed=1),
                                            T.NaNGrad(at_step=4, seed=2)],
                         6)
    (jl, jo, _, _, _), (tl, to, _, ttr, inj) = runs[JAX], runs[PORT]
    assert to == jo == ["APPLIED", "APPLIED", "SKIPPED_NONFINITE",
                        "APPLIED", "SKIPPED_NONFINITE", "APPLIED"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert all(i.fired and i.log for i in inj)
    before = _port_state(ttr)
    with mx.cpu():
        _, outcomes = train.run_train_chaos(
            tnet, ttr, lambda o, l: (o - l) ** 2,
            (np.ones((8, 8), np.float32), np.ones((8, 4), np.float32)), 1,
            [NaNGrad(at_step=0)])
    assert outcomes == [StepOutcome.SKIPPED_NONFINITE]
    assert all(torch.equal(a, b) for a, b in zip(before, _port_state(ttr)))


def test_overflow_storm_scale_trajectory_equals_jax():
    jnet, tnet = _pair()
    runs = {}
    for P, net in ((JAX, jnet), (PORT, tnet)):
        runs[P] = _chaos(
            P, net,
            lambda T: [T.OverflowStorm(at_step=1, overflow_above=4.0)], 9,
            scaler=P.LossScaler(init_scale=32.0, scale_window=3))
    (jl, jo, js, _, jinj), (tl, to, ts, _, tinj) = runs[JAX], runs[PORT]
    assert to == jo and ts == js
    assert tinj[0].overflow_steps == jinj[0].overflow_steps == 4
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    with pytest.raises(MXNetError, match="LossScaler"):
        _chaos(PORT, _pair()[1], lambda T: [T.OverflowStorm(0, 1.0)], 1)


def test_nan_batch_poisons_the_same_entries_as_jax():
    X = np.zeros((4, 6), np.float32)
    y = np.arange(4)
    got = NaNBatch(at_step=1, n_entries=3, seed=4)
    want = jtrain.NaNBatch(at_step=1, n_entries=3, seed=4)
    assert got.on_batch(0, [X, y]) == [X, y]
    out = got.on_batch(1, [mx.nd.array(X, ctx=mx.cpu()), y])
    ref = want.on_batch(1, [X, y])
    np.testing.assert_array_equal(np.isnan(out[0]), np.isnan(ref[0]))
    assert np.isnan(out[0]).sum() == 3 and got.fired
    with pytest.raises(MXNetError, match="no float array"):
        NaNBatch(at_step=0).on_batch(0, [y])


def test_slow_step_and_kill_self_fire_in_their_window(tmp_path):
    slow = SlowStep(start=1, end=2, sleep_s=0.2)
    t0 = time.monotonic()
    slow.on_step_begin(0, None)
    assert time.monotonic() - t0 < 0.15 and not slow.fired
    slow.on_step_begin(1, None)
    assert time.monotonic() - t0 >= 0.2 and slow.fired
    marker = tmp_path / "killed_3"
    marker.write_text("killed in a past life\n")
    kill = KillSelf(at_step=3, marker=str(marker))
    kill.on_step_begin(5, None)          # already fired: a no-op
    assert not kill.fired
    argv = _script(tmp_path, f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        from incubator_mxnet_tpu_torch.train import KillSelf
        k = KillSelf(at_step=2, marker={str(tmp_path / "once")!r})
        for s in range(4):
            k.on_step_begin(s, None)
    """)
    report = Supervisor(argv, max_restarts=2, backoff_s=0.01).run()
    assert report.restarts == 1
    assert report.attempts[0].term_signal == signal.SIGKILL


# ------------------------------------------------------------------ #
# end to end: kill -9 the port's example target twice
# ------------------------------------------------------------------ #

def _run_target(tmp_path, tag, steps, kill_at="", max_restarts=0):
    ckpt = tmp_path / f"ckpt_{tag}"
    results = tmp_path / f"results_{tag}.jsonl"
    ckpt.mkdir()
    env = {
        "PYTHONPATH": ROOT,
        "MXTPU_TGT_DEVICE": "cpu",
        "MXTPU_TGT_CKPT_DIR": str(ckpt),
        "MXTPU_TGT_RESULTS": str(results),
        "MXTPU_TGT_STEPS": str(steps),
        "MXTPU_TGT_SAVE_EVERY": "2",
        "MXTPU_TGT_KILL_AT": kill_at,
    }
    sup = Supervisor(
        [sys.executable, "-m",
         "incubator_mxnet_tpu_torch.train.example_target"],
        ckpt_dir=str(ckpt), progress_file=str(results),
        max_restarts=max_restarts, backoff_s=0.05, env=env)
    report = sup.run()
    by_step = {}
    with open(results) as f:
        for line in f:
            rec = json.loads(line)
            by_step[rec["step"]] = rec["loss"]
    return report, by_step


@pytest.mark.slow
def test_kill9_twice_resumes_bit_exact(tmp_path):
    steps = 14
    _, clean = _run_target(tmp_path, "clean", steps)
    report, survived = _run_target(tmp_path, "killed", steps,
                                   kill_at="5,9", max_restarts=4)
    assert report.completed
    assert report.restarts == 2
    assert sorted(a.reason for a in report.attempts) == \
        ["completed", "crash", "crash"]
    assert set(survived) == set(clean) == set(range(steps))
    for s in range(steps):
        assert survived[s] == clean[s], \
            f"loss diverged at step {s}: {survived[s]} != {clean[s]}"
    assert len(report.backoffs) == 2
    assert all(b >= 0.05 for b in report.backoffs)
