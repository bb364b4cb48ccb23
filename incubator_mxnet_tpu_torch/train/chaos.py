"""Deterministic fault injection (chaos) for the TRAINING loop: the port
of the JAX package's ``incubator_mxnet_tpu/train/chaos.py`` over the
port's trainers.

Long pretraining dies from a handful of fault families: a bad batch or
diverging weights putting a NaN in one gradient (which an unguarded
fused step bakes into every parameter), a loss-scale overflow storm, a
``kill -9`` preemption mid-step, a wedged step that hangs the run, and a
flaky data pipeline. Each injector models one of those, fires at a
deterministic STEP INDEX (not wall time), and draws all randomness from
its own seeded ``RandomState``, so a harness can assert the training
resilience contract:

  - every step ends in exactly one recorded ``StepOutcome``;
  - a skipped step leaves params/optimizer state BIT-IDENTICAL;
  - the loss scale halves under overflow and regrows when clean;
  - the fused step builds its programs once across fault transitions;
  - a killed run resumes to a bit-exact loss sequence (supervisor).

Hooks (drive them from any loop; ``run_train_chaos`` is the canonical
eager-Trainer loop):

  ``on_step_begin(step_idx, trainer)``   before forward
  ``on_batch(step_idx, arrays) -> arrays``  corrupt the input batch
  ``on_grads(step_idx, trainer)``        after backward, before step()
"""

from __future__ import annotations

import os
import signal as _signal
import time
from typing import List, Optional, Sequence

import numpy as np

from ..base import MXNetError

__all__ = ["TrainChaosInjector", "NaNGrad", "OverflowStorm", "NaNBatch",
           "SlowStep", "KillSelf", "run_train_chaos"]


class TrainChaosInjector:
    """Base: a seeded training fault with an injection log."""

    name = "train_chaos"

    def __init__(self, seed: int = 0):
        self.rng = np.random.RandomState(seed)
        self.log: List[str] = []
        self.fired = False

    def on_step_begin(self, step_idx: int, trainer) -> None:
        pass

    def on_batch(self, step_idx: int, arrays):
        return arrays

    def on_grads(self, step_idx: int, trainer) -> None:
        pass


def _poison_grad(param, n_entries: int, rng, value=np.nan) -> int:
    """Overwrite ``n_entries`` random entries of ``param``'s gradient
    with ``value``, in the gradient tensor itself (the entries are drawn
    on the host; chaos is off the hot path)."""
    import torch
    g = param.grad()._data
    idx = rng.choice(g.numel(), size=min(n_entries, g.numel()),
                     replace=False)
    with torch.no_grad():
        g.view(-1)[torch.as_tensor(idx, device=g.device)] = float(value)
    return len(idx)


class NaNGrad(TrainChaosInjector):
    """Poison one parameter's gradient with NaN at step ``at_step`` —
    the 'bad batch / numerics bug produced a NaN gradient' fault. The
    guard must skip exactly that step with every parameter and
    optimizer-state leaf bit-identical to before it."""

    name = "nan_grad"

    def __init__(self, at_step: int, n_entries: int = 2,
                 param_idx: int = 0, seed: int = 0):
        super().__init__(seed)
        self.at_step = at_step
        self.n_entries = n_entries
        self.param_idx = param_idx

    def on_grads(self, step_idx, trainer):
        if self.fired or step_idx < self.at_step:
            return
        self.fired = True
        params = [p for p in trainer._params if p.grad_req != "null"]
        p = params[self.param_idx % len(params)]
        n = _poison_grad(p, self.n_entries, self.rng)
        self.log.append(f"step {step_idx}: NaN-poisoned {n} entries of "
                        f"grad({p.name})")


class OverflowStorm(TrainChaosInjector):
    """Scale-dependent overflow: from ``at_step`` on, gradients go Inf
    WHILE the trainer's loss scale is above ``overflow_above`` — the
    'fp16 dynamic range exceeded' fault. The scaler must halve its way
    below the threshold (each halving costs one skipped step), then the
    run must go clean and, after ``scale_window`` clean steps, regrow."""

    name = "overflow_storm"

    def __init__(self, at_step: int, overflow_above: float,
                 seed: int = 0):
        super().__init__(seed)
        self.at_step = at_step
        self.overflow_above = float(overflow_above)
        self.overflow_steps = 0

    def on_grads(self, step_idx, trainer):
        if step_idx < self.at_step:
            return
        scaler = getattr(trainer, "_amp_loss_scaler", None) or \
            getattr(trainer, "loss_scaler", None)
        if scaler is None:
            raise MXNetError("OverflowStorm needs a trainer with a "
                             "LossScaler attached")
        if scaler.loss_scale > self.overflow_above:
            self.fired = True
            self.overflow_steps += 1
            params = [p for p in trainer._params if p.grad_req != "null"]
            n = _poison_grad(params[0], 1, self.rng, value=np.inf)
            self.log.append(
                f"step {step_idx}: overflow (scale "
                f"{scaler.loss_scale:g} > {self.overflow_above:g}), "
                f"{n} Inf entries")


class NaNBatch(TrainChaosInjector):
    """Corrupt the input batch with NaN at step ``at_step`` — the
    SPMD-path fault (gradients live inside the fused program, so the
    fault enters through the data). The in-program guard must skip the
    step on every rank."""

    name = "nan_batch"

    def __init__(self, at_step: int, n_entries: int = 4, seed: int = 0):
        super().__init__(seed)
        self.at_step = at_step
        self.n_entries = n_entries

    def on_batch(self, step_idx, arrays):
        if self.fired or step_idx < self.at_step:
            return arrays
        self.fired = True
        out = []
        poisoned = False
        for a in arrays:
            arr = np.array(a.asnumpy() if hasattr(a, "asnumpy") else a,
                           copy=True)
            if not poisoned and np.issubdtype(arr.dtype, np.floating):
                flat = arr.reshape(-1)
                idx = self.rng.choice(
                    flat.size, size=min(self.n_entries, flat.size),
                    replace=False)
                flat[idx] = np.nan
                poisoned = True
            out.append(arr)
        if not poisoned:
            raise MXNetError("NaNBatch found no float array to poison")
        self.log.append(f"step {step_idx}: NaN-poisoned the batch")
        return out


class SlowStep(TrainChaosInjector):
    """Host stall: sleep ``sleep_s`` before steps in [start, end) —
    models a preempted host / GC storm. Long enough, it drives the
    supervisor's zero-progress watchdog."""

    name = "slow_step"

    def __init__(self, start: int, end: int, sleep_s: float,
                 seed: int = 0):
        super().__init__(seed)
        self.start = start
        self.end = end
        self.sleep_s = sleep_s

    def on_step_begin(self, step_idx, trainer):
        if self.start <= step_idx < self.end:
            self.fired = True
            time.sleep(self.sleep_s)


class KillSelf(TrainChaosInjector):
    """``kill -9`` the CURRENT process at step ``at_step`` — the
    preemption / OOM-kill fault, for use inside a supervised training
    SUBPROCESS (``example_target``). Guarded by a marker file so the
    fault fires only once across restarts."""

    name = "kill_self"

    def __init__(self, at_step: int, marker: Optional[str] = None,
                 sig: int = _signal.SIGKILL, seed: int = 0):
        super().__init__(seed)
        self.at_step = at_step
        self.marker = marker
        self.sig = sig

    def on_step_begin(self, step_idx, trainer):
        if step_idx < self.at_step:
            return
        if self.marker is not None:
            if os.path.exists(self.marker):
                return                   # already fired in a past life
            with open(self.marker, "w") as f:
                f.write(f"killed at step {step_idx}\n")
        self.fired = True
        os.kill(os.getpid(), self.sig)


# --------------------------------------------------------------------- #
def run_train_chaos(net, trainer, loss_fn, data, steps: int,
                    injectors: Sequence[TrainChaosInjector] = (),
                    batch_size: Optional[int] = None):
    """The canonical eager-Trainer chaos loop: fixed data, ``steps``
    steps, injectors firing at their hooks, exactly-one-outcome-per-step
    asserted after every step. Returns ``(losses, outcomes)`` — the
    per-step UNSCALED loss and recorded ``StepOutcome`` sequences (the
    parity oracle: unfaulted steps must match a fault-free run's
    bit-exactly). The batches land on the current context."""
    from .. import autograd, nd

    X, y = data
    bs = batch_size if batch_size is not None else int(X.shape[0])
    losses, outcomes = [], []
    for s in range(steps):
        for inj in injectors:
            inj.on_step_begin(s, trainer)
        arrays = [X, y]
        for inj in injectors:
            arrays = inj.on_batch(s, arrays)
        xb = nd.array(np.asarray(arrays[0]))
        yb = nd.array(np.asarray(arrays[1]))
        with autograd.record():
            L = loss_fn(net(xb), yb).mean()
        trainer.backward(L)   # dynamic scale rides the backward seed
        for inj in injectors:
            inj.on_grads(s, trainer)
        before = trainer._recorder.step_count
        trainer.step(bs)
        if trainer._recorder.step_count != before + 1:
            raise MXNetError(
                f"step {s} recorded {trainer._recorder.step_count - before}"
                f" outcomes — exactly-one-outcome-per-step violated")
        losses.append(float(L.asnumpy()))
        outcomes.append(trainer.last_outcome)
    return losses, outcomes
