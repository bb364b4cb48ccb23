"""Structured terminal outcomes for TRAINING steps: a copy of the JAX
package's ``incubator_mxnet_tpu/train/outcomes.py`` (host-only code).

The serving engine learned in round 10 that "success or exception" is
not a contract a production tier can offer; round 13 teaches the
training loop the same lesson. Every optimizer step taken through
``gluon.Trainer`` or ``parallel.SPMDTrainer`` ends in EXACTLY ONE
structured outcome, funneled through one recorder (the serving
``_record_terminal`` pattern):

  APPLIED             the update was applied to the parameters
  SKIPPED_NONFINITE   the in-step guard saw a non-finite gradient —
                      params and optimizer state are bit-identical to
                      before the step (a traced ``where``-select, not a
                      host branch); with a loss scaler attached the
                      scale was halved
  SKIPPED_STALE       every candidate gradient was stale (backward has
                      not refilled it since the last step) and
                      ``ignore_stale_grad`` skipped them all — nothing
                      was applied
  HALTED_POISONED     ``max_consecutive_nonfinite`` steps in a row were
                      non-finite — the gradients are poisoned (bad
                      weights, divergence, corrupt data), not merely
                      overflowed, and the trainer halts LOUDLY with a
                      diagnostic instead of skip-looping forever

``APPLIED`` is the success outcome (``.ok``); ``SKIPPED_NONFINITE`` is
the self-healing path dynamic loss scaling rides on; the halt is the
"wake the operator" path. In the port, ``parallel.SPMDTrainer`` is the
trainer that records them.
"""

from __future__ import annotations

import enum
import os
from typing import Optional

from ..base import MXNetError

__all__ = ["StepOutcome", "StepRecorder"]


class StepOutcome(enum.Enum):
    APPLIED = "APPLIED"
    SKIPPED_NONFINITE = "SKIPPED_NONFINITE"
    SKIPPED_STALE = "SKIPPED_STALE"
    HALTED_POISONED = "HALTED_POISONED"

    @property
    def ok(self) -> bool:
        return self is StepOutcome.APPLIED

    @property
    def skipped(self) -> bool:
        """True when the step left params/optimizer state untouched."""
        return self is not StepOutcome.APPLIED

    def __str__(self) -> str:  # readable in logs / JSON dumps
        return self.value


class StepRecorder:
    """The single point where a training step becomes terminal.

    Both trainers drive the same protocol per ``step()`` call::

        recorder.open_step()
        ... dispatch the (guarded) fused update ...
        outcome = recorder.record(StepOutcome..., detail=...)
        if outcome is StepOutcome.HALTED_POISONED: raise ...

    ``open_step``/``record`` enforce exactly-one-outcome-per-step by
    construction: recording outside an open step (a double-record) and
    opening a step whose predecessor never recorded are both loud
    ``MXNetError``s — a silent miscount would lie to the operator
    exactly when the run is sick (the serve ``_record_terminal``
    contract).

    ``record`` also owns the poison escalation: ``SKIPPED_NONFINITE``
    bumps a consecutive counter, and the K-th consecutive non-finite
    step (K = ``max_consecutive_nonfinite``, default
    ``MXTPU_MAX_NONFINITE_STEPS`` or 25) is escalated to
    ``HALTED_POISONED`` — with dynamic loss scaling attached, K skips
    have already halved the scale K times, so a still-non-finite
    gradient is poison (NaN weights, divergence), not overflow.
    """

    def __init__(self, max_consecutive_nonfinite: Optional[int] = None,
                 flight=None, component: str = "trainer"):
        if max_consecutive_nonfinite is None:
            try:
                max_consecutive_nonfinite = int(os.environ.get(
                    "MXTPU_MAX_NONFINITE_STEPS", 25))
            except ValueError:
                max_consecutive_nonfinite = 25
        self.max_consecutive_nonfinite = int(max_consecutive_nonfinite)
        self.health = {o.value: 0 for o in StepOutcome}
        self.consecutive_nonfinite = 0
        self.step_count = 0          # recorded steps (== sum of health)
        self.last_outcome: Optional[StepOutcome] = None
        self.last_detail: str = ""
        self._open = False
        # flight recorder (events.py, docs/OBSERVABILITY.md):
        # every recorded StepOutcome also lands as ONE TRAIN_STEP
        # event — the same exactly-once construction as the outcome —
        # and a HALTED_POISONED escalation dumps a postmortem naming
        # the trainer. ``flight=False`` disables; default is a private
        # bounded ring (no request latencies → no histograms).
        from ..events import resolve_recorder
        self.flight = resolve_recorder(flight, histograms=False)
        self.component = str(component)

    # ------------------------------------------------------------------ #
    def open_step(self) -> None:
        if self._open:
            raise MXNetError(
                "previous training step never recorded an outcome — "
                "exactly-one-outcome-per-step is a trainer bug")
        self._open = True

    def record(self, outcome: StepOutcome, detail: str = "") -> StepOutcome:
        """Record this step's outcome (escalating to HALTED_POISONED at
        the consecutive-non-finite bound) and return the outcome
        actually recorded."""
        if not self._open:
            raise MXNetError(
                f"step outcome {outcome} recorded outside an open step "
                f"— double-record is a trainer bug")
        if outcome is StepOutcome.SKIPPED_NONFINITE:
            self.consecutive_nonfinite += 1
            if self.max_consecutive_nonfinite > 0 and \
                    self.consecutive_nonfinite >= \
                    self.max_consecutive_nonfinite:
                outcome = StepOutcome.HALTED_POISONED
        elif outcome is StepOutcome.APPLIED:
            self.consecutive_nonfinite = 0
        self.health[outcome.value] += 1
        self.step_count += 1
        self.last_outcome = outcome
        self.last_detail = detail
        self._open = False
        from ..events import EventType
        self.flight.emit(self.component, EventType.TRAIN_STEP,
                         step=self.step_count, outcome=outcome.value,
                         detail=detail[:200])
        if outcome is StepOutcome.HALTED_POISONED:
            self.flight.postmortem(
                "HALTED_POISONED", self.component,
                context={"consecutive_nonfinite":
                         self.consecutive_nonfinite,
                         "detail": detail[:400]})
        return outcome

    def abort_step(self) -> None:
        """Close an open step WITHOUT an outcome — only for a step that
        failed before reaching the recorder (an exception out of
        backward/dispatch is a real error, not a step outcome)."""
        self._open = False

    def halt_error(self, detail: str,
                   loss_scale: Optional[float] = None) -> MXNetError:
        """The HALTED_POISONED diagnostic, built in ONE place so the
        trainers cannot drift apart. Callers raise the returned error
        after ``record`` escalates."""
        msg = (f"training halted: {self.consecutive_nonfinite} "
               f"consecutive non-finite steps "
               f"(max {self.max_consecutive_nonfinite}) — gradients are "
               f"poisoned, not overflowed")
        if loss_scale is not None:
            msg += f" (loss scale already decayed to {loss_scale:g})"
        return MXNetError(f"{msg}; {detail}")

    # ------------------------------------------------------------------ #
    def snapshot(self) -> dict:
        """Detached, single-pass copy of the health state (the
        ``health_snapshot()`` read every scraper/bench uses — never the
        live-mutated dict)."""
        return {
            "health": dict(self.health),
            "step_count": int(self.step_count),
            "consecutive_nonfinite": int(self.consecutive_nonfinite),
            "max_consecutive_nonfinite":
                int(self.max_consecutive_nonfinite),
            "last_outcome":
                None if self.last_outcome is None
                else self.last_outcome.value,
            "last_detail": self.last_detail,
        }

    # -- checkpoint capsule ride-along --------------------------------- #
    def state_dict(self) -> dict:
        return {"health": dict(self.health),
                "step_count": int(self.step_count),
                "consecutive_nonfinite": int(self.consecutive_nonfinite),
                "last_outcome": None if self.last_outcome is None
                else self.last_outcome.value,
                "last_detail": self.last_detail}

    def load_state_dict(self, state: dict) -> None:
        for k, v in (state.get("health") or {}).items():
            if k in self.health:
                self.health[k] = int(v)
        self.step_count = int(state.get("step_count", 0))
        self.consecutive_nonfinite = int(
            state.get("consecutive_nonfinite", 0))
        last = state.get("last_outcome")
        self.last_outcome = None if last is None else StepOutcome(last)
        self.last_detail = str(state.get("last_detail", ""))
