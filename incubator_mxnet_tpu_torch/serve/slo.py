"""SLO tiers and brownout degradation for the serving path (the port of
``incubator_mxnet_tpu/serve/slo.py``).

  - ``Tier``: every ``Request`` carries one of three priority classes.
    LATENCY outranks STANDARD outranks BATCH in admission order, shed
    order (BATCH drains first) and slot preemption (a LATENCY admission
    may preempt a BATCH slot mid-decode).
  - ``TierPolicy``: per-tier scoping of the engine's admission knobs —
    ``max_queue`` / ``max_queue_delay_s`` / default deadlines — plus the
    preemption contract (``preemptible`` / ``can_preempt``).
  - ``BrownoutController``: a deterministic hysteresis controller over
    ``health_snapshot()`` pressure signals (the priority tiers' estimated
    queue delay, backlog, page and slot occupancy) that steps the engine
    through degrade levels — 1: speculation off, 2: the chunked-prefill
    budget clamped to one chunk, 3: BATCH admissions held — and back out
    as pressure clears. ``wants_rebalance`` is the level at which a
    fleet moves work off a replica.

Everything here is host-side policy: no level reaches a program, so no
capture count moves.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

from ..base import MXNetError
from .events import EventType

__all__ = ["Tier", "TierPolicy", "default_tier_policies",
           "resolve_tier_policies", "BrownoutController",
           "REBALANCE_LEVEL", "wants_rebalance"]

# the brownout level at which a fleet should start MOVING work off a
# replica instead of only degrading it in place: level 2 is where the
# replica begins trading prompt latency for decode headroom
REBALANCE_LEVEL = 2


def wants_rebalance(level: int) -> bool:
    """Should a fleet rebalance work OFF a replica at this brownout
    level?"""
    return int(level) >= REBALANCE_LEVEL


class Tier(enum.Enum):
    """Request priority class. ``order`` is the scheduling rank —
    lower is served first, higher is shed/preempted first."""

    LATENCY = "LATENCY"
    STANDARD = "STANDARD"
    BATCH = "BATCH"

    @property
    def order(self) -> int:
        return _TIER_ORDER[self]

    def __str__(self) -> str:
        return self.value


_TIER_ORDER = {Tier.LATENCY: 0, Tier.STANDARD: 1, Tier.BATCH: 2}


@dataclasses.dataclass
class TierPolicy:
    """Per-tier scoping of the engine admission knobs.

    ``max_queue`` bounds how many requests of THIS tier may sit in the
    admission queue (None = inherit the global bound only);
    ``max_queue_delay_s`` is the tier's estimated-delay shed limit
    (None = inherit the global one); ``default_deadline_s`` is applied
    to requests submitted without a deadline (None = no default).
    ``preemptible`` marks the tier's slots reclaimable by a
    higher-priority admission; ``can_preempt`` lets the tier's
    admissions claim them. Defaults (``default_tier_policies``):
    LATENCY preempts, BATCH is preemptible, STANDARD neither."""

    max_queue: Optional[int] = None
    max_queue_delay_s: Optional[float] = None
    default_deadline_s: Optional[float] = None
    preemptible: bool = False
    can_preempt: bool = False


def default_tier_policies() -> dict:
    return {Tier.LATENCY: TierPolicy(can_preempt=True),
            Tier.STANDARD: TierPolicy(),
            Tier.BATCH: TierPolicy(preemptible=True)}


def resolve_tier_policies(overrides: Optional[dict]) -> dict:
    """Merge user overrides over the defaults, coercing string tier
    keys."""
    pols = default_tier_policies()
    for t, pol in (overrides or {}).items():
        if isinstance(t, str):
            t = Tier(t)
        if not isinstance(pol, TierPolicy):
            raise MXNetError(f"tier_policies[{t}] must be a "
                             f"TierPolicy, got {pol!r}")
        pols[t] = pol
    return pols


class BrownoutController:
    """Deterministic hysteresis over the engine's pressure signals.

    ``update(engine)`` is called once per engine scheduler step. It
    computes a scalar pressure in [0, ~1]:

        delay_norm  the PRIORITY tiers' estimated queue delay
                    (LATENCY+STANDARD backlog — never the clamped
                    BATCH queue, see ``pressure``) / delay_ref (0
                    when the estimate is uncalibrated or no
                    reference is set)
        backlog     min(1, queue_depth / num_slots) — degradation
                    needs WAITING work; a fully-busy engine with an
                    empty queue is healthy, not overloaded
        page_norm   1 - free_pages / usable_pages
        occ         active_slots / num_slots

        pressure = max(delay_norm, backlog * max(page_norm, occ))

    and steps the level at most one per transition: the level RISES
    after ``up_steps`` consecutive updates with pressure >= the next
    level's ``enter`` threshold, and FALLS after ``down_steps``
    consecutive updates with pressure below the current level's enter
    threshold minus ``exit_margin`` (hysteresis — a flapping signal
    cannot flap the level). All inputs come from
    ``engine.health_snapshot()``; the controller is a pure function of
    the observed signal sequence, so a replayed workload replays the
    same brownout timeline."""

    def __init__(self, enter: Tuple[float, float, float] = (0.70, 0.85,
                                                            0.95),
                 exit_margin: float = 0.20, up_steps: int = 2,
                 down_steps: int = 8,
                 delay_ref: Optional[float] = None):
        if len(enter) != 3 or list(enter) != sorted(enter):
            raise ValueError(f"enter thresholds must be 3 ascending "
                             f"values, got {enter}")
        self.enter = tuple(float(e) for e in enter)
        self.exit_margin = float(exit_margin)
        self.up_steps = int(up_steps)
        self.down_steps = int(down_steps)
        self.delay_ref = delay_ref
        self.level = 0
        self.escalations = 0
        self.deescalations = 0
        self.timeline: List[dict] = []       # one entry per transition
        self.flight = None                   # FlightRecorder the owning
                                             # engine attaches — every
                                             # transition then lands on
                                             # its event timeline too
        self._over = 0
        self._under = 0

    def pressure(self, snap: dict, usable_pages: int) -> float:
        delay_ref = self.delay_ref
        # the delay signal is the PRIORITY tiers' estimate (LATENCY +
        # STANDARD backlog) — the work brownout exists to protect. It
        # must NOT include the BATCH queue: level 3 clamps BATCH
        # admissions, so a BATCH-inclusive estimate would stay high
        # exactly because of the clamp and the controller could never
        # step back down (a self-sustaining brownout deadlock).
        est = snap.get("estimated_queue_delay_priority_s",
                       snap.get("estimated_queue_delay_s"))
        delay_norm = (est / delay_ref) if (est and delay_ref) else 0.0
        n_slots = max(1, snap["num_slots"])
        # the backlog gate is PRIORITY work waiting, for the same
        # reason as the delay signal: a level-3-clamped BATCH queue
        # sits there BECAUSE of the clamp — counting it would let
        # steady LATENCY occupancy hold level 3 forever after the
        # priority backlog cleared
        qd = snap["queue_depth"]
        by_tier = snap.get("queue_depth_by_tier")
        if by_tier:
            qd -= by_tier.get(Tier.BATCH.value, 0)
        backlog = min(1.0, qd / n_slots)
        page_norm = 1.0 - snap["free_pages"] / max(1, usable_pages)
        occ = snap["active_slots"] / n_slots
        return max(delay_norm, backlog * max(page_norm, occ))

    def update(self, engine) -> int:
        """One evaluation; returns the (possibly new) level."""
        snap = engine.health_snapshot()
        p = self.pressure(snap, engine.num_pages - 1)
        if self.level < 3 and p >= self.enter[self.level]:
            self._over += 1
            self._under = 0
            if self._over >= self.up_steps:
                self._transition(engine, self.level + 1, p)
                self._over = 0
        elif self.level > 0 and \
                p < self.enter[self.level - 1] - self.exit_margin:
            self._under += 1
            self._over = 0
            if self._under >= self.down_steps:
                self._transition(engine, self.level - 1, p)
                self._under = 0
        else:
            self._over = 0
            self._under = 0
        return self.level

    def _transition(self, engine, new_level: int, p: float):
        entry = {"step": int(engine.decode_steps),
                 "from": self.level, "to": new_level,
                 "pressure": round(float(p), 4)}
        if new_level > self.level:
            self.escalations += 1
        else:
            self.deescalations += 1
        if self.flight is not None:
            self.flight.emit(
                getattr(engine, "_component", "engine"),
                EventType.BROWNOUT, entity="brownout",
                from_level=self.level, to_level=new_level,
                pressure=entry["pressure"], step=entry["step"])
        self.level = new_level
        self.timeline.append(entry)
