"""SLO tiers for the serving path: the priority classes and per-tier
admission policies (the port of ``incubator_mxnet_tpu/serve/slo.py``'s
``Tier`` / ``TierPolicy`` half; the brownout controller is not ported
yet).

  - ``Tier``: every ``Request`` carries one of three priority classes.
    LATENCY outranks STANDARD outranks BATCH in admission order, shed
    order (BATCH drains first) and slot preemption (a LATENCY admission
    may preempt a BATCH slot mid-decode).
  - ``TierPolicy``: per-tier scoping of the engine's admission knobs —
    ``max_queue`` / ``max_queue_delay_s`` / default deadlines — plus the
    preemption contract (``preemptible`` / ``can_preempt``).

Everything here is host-side policy.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from ..base import MXNetError

__all__ = ["Tier", "TierPolicy", "default_tier_policies",
           "resolve_tier_policies"]


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
