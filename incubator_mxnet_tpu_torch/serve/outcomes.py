"""Structured terminal outcomes for serving requests.

Every request handed to the engine ends in EXACTLY ONE terminal
outcome — success-or-exception is not a contract a serving tier can
offer under overload and faults (docs/RESILIENCE.md). The taxonomy:

  EOS                 stopped at the request's eos_id (success)
  MAX_TOKENS          generated max_new_tokens (success)
  STOP                a client stop sequence matched the generated
                      stream (success; the matched sequence is NOT
                      part of the output — serve/sampling.py)
  DEADLINE_EXPIRED    the request's deadline (or the engine's per-slot
                      wall cap) passed — queued requests are dropped,
                      decoding slots are evicted with their pages
                      reclaimed; partial tokens are kept
  SHED                refused at admission (bounded queue depth /
                      estimated queue delay over the limit) or failed
                      by an engine shutdown; ``retry_after_s`` carries
                      the backpressure hint
  FAILED_NONFINITE    the slot's logits went non-finite (poisoned
                      weights / corrupt KV) — quarantined and failed
                      rather than sampling garbage forever
  FAILED_UNSERVABLE   the request can never (or did not, within the
                      watchdog/stall budget) get the pages it needs —
                      too large for the pool, or page-starved
  FAILED_REPLICA      the fleet router re-queued the request across
                      replica deaths ``max_requeues`` times (or had no
                      serving replica left) and gave up — bounded
                      recovery, never a silent loss (serve/router.py)
  PREEMPTED           a higher-tier admission reclaimed the request's
                      slot ``max_preemptions`` times and the engine
                      gave up re-queuing it — bounded, retryable,
                      partial tokens kept (an in-budget preemption is
                      NOT terminal: the request re-queues through
                      normal admission as a resume-from-suffix replay,
                      continuation bit-identical — serve/slo.py)
  CANCELLED           the client withdrew the request
                      (``engine.cancel`` / ``router.cancel``) — a
                      first-class transition from ANY live state
                      (queued, prefilling, mid-decode,
                      mid-spec-verify) with pages reclaimed and
                      partial tokens kept; not retryable (the client
                      asked for it)

``EOS`` and ``MAX_TOKENS`` are the success outcomes (``.ok``); the
rest are the failure surface the chaos harness (serve/chaos.py,
tools/chaos_bench.py) drives and asserts. ``.retryable`` marks the
outcomes a client (or the fleet router) may legitimately retry —
every terminal with a retryable outcome carries a machine-readable
``retry_after_s`` backoff hint (one contract, engine- and
router-level; asserted in tests/test_router.py).
"""

from __future__ import annotations

import enum

__all__ = ["Outcome"]


class Outcome(enum.Enum):
    EOS = "EOS"
    MAX_TOKENS = "MAX_TOKENS"
    STOP = "STOP"
    DEADLINE_EXPIRED = "DEADLINE_EXPIRED"
    SHED = "SHED"
    FAILED_NONFINITE = "FAILED_NONFINITE"
    FAILED_UNSERVABLE = "FAILED_UNSERVABLE"
    FAILED_REPLICA = "FAILED_REPLICA"
    PREEMPTED = "PREEMPTED"
    CANCELLED = "CANCELLED"

    @property
    def ok(self) -> bool:
        """True for the success outcomes (the request's own stopping
        condition, not an engine intervention)."""
        return self in (Outcome.EOS, Outcome.MAX_TOKENS, Outcome.STOP)

    @property
    def retryable(self) -> bool:
        """True for the shed/deadline-class outcomes a client may retry
        (elsewhere, or later): the request itself was fine, the system
        lacked capacity/time/replicas for it. These are exactly the
        outcomes that must carry a ``retry_after_s`` hint. CANCELLED
        is deliberately absent: the client withdrew the request, so
        'retry later' is not advice it asked for."""
        return self in (Outcome.SHED, Outcome.DEADLINE_EXPIRED,
                        Outcome.FAILED_REPLICA, Outcome.PREEMPTED)

    def __str__(self) -> str:  # readable in logs / JSON dumps
        return self.value
