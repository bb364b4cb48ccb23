"""Fleet router: N serving replicas behind one admission surface.

The port of ``incubator_mxnet_tpu/serve/router.py``: the same host-side
scheduling over N ``InferenceEngine`` replicas, which on the card share
one GPU (each replica replays its own CUDA graphs). What a fleet adds
that no single engine can:

  - **Cache-affinity routing.** What prefix caching saves only
    survives scale-out if a request lands where its prefix lives.
    Admission probes every SERVING replica's prefix index
    (``engine.prefix_probe`` — a read-only query, no refcounts, no LRU
    ticks) and routes to the longest match; when nobody has the prefix,
    it SPILLS to the least-estimated-delay replica (the
    ``health_snapshot`` EWMA/queue signals). Affinity is a preference
    among replicas WITH capacity — a full replica is never chosen over
    an idle one just because it is warm (the spill rule).
  - **Structured failover.** A replica death mid-decode must become a
    bounded re-queue, never a lost (or double-finished) request.
    Per-replica health states:

        SERVING   routable; heartbeats healthy
        WARMING   just admitted (``add_replica``) or fresh from a
                  rolling weight swap: routable for SPILL/round-robin
                  only — the affinity probe skips it until it has
                  earned ``warmup_steps`` consecutive healthy steps
                  (compile steps are heartbeat-exempt AND not warmup
                  evidence, exactly the breaker's cold-start rule),
                  then it graduates to SERVING
        DEGRADED  circuit breaker open after ``breaker_failures``
                  consecutive heartbeat misses (a step slower than
                  ``heartbeat_timeout_s``): no new admissions; the
                  replica is only stepped as a HALF-OPEN PROBE on a
                  seeded-jitter exponential backoff schedule;
                  ``probe_recovery`` consecutive healthy probes close
                  the breaker back to SERVING
        DRAINING  leaving the fleet (``remove_replica``) or swapping
                  weights (``upgrade_replica``): no new admissions;
                  queued attempts withdraw back to the router, decode-
                  ready slots migrate to siblings (page capsules,
                  replay fallback), still-prefilling slots finish in
                  place — the router's own step loop finalises the
                  drain (retire or warm_start) the pass the last slot
                  leaves, so a supervisor death mid-transition can
                  never wedge the fleet
        DEAD      the replica raised out of a step (``ReplicaKilled``
                  or any engine exception — its state can no longer be
                  trusted): terminal, never probed again
        RETIRED   drained out clean by ``remove_replica`` and shut
                  down: terminal, never stepped again. Retired (and
                  dead) replicas stay in ``self.replicas`` as
                  TOMBSTONES — replica index == list position is
                  load-bearing across every in-flight bookkeeping
                  structure, so membership changes never renumber

    On death every in-flight request of that replica is RE-QUEUED with
    its already-emitted tokens preserved: the replay attempt's prompt
    is ``original prompt + emitted tokens`` submitted through NORMAL
    admission on another replica — so the prefix cache absorbs the
    redone work, and because sampling is keyed by absolute sequence
    position under a router-pinned per-request seed, the continuation
    is bit-identical to the tokens the dead replica would have
    produced (greedy trivially; temperature by the per-request RNG
    convention, docs/SERVING.md). Re-queues are BOUNDED:
    ``max_requeues`` per request, after which the request terminates
    ``FAILED_REPLICA`` — a structured give-up with a ``retry_after_s``
    hint, never a silent loss. An in-flight attempt that a replica
    sheds underneath the router (SIGTERM drain / ``shutdown()``) is
    re-queued through the same bounded path.

Fleet-wide backpressure: ``max_queue`` bounds the router's own queue
and ``max_queue_delay_s`` sheds at ROUTER admission when every serving
replica's estimated delay (plus the router backlog riding on top) is
over the limit — the fleet refuses early instead of queuing blindly
into replicas whose own shedding would only bounce the request around.
Every shed/deadline-class terminal the router records carries the same
machine-readable ``retry_after_s`` contract as the engine's
(``Outcome.retryable`` — one backoff surface for clients at both
levels).

Everything here is host-side scheduling over the engines' existing
data-plane contracts: the router builds no program and touches no
tensor — the fleet chaos harness (serve/chaos.py ``KillReplica`` /
``SlowReplica`` / ``FlappingReplica``) asserts exactly-one-terminal-
outcome, survivor token parity, per-step page audits on surviving
replicas, and one capture per program per replica, under every
injected failure.

One departure from the JAX router: weights. A JAX engine's
``warm_start`` rebinds its own parameter arrays, so replicas built over
one model can be upgraded one at a time. The port's ``warm_start``
writes the model's parameters in place (its CUDA graphs hold them by
address), so replicas sharing a model would all swap at once.
``build_fleet`` therefore gives every replica its own copy of the
model, and ``upgrade_replica`` refuses a replica whose parameters share
storage with another live replica's.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import time
from collections import deque
from typing import List, Optional

import numpy as np

from ..base import MXNetError
from .engine import InferenceEngine, Request
from .events import EventType, resolve_recorder, terminal_fields
from .outcomes import Outcome
from .slo import Tier, resolve_tier_policies, wants_rebalance
from .transport import PageTransport

__all__ = ["Router", "Replica", "ReplicaState", "ReplicaKilled",
           "build_fleet"]

_ROLES = ("prefill", "decode", "mixed")


class ReplicaState(enum.Enum):
    SERVING = "SERVING"
    WARMING = "WARMING"       # cold admit / post-upgrade: spill-only
    DEGRADED = "DEGRADED"
    DRAINING = "DRAINING"     # leaving or upgrading: no admissions
    DEAD = "DEAD"
    RETIRED = "RETIRED"       # drained out clean: tombstone

    def __str__(self) -> str:
        return self.value


class ReplicaKilled(MXNetError):
    """The process-death fault: a killed replica raises this from every
    subsequent step — the in-process stand-in for 'the replica's host
    stopped answering' (serve/chaos.py ``KillReplica``)."""


class Replica:
    """One engine plus the router's view of its health. The router
    never reads a DEAD replica's engine again — its in-flight requests
    are harvested from the ROUTER'S own bookkeeping (the token stream
    it already received), not from the dead engine's memory."""

    def __init__(self, idx: int, engine: InferenceEngine,
                 role: str = "mixed"):
        if role not in _ROLES:
            raise MXNetError(f"replica role must be one of {_ROLES}, "
                             f"got {role!r}")
        self.idx = idx
        self.engine = engine
        # disaggregated serving role: a 'prefill' replica runs chunked
        # prefill only — the router streams each slot to a decode/
        # mixed sibling the moment prefill publishes its pages; a
        # 'decode' replica takes no fresh admissions while any
        # prefill/mixed sibling can (its slots arrive by migration).
        # 'mixed' (default) does both — a single-role fleet behaves
        # exactly as before this field existed.
        self.role = role
        self.state = ReplicaState.SERVING
        self.killed: Optional[str] = None    # chaos kill reason
        self.delay_s = 0.0                   # chaos per-step stall
        self.consecutive_misses = 0          # heartbeat misses in a row
        self.probe_successes = 0
        self.backoff_s: Optional[float] = None
        self.next_probe_t = 0.0
        self.breaker_opens = 0
        self.probes = 0
        self.steps = 0
        self.death_detail = ""
        self.warm_steps = 0                  # healthy steps while WARMING
        self.drain_reason: Optional[str] = None   # "retire" | "upgrade"
        self.upgrade_src: Optional[dict] = None   # warm_start kwargs

    def kill(self, reason: str = "killed"):
        """Mark the replica process dead: every later ``step`` raises
        ``ReplicaKilled`` (the chaos harness's kill switch)."""
        self.killed = reason

    def _traces(self) -> int:
        # the four capture counts, as the JAX router sums its four trace
        # counts: the page programs (gather, promotion) are not among
        # them there either
        e = self.engine
        return (e.decode_trace_count + e.verify_trace_count +
                e.prefill_trace_count + e.copy_trace_count)

    def step(self):
        """One engine scheduler step. Returns ``(advanced, wall_s,
        compiled)``; raises when the replica is dead. ``compiled``
        flags a step that built (captured) a new program — expected-slow,
        so the router exempts it from the heartbeat (a cold replica
        warming its programs is not a sick replica)."""
        if self.killed is not None:
            raise ReplicaKilled(f"replica {self.idx} {self.killed}")
        t0 = time.perf_counter()
        tr0 = self._traces()
        if self.delay_s:
            time.sleep(self.delay_s)         # chaos SlowReplica stall
        n = self.engine.step()
        self.steps += 1
        return n, time.perf_counter() - t0, self._traces() > tr0


@dataclasses.dataclass(eq=False)        # identity semantics: tracked
class _Tracked:                         # entries live in lists and the
                                        # generated __eq__ would compare
                                        # the client's ndarray fields
    """The router's record of one CLIENT request: which replica is
    serving its current attempt, and how many times it has been
    re-queued. The client ``Request`` accumulates the token stream
    across attempts; each attempt is a fresh engine-level ``Request``
    (resume-from-suffix replay)."""

    client: Request
    attempt: Optional[Request] = None
    replica: Optional[int] = None
    requeues: int = 0


class Router:
    """Host-side fleet front: cache-affinity admission + bounded
    replica failover over ``engines`` (see the module docstring).

    ``affinity=False`` degrades routing to pure round-robin over
    serving replicas with capacity — the control arm of
    ``serve_bench --fleet``. ``replica_queue_depth`` caps how many
    requests the router parks in any one replica's own admission queue
    (shallow per-replica queues keep the blast radius of a death
    small and the spill estimate honest); it defaults to the replica's
    slot count."""

    def __init__(self, engines: List[InferenceEngine], *,
                 affinity: bool = True, max_requeues: int = 2,
                 heartbeat_timeout_s: float = 0.75,
                 breaker_failures: int = 3,
                 probe_backoff_s: float = 0.05,
                 probe_backoff_max_s: float = 2.0,
                 probe_recovery: int = 2,
                 replica_queue_depth: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 max_queue_delay_s: Optional[float] = None,
                 stall_steps: int = 2000, seed: int = 0,
                 tier_policies: Optional[dict] = None,
                 roles: Optional[List[str]] = None,
                 rebalance: bool = False,
                 fleet_preempt: bool = False,
                 warmup_steps: int = 2,
                 recorder=None):
        if not engines:
            raise MXNetError("a fleet needs at least one replica")
        if roles is not None and len(roles) != len(engines):
            raise MXNetError(f"roles ({len(roles)}) must match "
                             f"engines ({len(engines)})")
        if roles is not None and engines and \
                all(r == "decode" for r in roles):
            raise MXNetError("a fleet of only 'decode' replicas can "
                             "never prefill — include a 'prefill' or "
                             "'mixed' replica")
        self.replicas = [
            Replica(i, e, role=(roles[i] if roles is not None
                                else "mixed"))
            for i, e in enumerate(engines)]
        # the router's own flight recorder (serve/events.py): CLIENT
        # lifecycle + routing/failover/replica-health events. Each
        # replica keeps its OWN recorder (attempt-level events and
        # histograms must not merge into the client view); a replica
        # still carrying the default lane name is renamed replica<i>
        # so a merged export (``flight_events``) reads as a fleet.
        self.flight = resolve_recorder(recorder)
        self._component = "router"
        for rep in self.replicas:
            if getattr(rep.engine, "_component", None) == "engine":
                rep.engine._component = f"replica{rep.idx}"
        self.affinity = bool(affinity)
        self.max_requeues = int(max_requeues)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.breaker_failures = int(breaker_failures)
        self.probe_backoff_s = float(probe_backoff_s)
        self.probe_backoff_max_s = float(probe_backoff_max_s)
        self.probe_recovery = int(probe_recovery)
        self.replica_queue_depth = replica_queue_depth
        self.warmup_steps = int(warmup_steps)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.max_queue_delay_s = max_queue_delay_s
        self.stall_steps = int(stall_steps)
        self._rng = np.random.RandomState(seed)
        # jitter draws MUST NOT share the seed stream: a breaker event
        # interleaving rand() calls would shift every later request's
        # pinned seed, silently breaking survivor parity between a
        # faulted and a fault-free run of a temperature workload
        self._jitter_rng = np.random.RandomState(
            (seed + 0x9E3779B9) & 0xFFFFFFFF)   # stay in the u32 seed
                                                # domain for any seed
        self._queue: deque = deque()         # _Tracked awaiting dispatch
        self._inflight: List[_Tracked] = []
        self._rr = 0                         # round-robin cursor
        self._stall = 0
        self.steps = 0
        self.health: dict = {o.value: 0 for o in Outcome}
        self.health_by_tier: dict = {
            t.value: {o.value: 0 for o in Outcome} for t in Tier}
        # router-level tier scoping (serve/slo.py): per-tier queue
        # bound / delay limit / default deadline on the ROUTER'S
        # admission surface (each engine still applies its own)
        self._tier_policies = resolve_tier_policies(tier_policies)
        self.requeues = 0
        self.replica_deaths = 0
        self.breaker_opens = 0
        self.probes = 0
        self.recoveries = 0
        self.affinity_routed = 0
        self.tier_affinity_routed = 0    # won on the lower-tier axis
        self.spill_routed = 0
        # page transport (serve/transport.py): live slot migration
        # between replicas — role-split streaming, drain-before-
        # warm_start, brownout rebalancing, fleet-aware preemption.
        # Every failed transfer degrades to the replay fallback
        # (resume-from-suffix re-queue), loudly, WITHOUT charging the
        # request's requeue budget: a failed optimisation is the
        # router's fault, not the request's.
        self._transport = PageTransport()
        self.rebalance = bool(rebalance)
        self.migrations = 0
        self.migrations_failed = 0
        self.migrated_pages = 0
        self.migrated_bytes = 0
        # elastic membership (add_replica / remove_replica /
        # upgrade_replica) tally — serve/metrics.py renders all three
        self.scale_ups = 0
        self.scale_downs = 0
        self.upgrades = 0
        self._fleet_preempt = bool(fleet_preempt)
        if fleet_preempt:
            # fleet-aware preemption: an engine about to preempt a
            # victim offers it to the router first — a successful
            # handoff MOVES the slot to a sibling (zero redone
            # prefill) instead of bouncing it through the queue
            for rep in self.replicas:
                rep.engine.preempt_handoff = \
                    self._make_preempt_handoff(rep.idx)
        self.log: List[str] = []

    # ------------------------------------------------------------- #
    # terminal accounting (the client-facing twin of the engine's)
    # ------------------------------------------------------------- #

    def _fleet_retry_hint(self) -> float:
        """Backoff hint from the healthiest view available: the
        smallest calibrated EWMA service time across live replicas
        (read through ``health_snapshot`` like every other router
        read of engine state)."""
        ewmas = [r.engine.health_snapshot()["ewma_service_s"]
                 for r in self.replicas
                 if r.state not in (ReplicaState.DEAD,
                                    ReplicaState.RETIRED)]
        ewmas = [e for e in ewmas if e]
        return min(ewmas) if ewmas else 0.05

    def _record_terminal(self, request: Request, outcome: Outcome,
                         detail: str = "",
                         retry_after: Optional[float] = None):
        """Exactly-once terminal recording for CLIENT requests — the
        router-level twin of the engine's ``_record_terminal``, same
        double-finish refusal, same retryable-outcomes-carry-a-hint
        contract."""
        if request.outcome is not None:
            raise MXNetError(
                f"request already terminal ({request.outcome}) — "
                f"double-finish is a router bug")
        if retry_after is None and outcome.retryable:
            retry_after = self._fleet_retry_hint()
        request.outcome = outcome
        request.detail = detail
        request.retry_after_s = retry_after
        request.finish_time = time.perf_counter()
        self.health[outcome.value] += 1
        self.health_by_tier[request.tier.value][outcome.value] += 1
        # the client-level TERMINAL event + latency histograms — the
        # engine-level twin lives in InferenceEngine._record_terminal
        # (attempts), this one counts CLIENT terminals exactly once;
        # enabled gate: the O(tokens) derivation is recorder-only work
        if self.flight.enabled:
            self.flight.emit(self._component, EventType.TERMINAL,
                             request_id=request.request_id,
                             **terminal_fields(request))

    # ------------------------------------------------------------- #
    # admission
    # ------------------------------------------------------------- #

    def _alive(self) -> List[Replica]:
        return [r for r in self.replicas
                if r.state not in (ReplicaState.DEAD,
                                   ReplicaState.RETIRED)]

    def _serving(self) -> List[Replica]:
        return [r for r in self.replicas
                if r.state is ReplicaState.SERVING]

    def _routable(self) -> List[Replica]:
        """Replicas that may take NEW admissions: SERVING plus WARMING
        (a warming replica takes spill/round-robin traffic only — the
        affinity probe in ``_route`` is restricted to SERVING, so it
        earns affinity by building its PrefixIndex from spills)."""
        return [r for r in self.replicas
                if r.state in (ReplicaState.SERVING,
                               ReplicaState.WARMING)]

    def _fleet_delay_estimate(self) -> Optional[float]:
        """Estimated admission delay for a NEWLY submitted request:
        the best serving replica's own estimate, plus the router
        backlog's waves riding on top of the fleet's total slots.
        None until any replica has a calibrated EWMA."""
        serving = self._routable()
        if not serving:
            return None
        ests, ewmas, slots = [], [], 0
        for r in serving:
            snap = r.engine.health_snapshot()
            est = snap["estimated_queue_delay_s"]
            if est is None and snap["free_slots"] > 0:
                # an uncalibrated replica with free slots can take the
                # request NOW — it must pull the fleet estimate to 0,
                # not silently drop out (shedding while a replica
                # idles would refuse work the fleet can do)
                est = 0.0
            if est is not None:
                ests.append(est)
            if snap["ewma_service_s"]:
                ewmas.append(snap["ewma_service_s"])
            slots += snap["num_slots"]
        if not ests and not ewmas:
            return None
        base = min(ests) if ests else 0.0
        if self._queue and ewmas:
            base += (len(self._queue) // max(slots, 1)) * min(ewmas)
        return base

    def _shed_one_below(self, tier: Tier) -> bool:
        """Router-queue twin of the engine's drain-lowest-tier-first
        shed: remove the most recently queued _Tracked of the lowest
        tier strictly below ``tier`` and SHED its client. Returns True
        when room was made."""
        victim = None
        for t in self._queue:
            if t.client.tier.order <= tier.order:
                continue
            if victim is None or \
                    t.client.tier.order >= victim.client.tier.order:
                victim = t
        if victim is None:
            return False
        self._queue.remove(victim)
        self._record_terminal(
            victim.client, Outcome.SHED,
            f"displaced from the router queue by a {tier.value} "
            f"submission under overload")
        return True

    def submit(self, request: Request) -> bool:
        """Fleet admission. Returns True when the request was accepted
        for routing; False when it is already terminal — SHED (fleet
        saturated / router queue bound, ``retry_after_s`` set),
        FAILED_UNSERVABLE (no replica could EVER hold it), or
        FAILED_REPLICA (no live replica at all). Tier scoping matches
        the engine's: per-tier default deadline, per-tier queue bound
        and delay limit (falling back to the router globals), and the
        global queue bound drains the lowest queued tier first."""
        request.submit_time = time.perf_counter()
        self.flight.emit(self._component, EventType.SUBMIT,
                         request_id=request.request_id,
                         tier=request.tier.value,
                         queue_depth=len(self._queue))
        pol = self._tier_policies[request.tier]
        if request.deadline_s is None and \
                pol.default_deadline_s is not None:
            request.deadline_s = float(pol.default_deadline_s)
        if request.deadline_s is not None:
            request._deadline_abs = request.submit_time + request.deadline_s
        alive = self._alive()
        if not alive:
            self._record_terminal(
                request, Outcome.FAILED_REPLICA,
                "no live replica in the fleet")
            return False
        total = int(request.prompt_ids.size) + request.max_new_tokens
        if not any(r.engine.can_serve(total) for r in alive):
            self._record_terminal(
                request, Outcome.FAILED_UNSERVABLE,
                f"request needs {total} positions but no replica can "
                f"ever hold it")
            return False
        if request.sampling is not None:
            # same fail-fast the engine applies (one shared validator,
            # serve/sampling.py) — a grammar over the wrong vocab must
            # not bounce through dispatch to die there
            err = request.sampling.validate_for(
                alive[0].engine.model.vocab_size, request.eos_id)
            if err is not None:
                self._record_terminal(request,
                                      Outcome.FAILED_UNSERVABLE, err)
                return False
        # the newcomer's OWN refusals come first (tier bound, delay
        # limit): a request about to be refused anyway must not
        # displace an innocent lower-tier victim on the way out
        if pol.max_queue is not None and \
                sum(1 for t in self._queue
                    if t.client.tier is request.tier) >= pol.max_queue:
            self._record_terminal(
                request, Outcome.SHED,
                f"{request.tier.value} router queue at its tier depth "
                f"limit {pol.max_queue}")
            return False
        delay_limit = pol.max_queue_delay_s \
            if pol.max_queue_delay_s is not None else self.max_queue_delay_s
        if delay_limit is not None:
            est = self._fleet_delay_estimate()
            if est is not None and est > delay_limit:
                self._record_terminal(
                    request, Outcome.SHED,
                    f"fleet-wide estimated delay {est:.3f}s exceeds "
                    f"{delay_limit}s for tier {request.tier.value}",
                    retry_after=est)
                return False
        if self.max_queue is not None and \
                len(self._queue) >= self.max_queue and \
                not self._shed_one_below(request.tier):
            self._record_terminal(
                request, Outcome.SHED,
                f"router queue at depth limit {self.max_queue}")
            return False
        if request.seed is None:
            # pin the sampling stream NOW: a replay attempt on another
            # replica must reproduce the original's draws exactly
            # (position-keyed RNG + same seed == same continuation)
            request.seed = int(self._rng.randint(0, 2 ** 31 - 1))
        self._queue.append(_Tracked(client=request))
        return True

    # ------------------------------------------------------------- #
    # routing
    # ------------------------------------------------------------- #

    def _capacity(self, rep: Replica, snap: dict) -> bool:
        """Will this replica take an admission right now? Respects the
        router's shallow-queue policy AND the engine's own admission
        bounds (``max_queue`` / ``max_queue_delay_s``, read from the
        snapshot) — submitting into a replica that will predictably
        shed would only churn attempt objects and engine SHED
        terminals until capacity frees."""
        eng = rep.engine
        depth = self.replica_queue_depth
        if depth is None:
            depth = eng.num_slots
        if eng.max_queue is not None:
            depth = min(depth, eng.max_queue)
        if not (snap["free_slots"] > 0 or snap["queue_depth"] < depth):
            return False
        if eng.max_queue_delay_s is not None:
            est = snap["estimated_queue_delay_s"]
            if est is not None and est > eng.max_queue_delay_s:
                return False
        return True

    def _attempt_prompt(self, tracked: _Tracked) -> np.ndarray:
        """The replay prompt: original prompt + every token already
        delivered — resume-from-suffix through normal admission."""
        c = tracked.client
        if not c.token_ids:
            return c.prompt_ids
        return np.concatenate([c.prompt_ids,
                               np.asarray(c.token_ids, np.int32)])

    def _can_hold(self, rep: Replica, tracked: _Tracked) -> bool:
        """Per-replica servability — the engine's own bound
        (``can_serve``), so routing can never drift from what a
        replica's admission will accept. In a heterogeneous fleet a
        request must never be spilled onto a replica that would FAIL
        it as unservable while a bigger sibling could serve it."""
        c = tracked.client
        return rep.engine.can_serve(int(c.prompt_ids.size) +
                                    c.max_new_tokens)

    def _route(self, tracked: _Tracked, snaps) -> Optional[Replica]:
        """Pick a replica for this (re)admission: longest prefix match
        among SERVING replicas with capacity (that can hold the
        request at all); least-estimated-delay spill when nobody has
        the prefix (or affinity is off: round-robin). None when no
        serving replica has capacity. ``snaps`` is the dispatch
        pass's one-snapshot-per-replica view (re-snapshotting every
        replica for every queued request would churn dict builds in
        the host hot loop for staleness the live read tolerated
        anyway)."""
        cands = [(r, s) for r, s in snaps
                 if self._can_hold(r, tracked)
                 and self._capacity(r, s)]
        if any(r.role != "decode" for r, _ in cands):
            # role split: a 'decode' replica's slots arrive by page
            # migration, never fresh admission — unless it is the ONLY
            # replica that can take the request (correctness over
            # purity: a request must not starve to honor a role)
            cands = [(r, s) for r, s in cands if r.role != "decode"]
        if not cands:
            return None
        if self.affinity:
            prompt = self._attempt_prompt(tracked)
            # two-axis affinity: HBM-resident prefix length first,
            # then what a replica's lower cache tiers could re-admit
            # by copy (engine.tier_probe — equals prefix_probe when
            # tiers are off, so an untiered fleet routes exactly as
            # before). A replica holding the prefix only in DRAM/disk
            # still beats a cold spill: promotion is a page copy,
            # recompute is a full prefill. WARMING replicas are
            # spill-only: the probe skips them until they graduate
            # (their index is cold anyway — probing it would only add
            # host work to the dispatch hot loop).
            best, best_key = None, (0, 0)
            for r, _ in cands:
                if r.state is not ReplicaState.SERVING:
                    continue
                key = (r.engine.prefix_probe(prompt),
                       r.engine.tier_probe(prompt))
                if key > best_key:
                    best, best_key = r, key
            if best is not None:
                if best_key[0] > 0:
                    self.affinity_routed += 1
                else:
                    self.tier_affinity_routed += 1
                return best
            # spill: least estimated delay, then shortest backlog —
            # occupancy derived from the pass view's free_slots so
            # this pass's own assignments count as load (active_slots
            # is the stale pre-pass reading)
            def load(rs):
                r, s = rs
                est = s["estimated_queue_delay_s"]
                occupied = s["num_slots"] - s["free_slots"]
                return (est if est is not None else 0.0,
                        s["queue_depth"] +
                        occupied / max(1, s["num_slots"]),
                        r.idx)
            rep = min(cands, key=load)[0]
            self.spill_routed += 1
            return rep
        rep = cands[self._rr % len(cands)][0]
        self._rr += 1
        self.spill_routed += 1
        return rep

    def _remint_if_complete(self, tracked: _Tracked) -> bool:
        """Torn-engine-death completion: a replica that died AFTER
        emitting a request's final (or EOS) token but BEFORE recording
        the terminal leaves a preserved stream that already satisfies
        the request. Re-mint the success terminal the dead replica
        owed — the stream is complete, not replayable (a replay would
        feed EOS back through the prompt, or need max_new_tokens=0,
        whose validation raise would escape run()). Returns True when
        a terminal was minted. Checked on EVERY path that would
        replay or give up (dispatch AND the requeue-budget bound —
        FAILED_REPLICA on a complete stream would tell the client to
        retry work it already has)."""
        c = tracked.client
        if c.eos_id >= 0 and int(c.eos_id) in c.token_ids:
            stop = c.token_ids.index(int(c.eos_id)) + 1
            del c.token_ids[stop:]
            del c.token_times[stop:]
            del c.token_stamps[stop:]
            self._record_terminal(
                c, Outcome.EOS,
                "completed across a replica death (EOS preserved, "
                "terminal re-minted by the router)")
            return True
        if c.max_new_tokens - len(c.token_ids) <= 0:
            self._record_terminal(
                c, Outcome.MAX_TOKENS,
                "completed across a replica death (final token "
                "preserved, terminal re-minted by the router)")
            return True
        return False

    def _make_attempt(self, tracked: _Tracked) -> Optional[Request]:
        c = tracked.client
        if self._remint_if_complete(tracked):
            return None
        remaining = c.max_new_tokens - len(c.token_ids)
        deadline = None
        if c._deadline_abs is not None:
            deadline = c._deadline_abs - time.perf_counter()
            if deadline <= 0:
                self._record_terminal(
                    c, Outcome.DEADLINE_EXPIRED,
                    "deadline passed before (re)dispatch")
                return None
        att = Request(self._attempt_prompt(tracked).copy(),
                      max_new_tokens=remaining,
                      temperature=c.temperature, eos_id=c.eos_id,
                      deadline_s=deadline, seed=c.seed, tier=c.tier,
                      # the sampling menu rides every replay attempt;
                      # prompt_len marks where the TRUE prompt ends so
                      # the engine re-derives grammar state and the
                      # stop window from the generated suffix only —
                      # resumed continuations stay bit-identical under
                      # every knob (serve/sampling.py)
                      sampling=c.sampling,
                      prompt_len=(c.prompt_len if c.prompt_len
                                  is not None
                                  else int(c.prompt_ids.size)))
        return att

    def _absorb(self, tracked: _Tracked, att: Request):
        """Fold an attempt's delivered stream into the client request
        (the router already streamed these tokens — they are the part
        of the request no failure may take back)."""
        c = tracked.client
        c.token_ids.extend(att.token_ids)
        c.token_times.extend(att.token_times)
        c.token_stamps.extend(att.token_stamps)
        c.drafted_tokens += att.drafted_tokens
        c.accepted_tokens += att.accepted_tokens

    def _finish_from_attempt(self, tracked: _Tracked, att: Request):
        self._absorb(tracked, att)
        c = tracked.client
        if att.outcome is Outcome.STOP and att._stop_trim:
            # the stop-sequence match reached back into tokens an
            # EARLIER attempt emitted (the engine could only truncate
            # its own stream) — trim the remainder off the client so
            # the matched sequence never appears in the output
            trim = min(att._stop_trim, len(c.token_ids))
            if trim:
                del c.token_ids[-trim:]
                del c.token_times[-trim:]
                del c.token_stamps[-trim:]
        self._record_terminal(c, att.outcome, att.detail,
                              att.retry_after_s)

    def _requeue(self, tracked: _Tracked, detail: str,
                 cause: str = "failover", charge: bool = True):
        """The structured-failover path: bounded, exactly-once-
        terminal. Already-emitted tokens stay on the client; the next
        dispatch replays from the suffix. ``charge=False`` re-queues
        WITHOUT burning the request's requeue budget — the migration
        fallback and drain use it: those re-queues are the router's
        own doing (a failed optimisation / an operator action), and a
        request must not die FAILED_REPLICA for them."""
        if self._remint_if_complete(tracked):
            return                           # nothing left to replay
        if not charge:
            self.requeues += 1
            self.flight.emit(self._component, EventType.REQUEUE,
                             request_id=tracked.client.request_id,
                             cause=cause, requeues=tracked.requeues,
                             detail=detail[:200],
                             tokens_preserved=len(
                                 tracked.client.token_ids))
            self._queue.append(tracked)
            return
        if tracked.requeues >= self.max_requeues:
            self._record_terminal(
                tracked.client, Outcome.FAILED_REPLICA,
                f"gave up after {tracked.requeues} re-queues "
                f"(max_requeues={self.max_requeues}): {detail}")
            # FAILED_REPLICA at the requeue bound is a structured
            # give-up — dump the trailing fleet timeline naming the
            # request (the REQUEUE/REPLICA_HEALTH events name the
            # replicas that failed it) — docs/OBSERVABILITY.md
            self.flight.postmortem(
                "FAILED_REPLICA at requeue bound",
                f"request {tracked.client.request_id}",
                context={"requeues": tracked.requeues,
                         "max_requeues": self.max_requeues,
                         "detail": detail})
            return
        tracked.requeues += 1
        self.requeues += 1
        self.flight.emit(self._component, EventType.REQUEUE,
                         request_id=tracked.client.request_id,
                         cause=cause, requeues=tracked.requeues,
                         detail=detail[:200],
                         tokens_preserved=len(
                             tracked.client.token_ids))
        self.log.append(f"requeue #{tracked.requeues}: {detail} "
                        f"({len(tracked.client.token_ids)} tokens "
                        f"preserved)")
        self._queue.append(tracked)

    def _dispatch(self) -> int:
        """Route queued requests to replicas (FIFO). A queue that
        nothing can take stays queued — unless every replica is DEAD,
        in which case waiting is a lie and the queue drains to
        FAILED_REPLICA."""
        if not self._alive():
            while self._queue:
                t = self._queue.popleft()
                self._record_terminal(
                    t.client, Outcome.FAILED_REPLICA,
                    "every replica is dead")
            return 0
        dispatched = 0
        blocked: deque = deque()
        # tier-priority dispatch: LATENCY routes before STANDARD
        # before BATCH; the sort is stable, so FIFO order within a
        # tier (and every replay's queue position) is preserved
        if any(t.client.tier is not Tier.STANDARD for t in self._queue):
            self._queue = deque(sorted(
                self._queue, key=lambda t: t.client.tier.order))
        # one snapshot per replica per pass; admissions bump the local
        # view so later queue entries see the new depth. The routable
        # set (SERVING + WARMING) is resolved fresh each pass —
        # membership can change between passes (add/remove/upgrade)
        # and a stale candidate list would route into a tombstone.
        snaps = [(r, r.engine.health_snapshot())
                 for r in self._routable()]
        while self._queue:
            t = self._queue.popleft()
            c = t.client
            if c._deadline_abs is not None and \
                    time.perf_counter() > c._deadline_abs:
                self._record_terminal(
                    c, Outcome.DEADLINE_EXPIRED,
                    f"deadline ({c.deadline_s}s) passed in the router "
                    f"queue")
                continue
            rep = self._route(t, snaps)
            if rep is None:
                blocked.append(t)
                if not any(self._capacity(r, s) for r, s in snaps):
                    # fleet-wide out of capacity: nobody behind the
                    # head can route either — stop scanning
                    break
                # the head is blocked PER-REQUEST (only a replica that
                # cannot hold it, or is degraded, has room — the
                # heterogeneous-fleet case): let smaller requests
                # behind it through instead of head-of-line blocking
                # the whole fleet; the head keeps FIFO priority and
                # the stall give-up still watches it
                continue
            att = self._make_attempt(t)
            if att is None:
                continue                     # expired (or completed)
            if not rep.engine.submit(att):
                if att.outcome is Outcome.FAILED_UNSERVABLE:
                    # nothing a retry fixes — propagate
                    self._finish_from_attempt(t, att)
                    continue
                # engine-level shed: the replica's own admission bound
                # is tighter than the router's capacity view. That is
                # BACKPRESSURE, not a replica failure — it must not
                # burn the requeue budget (an instant-retry loop would
                # terminate healthy-fleet overload as FAILED_REPLICA).
                # The request goes back to the queue HEAD and this
                # dispatch pass stops; it waits for capacity like any
                # queued request, bounded by run()'s stall give-up.
                blocked.append(t)
                break
            t.attempt = att
            t.replica = rep.idx
            self._inflight.append(t)
            dispatched += 1
            self.flight.emit(self._component, EventType.DISPATCH,
                             request_id=c.request_id,
                             entity=f"replica{rep.idx}",
                             attempt_id=att.request_id,
                             replica=rep.idx, tier=c.tier.value,
                             queue_delay_s=(
                                 time.perf_counter() - c.submit_time
                                 if c.submit_time is not None
                                 else None))
            for r, s in snaps:               # keep the pass view honest:
                if r is rep:                 # the dispatch consumes a
                    if s["free_slots"] > 0:  # free slot's allowance or
                        s["free_slots"] -= 1 # a queue place — without
                    else:                    # this a replica with one
                        s["queue_depth"] += 1  # free slot would absorb
                    break                    # a whole burst in one pass
        blocked.extend(self._queue)
        self._queue = blocked
        return dispatched

    # ------------------------------------------------------------- #
    # health: heartbeat, breaker, half-open probes, death
    # ------------------------------------------------------------- #

    def _jittered(self, backoff: float) -> float:
        """Seeded jitter (+0..25%) so a fleet of breakers does not
        probe in lockstep — deterministic under the router's seed,
        from a stream SEPARATE from request-seed pinning."""
        return backoff * (1.0 + 0.25 * float(self._jitter_rng.rand()))

    def _heartbeat_miss(self, rep: Replica, detail: str):
        rep.consecutive_misses += 1
        rep.probe_successes = 0
        rep.warm_steps = 0                   # warmup wants HEALTHY runs
        now = time.perf_counter()
        if rep.state in (ReplicaState.SERVING, ReplicaState.WARMING):
            if rep.consecutive_misses >= self.breaker_failures:
                prev = rep.state
                rep.state = ReplicaState.DEGRADED
                rep.backoff_s = self.probe_backoff_s
                rep.next_probe_t = now + self._jittered(rep.backoff_s)
                rep.breaker_opens += 1
                self.breaker_opens += 1
                self.flight.emit(
                    self._component, EventType.REPLICA_HEALTH,
                    entity=f"replica{rep.idx}", replica=rep.idx,
                    from_state=prev.value,
                    to_state=ReplicaState.DEGRADED.value,
                    detail=detail[:200])
                self.log.append(f"replica {rep.idx}: breaker OPEN "
                                f"after {rep.consecutive_misses} "
                                f"misses ({detail})")
        elif rep.state is ReplicaState.DEGRADED:
            # failed half-open probe
            rep.backoff_s = min(rep.backoff_s * 2.0,
                                self.probe_backoff_max_s)
            rep.next_probe_t = now + self._jittered(rep.backoff_s)
            self.log.append(f"replica {rep.idx}: probe failed, backoff "
                            f"-> {rep.backoff_s:.3f}s")
        # DRAINING: a slow step on a replica already leaving the fleet
        # changes nothing — drain already stopped its admissions, and
        # its exit (retire / warm_start) is the fix a breaker would
        # only delay

    def _step_ok(self, rep: Replica, dt: float, compiled: bool):
        if compiled:
            # a step that traced a new program is NEUTRAL: exempt from
            # the heartbeat (compiles are expected-slow — a cold
            # replica warming up is not sick) but also NOT probe
            # evidence (a still-stalled DEGRADED replica must not
            # close its breaker on a slow-but-compiling step)
            return
        if dt > self.heartbeat_timeout_s:
            self._heartbeat_miss(
                rep, f"step took {dt:.3f}s > heartbeat "
                     f"{self.heartbeat_timeout_s}s")
            return
        rep.consecutive_misses = 0
        if rep.state is ReplicaState.WARMING:
            # warmup evidence: a healthy NON-compile step (compile
            # steps returned above — expected-slow is not warm). After
            # ``warmup_steps`` in a row the replica graduates and the
            # affinity probe starts seeing it.
            rep.warm_steps += 1
            if rep.warm_steps >= self.warmup_steps:
                rep.state = ReplicaState.SERVING
                self.flight.emit(
                    self._component, EventType.WARMUP,
                    entity=f"replica{rep.idx}", replica=rep.idx,
                    phase="done", warm_steps=rep.warm_steps)
                self.flight.emit(
                    self._component, EventType.REPLICA_HEALTH,
                    entity=f"replica{rep.idx}", replica=rep.idx,
                    from_state=ReplicaState.WARMING.value,
                    to_state=ReplicaState.SERVING.value,
                    detail="warmup complete")
                self.log.append(f"replica {rep.idx}: warmed up "
                                f"({rep.warm_steps} healthy steps)")
            return
        if rep.state is ReplicaState.DEGRADED:
            rep.probe_successes += 1
            if rep.probe_successes >= self.probe_recovery:
                rep.state = ReplicaState.SERVING
                rep.backoff_s = None
                rep.probe_successes = 0
                self.recoveries += 1
                self.flight.emit(
                    self._component, EventType.REPLICA_HEALTH,
                    entity=f"replica{rep.idx}", replica=rep.idx,
                    from_state=ReplicaState.DEGRADED.value,
                    to_state=ReplicaState.SERVING.value,
                    detail="breaker closed (recovered)")
                self.log.append(f"replica {rep.idx}: breaker CLOSED "
                                f"(recovered)")

    def _on_replica_death(self, rep: Replica, detail: str):
        """A step raised: the replica's state can no longer be
        trusted. Mark it DEAD and re-queue every in-flight request it
        held — from the ROUTER'S bookkeeping (prompt + the tokens
        already streamed), never from the dead engine's memory."""
        prev_state = rep.state
        rep.state = ReplicaState.DEAD
        rep.death_detail = detail
        self.replica_deaths += 1
        self.flight.emit(self._component, EventType.REPLICA_HEALTH,
                         entity=f"replica{rep.idx}", replica=rep.idx,
                         from_state=prev_state.value,
                         to_state=ReplicaState.DEAD.value,
                         detail=detail[:200])
        self.log.append(f"replica {rep.idx}: DEAD ({detail})")
        mine = [t for t in self._inflight if t.replica == rep.idx]
        for t in mine:
            self._inflight.remove(t)
            att, t.attempt, t.replica = t.attempt, None, None
            if att.outcome is not None and \
                    att.outcome not in (Outcome.SHED,
                                        Outcome.PREEMPTED):
                # finished on the replica's last good step, collected
                # here instead of _collect — still exactly one terminal
                self._finish_from_attempt(t, att)
                continue
            self._absorb(t, att)
            self._requeue(t, f"replica {rep.idx} died mid-flight: "
                             f"{detail}")

    # ------------------------------------------------------------- #
    # page transport: live slot migration between replicas
    # ------------------------------------------------------------- #

    def _find_tracked(self, request_id: int) -> Optional[_Tracked]:
        """In-flight lookup by CLIENT request id (the attempt id also
        matches — callers holding an engine-side id still resolve)."""
        for t in self._inflight:
            if t.client.request_id == request_id or \
                    (t.attempt is not None and
                     t.attempt.request_id == request_id):
                return t
        return None

    def migrate(self, request_id: int, dst: int) -> bool:
        """Move ``request_id``'s live slot to replica ``dst`` — pages
        by capsule, zero redone prefill, bit-identical continuation.
        Returns True when the slot now decodes on ``dst``.

        Failure is never partial: an abort BEFORE the source detaches
        (not decode-ready, no capacity probe, source death mid-
        capture) leaves the slot decoding where it was and returns
        False; a failure AFTER (crc mismatch, destination refusal or
        death mid-install) releases the source-side custody and falls
        back to the replay path — the request re-queues from its
        delivered suffix WITHOUT charging its requeue budget, and a
        ``MIGRATE_FAIL`` event records which fallback engaged."""
        tracked = self._find_tracked(request_id)
        if tracked is None or tracked.attempt is None:
            return False
        if not 0 <= dst < len(self.replicas):
            return False                 # membership-safe: a caller
                                         # holding a stale index must
                                         # get the replay fallback's
                                         # refusal, not an IndexError
        src = self.replicas[tracked.replica]
        dst_rep = self.replicas[dst]
        if dst_rep is src or \
                src.state is ReplicaState.DEAD or \
                dst_rep.state in (ReplicaState.DEAD,
                                  ReplicaState.RETIRED,
                                  ReplicaState.DRAINING) or \
                dst_rep.killed is not None:
            return False
        att = tracked.attempt
        if att.outcome is not None:
            return False                 # finished — _collect owns it
        capsule = None
        try:
            capsule = self._transport.capture(src.engine,
                                              att.request_id)
        except Exception as e:           # torn source — death path
            self.flight.emit(self._component, EventType.MIGRATE_FAIL,
                             request_id=tracked.client.request_id,
                             entity=f"replica{src.idx}",
                             src=src.idx, dst=dst, fallback="none",
                             reason=f"{type(e).__name__}: {e}"[:200])
            self.migrations_failed += 1
            return False
        if capsule is None:
            # pre-detach refusal: still prefilling, already gone, or
            # an injected source death aborted the capture — the slot
            # (if any) keeps decoding on the source; nothing to undo
            self.flight.emit(self._component, EventType.MIGRATE_FAIL,
                             request_id=tracked.client.request_id,
                             entity=f"replica{src.idx}",
                             src=src.idx, dst=dst, fallback="none",
                             reason="capture refused/aborted")
            self.migrations_failed += 1
            return False
        # the source slot is detached into custody: from here every
        # path either installs on dst or falls back to replay — and
        # either way releases the custody exactly once
        self.flight.emit(self._component, EventType.MIGRATE_OUT,
                         request_id=tracked.client.request_id,
                         entity=f"replica{src.idx}", src=src.idx,
                         dst=dst, pages=capsule.num_pages,
                         bytes=capsule.nbytes)
        self._inflight.remove(tracked)
        tracked.attempt, tracked.replica = None, None
        self._absorb(tracked, att)
        att2 = self._make_attempt(tracked)
        if att2 is None:
            # completed/expired under the transfer — _make_attempt
            # minted the terminal; the capsule is moot
            src.engine.release_capsule(att.request_id)
            return False
        ok = False
        reason = "install refused"
        try:
            ok = self._transport.install(dst_rep.engine, capsule,
                                         att2)
        except Exception as e:           # torn destination
            ok = False
            reason = f"{type(e).__name__}: {e}"[:200]
        src.engine.release_capsule(att.request_id)
        if not ok:
            if not capsule.verify():
                reason = "capsule crc chain broken"
            self.migrations_failed += 1
            self.flight.emit(self._component, EventType.MIGRATE_FAIL,
                             request_id=tracked.client.request_id,
                             entity=f"replica{dst}", src=src.idx,
                             dst=dst, fallback="replay",
                             reason=reason)
            self.log.append(f"migration {tracked.client.request_id} "
                            f"replica{src.idx}->replica{dst} failed "
                            f"({reason}): replay fallback")
            self._requeue(tracked,
                          f"migration to replica {dst} failed "
                          f"({reason}) — replaying from the suffix",
                          cause="migration-fallback", charge=False)
            return False
        tracked.attempt = att2
        tracked.replica = dst
        self._inflight.append(tracked)
        self.migrations += 1
        self.migrated_pages += capsule.num_pages
        self.migrated_bytes += capsule.nbytes
        self.flight.emit(self._component, EventType.MIGRATE_IN,
                         request_id=tracked.client.request_id,
                         entity=f"replica{dst}", src=src.idx,
                         dst=dst, pages=capsule.num_pages,
                         bytes=capsule.nbytes,
                         attempt_id=att2.request_id)
        return True

    def _migration_dst(self, tracked: _Tracked, exclude: int,
                       decode_pref: bool = True) -> Optional[int]:
        """Pick the destination replica for a migration: routable
        (SERVING, or WARMING — a migrated slot is spill-class work, so
        a warming replica is a legitimate landing zone; DRAINING never
        is: it is on its way OUT), not the source, can hold the
        request, has a free slot — 'decode' and 'mixed' roles only
        when ``decode_pref`` (a migrated slot is decode work; a
        dedicated prefill replica must not collect it back).
        Least-occupied wins, index breaks ties."""
        best, best_key = None, None
        for rep in self._routable():
            if rep.idx == exclude or rep.killed is not None:
                continue
            if decode_pref and rep.role == "prefill":
                continue
            if not self._can_hold(rep, tracked):
                continue
            snap = rep.engine.health_snapshot()
            if snap["free_slots"] <= 0:
                continue
            key = (snap["active_slots"], snap["queue_depth"], rep.idx)
            if best_key is None or key < best_key:
                best, best_key = rep.idx, key
        return best

    def _stream_prefill_roles(self):
        """Role-split streaming: every decode-ready slot on a
        'prefill' replica moves to a decode/mixed sibling NOW — the
        publication moment is the handoff point, so a prefill replica
        never spends a step decoding. A slot that cannot move yet (no
        sibling has a free slot) keeps decoding in place: the role is
        an optimisation, the stream must not stall for it."""
        for rep in self.replicas:
            if rep.role != "prefill" or \
                    rep.state is not ReplicaState.SERVING:
                continue
            for t in [t for t in self._inflight
                      if t.replica == rep.idx]:
                if t.attempt.outcome is not None:
                    continue
                if not rep.engine.decode_ready(t.attempt.request_id):
                    continue
                dst = self._migration_dst(t, exclude=rep.idx)
                if dst is not None:
                    self.migrate(t.client.request_id, dst)

    def _rebalance_brownout(self):
        """Brownout rebalancing: a replica browned out to the
        rebalance level sheds ONE decode-ready slot per fleet pass to
        the least-occupied cool sibling — pages move, tokens don't
        replay, and the hot replica's pressure signal (its own queue +
        occupancy) actually falls instead of bouncing work through
        the router queue."""
        snaps = {r.idx: r.engine.health_snapshot()
                 for r in self._routable()}
        hot = [r for r in self._serving()
               if wants_rebalance(snaps[r.idx]["brownout_level"])]
        for rep in hot:
            for t in [t for t in self._inflight
                      if t.replica == rep.idx]:
                if t.attempt.outcome is not None:
                    continue
                if not rep.engine.decode_ready(t.attempt.request_id):
                    continue
                dst = self._migration_dst(t, exclude=rep.idx)
                if dst is None or \
                        wants_rebalance(
                            snaps[dst]["brownout_level"]):
                    continue             # nowhere cooler to go
                if self.migrate(t.client.request_id, dst):
                    break                # one slot per pass per replica

    def _make_preempt_handoff(self, src_idx: int):
        """The engine->router preemption seam (``fleet_preempt``): the
        engine calls this with its victim's request id BEFORE evicting
        — True means the fleet took the slot (migrated to a sibling,
        or the replay fallback already re-queued it at the router) and
        the engine must not record a PREEMPTED terminal; False means
        the slot is untouched and engine-internal preemption proceeds
        as ever."""
        def handoff(request_id: int) -> bool:
            tracked = self._find_tracked(request_id)
            if tracked is None:
                return False
            dst = self._migration_dst(tracked, exclude=src_idx)
            if dst is None:
                return False
            if self.migrate(tracked.client.request_id, dst):
                return True
            # a post-detach failure already re-queued the request at
            # the router (replay fallback) — the slot is gone from the
            # source either way, so the engine must stand down
            return tracked not in self._inflight
        return handoff

    def drain_replica(self, idx: int) -> dict:
        """One drain pass over replica ``idx`` (the mechanism under
        ``remove_replica`` / ``upgrade_replica``, callable directly
        for a manual drain): queued attempts are withdrawn back to
        the router (they hold no pages), decode-ready slots MIGRATE
        to siblings (zero redone prefill), still-prefilling slots are
        left to finish — call again after ``step()`` until
        ``remaining`` is 0 (the DRAINING states' ``_drain_tick`` does
        exactly that). Zero lost requests, zero charged requeue
        budget. Returns ``{"migrated", "requeued", "remaining"}``."""
        rep = self.replicas[idx]
        migrated = requeued = 0
        for t in [t for t in self._inflight if t.replica == idx]:
            if t.attempt.outcome is not None:
                continue                 # _collect owns it
            if rep.engine.withdraw(t.attempt):
                self._inflight.remove(t)
                att, t.attempt, t.replica = t.attempt, None, None
                self._absorb(t, att)
                self._requeue(t, f"withdrawn in drain of replica "
                                 f"{idx}", cause="drain",
                              charge=False)
                requeued += 1
                continue
            if not rep.engine.decode_ready(t.attempt.request_id):
                continue                 # mid-prefill: next pass
            dst = self._migration_dst(t, exclude=idx)
            if dst is not None and \
                    self.migrate(t.client.request_id, dst):
                migrated += 1
        remaining = sum(1 for t in self._inflight if t.replica == idx)
        return {"migrated": migrated, "requeued": requeued,
                "remaining": remaining}

    # ------------------------------------------------------------- #
    # elastic membership: add / remove / upgrade under live traffic
    # ------------------------------------------------------------- #

    def add_replica(self, engine: InferenceEngine,
                    role: str = "mixed") -> int:
        """Admit a cold engine to the fleet. It enters WARMING —
        spill/round-robin traffic only (the circuit breaker's compile
        exemption covers its cold compiles), graduating to SERVING
        after ``warmup_steps`` consecutive healthy steps, by which
        point its PrefixIndex has started earning affinity the normal
        way. Returns the new replica's index (stable forever — the
        fleet list only ever appends; departures tombstone)."""
        if role not in _ROLES:
            raise MXNetError(f"replica role must be one of {_ROLES}, "
                             f"got {role!r}")
        if role == "decode" and not any(
                r.role != "decode" for r in self._alive()):
            raise MXNetError("cannot add a 'decode' replica to a fleet "
                             "with no live prefill/mixed replica — "
                             "nothing could ever feed it")
        idx = len(self.replicas)
        rep = Replica(idx, engine, role=role)
        rep.state = ReplicaState.WARMING
        if getattr(engine, "_component", None) == "engine":
            engine._component = f"replica{idx}"
        if self._fleet_preempt:
            engine.preempt_handoff = self._make_preempt_handoff(idx)
        self.replicas.append(rep)
        self.scale_ups += 1
        self.flight.emit(self._component, EventType.SCALE_UP,
                         entity=f"replica{idx}", replica=idx,
                         role=role, fleet_size=len(self._alive()))
        self.flight.emit(self._component, EventType.WARMUP,
                         entity=f"replica{idx}", replica=idx,
                         phase="start",
                         warmup_steps=self.warmup_steps)
        self.log.append(f"replica {idx}: joined the fleet "
                        f"(role={role}, WARMING)")
        return idx

    def _check_removable(self, idx: int, verb: str) -> Replica:
        """The shared refusal ladder for remove/upgrade: loud, typed
        errors — a membership mistake must never be a silent no-op."""
        if not 0 <= idx < len(self.replicas):
            raise MXNetError(f"{verb}: no replica {idx} "
                             f"(fleet has {len(self.replicas)})")
        rep = self.replicas[idx]
        if rep.state is ReplicaState.DRAINING:
            raise MXNetError(
                f"{verb}: replica {idx} is already DRAINING "
                f"({rep.drain_reason}) — double membership operation")
        if rep.state in (ReplicaState.DEAD, ReplicaState.RETIRED):
            raise MXNetError(f"{verb}: replica {idx} is "
                             f"{rep.state} — nothing to drain")
        return rep

    def remove_replica(self, idx: int) -> dict:
        """Retire replica ``idx``: stop admissions (DRAINING), migrate
        its decode-ready slots to siblings / withdraw its queued
        attempts back to the router (both via ``drain_replica`` —
        zero lost requests, zero charged requeue budget), and let the
        step loop retire it the pass the last slot leaves. Raises
        loudly on a double remove, a dead/retired target, or when the
        survivors could not serve at all. Returns the first drain
        pass's ``{"migrated","requeued","remaining"}``."""
        rep = self._check_removable(idx, "remove_replica")
        # DRAINING siblings are NOT survivors — they are leaving too,
        # and counting them would let sequential removes drain the
        # whole fleet to zero
        survivors = [r for r in self._alive() if r.idx != idx
                     and r.state is not ReplicaState.DRAINING]
        if not survivors:
            raise MXNetError(f"remove_replica: replica {idx} is the "
                             f"last live replica — a fleet of zero "
                             f"serves nobody")
        if all(r.role == "decode" for r in survivors):
            raise MXNetError(f"remove_replica: removing replica {idx} "
                             f"would leave a decode-only fleet that "
                             f"can never prefill")
        prev = rep.state
        rep.state = ReplicaState.DRAINING
        rep.drain_reason = "retire"
        self.flight.emit(self._component, EventType.SCALE_DOWN,
                         entity=f"replica{idx}", replica=idx,
                         phase="drain",
                         fleet_size=len(self._alive()))
        self.flight.emit(self._component, EventType.REPLICA_HEALTH,
                         entity=f"replica{idx}", replica=idx,
                         from_state=prev.value,
                         to_state=ReplicaState.DRAINING.value,
                         detail="remove_replica: draining to retire")
        self.log.append(f"replica {idx}: DRAINING (retire)")
        return self.drain_replica(idx)

    def upgrade_replica(self, idx: int, params=None, manager=None,
                        step=None) -> dict:
        """Rolling weight swap for one replica: drain it exactly like
        ``remove_replica`` (admissions stop, slots migrate or finish),
        then — on the step-loop pass its last slot leaves — swap
        weights in place via ``engine.warm_start`` (which flushes its
        PrefixIndex and cache tiers: the per-replica stagger of a
        fleet-wide prefix flush) and re-enter through WARMING. The
        weight source is stashed NOW (``params`` or ``manager``/
        ``step``), so the caller — typically the FleetSupervisor — can
        die mid-roll without wedging the swap."""
        if params is None and manager is None:
            raise MXNetError("upgrade_replica needs params= or "
                             "manager= (a weight source to swap in)")
        rep = self._check_removable(idx, "upgrade_replica")
        shared = self._shares_weights(rep)
        if shared:
            raise MXNetError(
                f"upgrade_replica: replica {idx}'s parameters share "
                f"storage with live replica(s) {shared} — warm_start "
                f"writes them in place and would swap those replicas' "
                f"weights too (build the fleet with build_fleet, which "
                f"gives every replica its own copy)")
        prev = rep.state
        rep.state = ReplicaState.DRAINING
        rep.drain_reason = "upgrade"
        rep.upgrade_src = ({"params": params} if params is not None
                           else {"manager": manager, "step": step})
        self.flight.emit(self._component, EventType.UPGRADE,
                         entity=f"replica{idx}", replica=idx,
                         phase="drain")
        self.flight.emit(self._component, EventType.REPLICA_HEALTH,
                         entity=f"replica{idx}", replica=idx,
                         from_state=prev.value,
                         to_state=ReplicaState.DRAINING.value,
                         detail="upgrade_replica: draining to swap "
                                "weights")
        self.log.append(f"replica {idx}: DRAINING (upgrade)")
        return self.drain_replica(idx)

    @staticmethod
    def _storages(rep: Replica) -> set:
        return {p.untyped_storage().data_ptr()
                for p in rep.engine.model.parameters()}

    def _shares_weights(self, rep: Replica) -> List[int]:
        """The live replicas (other than ``rep``) whose model parameters
        share storage with ``rep``'s."""
        mine = self._storages(rep)
        return [r.idx for r in self._alive()
                if r is not rep and mine & self._storages(r)]

    def _drain_tick(self):
        """One drain pass per DRAINING replica per fleet step, plus
        finalisation the pass the replica empties: retire-shutdown or
        warm_start-and-rewarm. Runs from ``step()`` — router-owned, so
        the transition completes no matter what happened to whoever
        started it."""
        for rep in self.replicas:
            if rep.state is not ReplicaState.DRAINING:
                continue
            stats = self.drain_replica(rep.idx)
            if stats["remaining"] > 0:
                continue                     # still-prefilling slots
            if rep.drain_reason == "retire":
                rep.engine.shutdown(
                    f"replica {rep.idx} retired (scale-down)")
                rep.state = ReplicaState.RETIRED
                rep.drain_reason = None
                self.scale_downs += 1
                self.flight.emit(
                    self._component, EventType.SCALE_DOWN,
                    entity=f"replica{rep.idx}", replica=rep.idx,
                    phase="retired", fleet_size=len(self._alive()))
                self.flight.emit(
                    self._component, EventType.REPLICA_HEALTH,
                    entity=f"replica{rep.idx}", replica=rep.idx,
                    from_state=ReplicaState.DRAINING.value,
                    to_state=ReplicaState.RETIRED.value,
                    detail="drained clean, engine shut down")
                self.log.append(f"replica {rep.idx}: RETIRED")
                continue
            # upgrade: swap weights in the emptied engine, re-warm.
            # A warm_start that raises (shape/dtype mismatch, a
            # checkpoint that no longer loads) is a replica the fleet
            # can no longer trust — the death path owns it and the
            # supervisor's dead-replacement machinery takes over.
            src, rep.upgrade_src, rep.drain_reason = \
                rep.upgrade_src, None, None
            try:
                rep.engine.warm_start(**src)
            except Exception as e:
                self.flight.emit(
                    self._component, EventType.UPGRADE,
                    entity=f"replica{rep.idx}", replica=rep.idx,
                    phase="failed",
                    reason=f"{type(e).__name__}: {e}"[:200])
                self._on_replica_death(
                    rep, f"upgrade warm_start failed: "
                         f"{type(e).__name__}: {e}")
                continue
            rep.state = ReplicaState.WARMING
            rep.warm_steps = 0
            self.upgrades += 1
            self.flight.emit(self._component, EventType.UPGRADE,
                             entity=f"replica{rep.idx}",
                             replica=rep.idx, phase="swapped")
            self.flight.emit(self._component,
                             EventType.REPLICA_HEALTH,
                             entity=f"replica{rep.idx}",
                             replica=rep.idx,
                             from_state=ReplicaState.DRAINING.value,
                             to_state=ReplicaState.WARMING.value,
                             detail="weights swapped (warm_start), "
                                    "re-warming")
            self.flight.emit(self._component, EventType.WARMUP,
                             entity=f"replica{rep.idx}",
                             replica=rep.idx, phase="start",
                             warmup_steps=self.warmup_steps)
            self.log.append(f"replica {rep.idx}: upgraded "
                            f"(warm_start), WARMING")

    # ------------------------------------------------------------- #
    # the scheduler
    # ------------------------------------------------------------- #

    def _collect(self):
        """Harvest finished attempts. A SHED attempt (the replica
        drained/shut down underneath us, or shed from its queue) and a
        PREEMPTED attempt (the replica's own preemption budget gave
        the slot away for good) are structured re-queues — both
        retryable capacity signals, both resume from the emitted
        suffix on the next dispatch; everything else propagates to the
        client as-is."""
        for t in [t for t in self._inflight
                  if t.attempt.outcome is not None]:
            self._inflight.remove(t)
            att, t.attempt, t.replica = t.attempt, None, None
            if att.outcome in (Outcome.SHED, Outcome.PREEMPTED):
                self._absorb(t, att)
                self._requeue(t, f"replica {att.outcome} in flight: "
                                 f"{att.detail}")
            else:
                self._finish_from_attempt(t, att)

    def step(self) -> int:
        """One fleet scheduler pass: dispatch, step every steppable
        replica (SERVING always; DEGRADED only when its half-open
        backoff has elapsed — that step IS the probe), handle
        heartbeat/breaker transitions and deaths, collect finished
        attempts. Returns the number of slots that advanced fleet-wide
        (0 = an idle/blocked pass)."""
        self.steps += 1
        self._dispatch()
        advanced = 0
        now = time.perf_counter()
        for rep in self.replicas:
            if rep.state in (ReplicaState.DEAD, ReplicaState.RETIRED):
                continue
            if rep.state is ReplicaState.DEGRADED:
                if now < rep.next_probe_t:
                    continue
                rep.probes += 1
                self.probes += 1
            try:
                n, dt, compiled = rep.step()
            except Exception as e:           # ReplicaKilled or torn
                self._on_replica_death(rep, f"{type(e).__name__}: {e}")
                continue
            advanced += n
            self._step_ok(rep, dt, compiled)
        self._collect()
        if any(r.state is ReplicaState.DRAINING for r in self.replicas):
            # the drain tick lives on the ROUTER'S step loop, not on
            # whoever called remove/upgrade_replica: a supervisor
            # killed mid-transition leaves a DRAINING replica that the
            # next fleet pass still finishes — no wedge by construction
            self._drain_tick()
        if any(r.role == "prefill" for r in self.replicas):
            # role split: hand freshly-published page sets to the
            # decode side the same pass prefill finished them
            self._stream_prefill_roles()
        if self.rebalance:
            self._rebalance_brownout()
        if self._queue:
            self._dispatch()                 # freed slots take work now
        return advanced

    def run(self, requests, arrival_times=None, poll_sleep=1e-3,
            before_step=None, after_step=None):
        """Drive ``requests`` until EVERY one is terminal — the fleet
        twin of ``InferenceEngine.run``, with the same hook surface
        (``before_step(router, i)`` / ``after_step(router, i)``: the
        fleet chaos harness's injection and audit points).

        A non-empty router queue that no live replica can absorb while
        nothing else makes progress gives up on its head, bounded,
        like the engine's own stall handling: FAILED_UNSERVABLE after
        ``stall_steps`` idle passes when the fleet is healthy but
        starved (capacity cause — matching the engine's starved-head
        outcome), FAILED_REPLICA after ``8 * stall_steps`` when
        survivors are wedged DEGRADED past recovery (replica-health
        cause; the larger budget spans several probe-backoff
        cycles)."""
        if arrival_times is None:
            for r in requests:
                self.submit(r)
            pending = []
        else:
            pending = sorted(zip(arrival_times, requests),
                             key=lambda p: p[0])
        t0 = time.perf_counter()
        it = 0
        self._stall = 0
        while pending or self._queue or self._inflight:
            now = time.perf_counter() - t0
            while pending and pending[0][0] <= now:
                self.submit(pending.pop(0)[1])
            if before_step is not None:
                before_step(self, it)
            n = self.step()
            if after_step is not None:
                after_step(self, it)
            it += 1
            if n > 0:
                self._stall = 0
                continue
            if self._queue or self._inflight:
                self._stall += 1
                limit = self._stall_limit()
                if self._stall > limit:
                    self._stall = 0
                    self._fail_starved(limit)
                else:
                    time.sleep(poll_sleep)
            elif pending:
                self._stall = 0
                time.sleep(min(poll_sleep,
                               max(0.0, pending[0][0] - now)))
        return requests

    def _stall_limit(self) -> int:
        """Idle passes before the fleet gives up on its starved head.
        A DEGRADED replica's recovery is pending (half-open probes on
        backoff), so idle passes are expected — give the breaker loop
        several full backoff cycles before concluding it is a wedge,
        but DO keep counting: a permanently-degraded fleet must still
        give up, bounded, not hang forever."""
        degraded = any(r.state is ReplicaState.DEGRADED
                       for r in self._alive())
        return self.stall_steps * (8 if degraded else 1)

    def _fail_starved(self, limit: int):
        """Bounded give-up after ``limit`` idle passes — shared by
        ``run()`` and the HTTP front end's stepper (serve/frontend.py),
        one audited outcome path for both."""
        degraded = any(r.state is ReplicaState.DEGRADED
                       for r in self._alive())
        if self._queue:
            head = self._queue.popleft()
            if degraded:
                # replica-health cause: survivors exist
                # but none recovered in time
                self._record_terminal(
                    head.client, Outcome.FAILED_REPLICA,
                    f"no replica recovered within {limit} "
                    f"idle passes (fleet degraded)")
            else:
                # capacity/starvation cause on a healthy
                # fleet — same outcome as the engine's own
                # starved-head give-up (non-retryable:
                # 'retry later' is a lie here)
                self._record_terminal(
                    head.client, Outcome.FAILED_UNSERVABLE,
                    f"router queue head starved for "
                    f"{limit} idle passes (no serving "
                    f"replica could admit it)")
        else:
            # in-flight but frozen: an attempt stuck in a
            # replica's OWN admission queue never advances
            # and (unlike slotted work, which the engine's
            # watchdog evicts) no engine-side give-up
            # covers it — the engine's starved-head path
            # lives in engine.run(), which the router
            # does not use. Withdraw one, bounded, with
            # the same cause split as the queue-head
            # give-up above.
            self._withdraw_starved(degraded, limit)

    def _withdraw_starved(self, degraded: bool, limit: int) -> bool:
        """Pull one attempt out of a live replica's admission queue
        (it holds no pages there) and fail its client — the fleet
        twin of the engine's own starved-queue-head give-up, with the
        SAME cause split as the router-queue give-up: FAILED_REPLICA
        (retryable, hinted) when survivors are wedged DEGRADED,
        FAILED_UNSERVABLE when the fleet is healthy but starved.
        Returns True when one was withdrawn; False means every
        in-flight attempt is slotted (the engines' watchdogs own
        those)."""
        for t in list(self._inflight):
            rep = self.replicas[t.replica]
            if rep.state is ReplicaState.DEAD:
                continue
            if not rep.engine.withdraw(t.attempt):
                continue                     # slotted, not queued
            self._inflight.remove(t)
            att, t.attempt, t.replica = t.attempt, None, None
            self._absorb(t, att)
            if degraded:
                self._record_terminal(
                    t.client, Outcome.FAILED_REPLICA,
                    f"attempt parked in degraded replica {rep.idx}'s "
                    f"admission queue; no recovery within {limit} "
                    f"idle fleet passes")
            else:
                self._record_terminal(
                    t.client, Outcome.FAILED_UNSERVABLE,
                    f"attempt starved in replica {rep.idx}'s "
                    f"admission queue for {limit} idle fleet passes")
            return True
        return False

    def live_tokens(self, request) -> List[int]:
        """The client-visible token stream RIGHT NOW: tokens already
        absorbed onto the client plus the in-flight attempt's
        emissions. Safe to stream before the attempt finishes — the
        partial-tokens-kept contract means a failover/preemption/shed
        can only PRESERVE these (the re-queue absorbs them), never
        take them back; the one exception, a stop-sequence match
        reaching back across an attempt boundary, is bounded by
        max_stop_len - 1 tokens, exactly the holdback the HTTP front
        end applies while stop sequences are armed
        (serve/frontend.py)."""
        for t in self._inflight:
            if t.client is request:
                return list(t.client.token_ids) + \
                    list(t.attempt.token_ids)
        return list(request.token_ids)

    def cancel(self, request, detail: str = "cancelled by client") \
            -> bool:
        """Fleet-level client cancellation: accepts the client
        ``Request`` or its ``request_id``. A QUEUED request terminates
        CANCELLED immediately; an IN-FLIGHT one is cancelled on its
        replica (engine pages reclaimed) and its client terminal is
        recorded here with the partial tokens absorbed. Returns False
        — refused — when the request is already terminal or the
        attempt finished before the cancel could land (the
        double-finish guard's contract: exactly one terminal,
        whichever transition wins)."""
        tracked = None
        for t in self._queue:
            if t.client is request or t.client.request_id == request:
                tracked = t
                break
        if tracked is not None:
            self._queue.remove(tracked)
            self._record_terminal(tracked.client, Outcome.CANCELLED,
                                  detail)
            return True
        for t in self._inflight:
            if t.client is request or t.client.request_id == request:
                tracked = t
                break
        if tracked is None:
            return False
        rep = self.replicas[tracked.replica]
        if rep.state is not ReplicaState.DEAD and rep.killed is None \
                and not rep.engine.cancel(tracked.attempt, detail):
            # the attempt is already terminal on the engine. A REAL
            # finish (EOS, failure, ...) owns the client outcome —
            # _collect will propagate it, the cancel lost the race.
            # But SHED/PREEMPTED would only be RE-QUEUED: the request
            # is still live from the client's view, so the cancel
            # must win — otherwise a disconnected client's request
            # keeps bouncing through the fleet.
            if tracked.attempt.outcome not in (Outcome.SHED,
                                               Outcome.PREEMPTED):
                return False
        # a dead/killed replica cannot execute the cancel RPC — the
        # router's own bookkeeping is authoritative, as on death
        self._inflight.remove(tracked)
        att, tracked.attempt, tracked.replica = \
            tracked.attempt, None, None
        self._absorb(tracked, att)
        self._record_terminal(tracked.client, Outcome.CANCELLED, detail)
        return True

    def shutdown(self, detail: str = "fleet shutdown"):
        """Drain the whole fleet: every live replica's engine drains
        (its in-flight attempts go SHED), and every client request —
        in flight or still queued — terminates SHED with the fleet
        retry hint. Replica health states are left as they were."""
        for rep in self._alive():
            rep.engine.shutdown(detail)
        for t in list(self._inflight):
            self._inflight.remove(t)
            att, t.attempt, t.replica = t.attempt, None, None
            if att is not None and att.outcome is not None and \
                    att.outcome not in (Outcome.SHED,
                                        Outcome.PREEMPTED):
                # finished just before the drain — honor the real
                # outcome, not the shutdown
                self._finish_from_attempt(t, att)
                continue
            if att is not None:
                self._absorb(t, att)
            self._record_terminal(t.client, Outcome.SHED, detail)
        while self._queue:
            self._record_terminal(self._queue.popleft().client,
                                  Outcome.SHED, detail)

    # ------------------------------------------------------------- #
    # observability
    # ------------------------------------------------------------- #

    def flight_events(self):
        """The merged fleet timeline: the router's own events plus
        every replica's — DEAD replicas INCLUDED. The "never read a
        dead engine again" rule protects request/page bookkeeping the
        death left untrustworthy; the flight recorder is the router
        process's own host-side log of what that replica did BEFORE it
        died, which is exactly the evidence a death postmortem exists
        to keep (its lane simply ends at the kill; the router-side
        REPLICA_HEALTH event records the death itself). Ordered by
        timestamp (then seq) — seq is only per-recorder, so the clock
        is the cross-recorder order. This is what
        ``tools/trace_export.py`` turns into one fleet-wide Perfetto
        timeline."""
        evs = list(self.flight.events())
        for rep in self.replicas:
            evs.extend(rep.engine.flight.events())
        evs.sort(key=lambda e: (e.ts, e.component, e.seq))
        return evs

    def health_snapshot(self) -> dict:
        """Consistent fleet-wide snapshot: router outcome tally +
        routing/failover counters + per-replica state (with each LIVE
        replica's own ``health_snapshot``; a DEAD replica reports only
        its state — its engine is gone)."""
        reps = []
        for r in self.replicas:
            entry = {"idx": r.idx, "state": r.state.value,
                     "role": r.role,
                     "breaker_opens": r.breaker_opens,
                     "probes": r.probes, "steps": r.steps,
                     "warm_steps": r.warm_steps,
                     "drain_reason": r.drain_reason}
            if r.state is ReplicaState.DEAD:
                entry["death_detail"] = r.death_detail
            else:
                # RETIRED included: shutdown leaves the engine
                # structurally valid and auditable — its final
                # snapshot is the retirement's evidence
                entry["engine"] = r.engine.health_snapshot()
            reps.append(entry)
        return {
            "outcomes": dict(self.health),
            "outcomes_by_tier": {t: dict(d) for t, d in
                                 self.health_by_tier.items()},
            "queue_depth": len(self._queue),
            "queue_depth_by_tier": {
                t.value: sum(1 for q in self._queue
                             if q.client.tier is t) for t in Tier},
            "inflight": len(self._inflight),
            "requeues": self.requeues,
            "replica_deaths": self.replica_deaths,
            "breaker_opens": self.breaker_opens,
            "probes": self.probes,
            "recoveries": self.recoveries,
            "affinity_routed": self.affinity_routed,
            "tier_affinity_routed": self.tier_affinity_routed,
            "spill_routed": self.spill_routed,
            # page transport: fleet-level migration tally (each
            # replica's snapshot carries its own in/out capsule
            # counters) — serve/metrics.py renders all four
            "migrations": self.migrations,
            "migrations_failed": self.migrations_failed,
            "migrated_pages": self.migrated_pages,
            "migrated_bytes": self.migrated_bytes,
            # elastic membership: live fleet size (tombstones
            # excluded) + the scale/upgrade tally
            "fleet_size": len(self._alive()),
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "upgrades": self.upgrades,
            # CLIENT-level latency histograms (the SLO percentiles a
            # dashboard should alert on — per-replica attempt
            # histograms ride each replica's own engine snapshot)
            "latency_hists": self.flight.hist_snapshot(),
            "replicas": reps,
        }


def build_fleet(model, n_replicas: int, engine_kw: Optional[dict] = None,
                roles: Optional[List[str]] = None,
                **router_kw) -> Router:
    """N homogeneous replicas behind a Router, each over its OWN copy of
    ``model``'s weights on the model's device (``warm_start`` writes a
    replica's parameters in place, so a rolling upgrade of one replica
    must not reach the others; ``model`` itself is bound to none).
    ``roles`` (one of 'prefill'|'decode'|'mixed' per replica) builds a
    disaggregated fleet; omitted, every replica is 'mixed'. The common
    test/bench constructor."""
    engine_kw = dict(engine_kw or {})
    engines = [InferenceEngine(copy.deepcopy(model), **engine_kw)
               for _ in range(n_replicas)]
    return Router(engines, roles=roles, **router_kw)
