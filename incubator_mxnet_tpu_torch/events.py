"""Flight recorder: structured, causally-ordered lifecycle events.

The PyTorch port's own copy of the JAX package's stdlib-only recorder
(``incubator_mxnet_tpu/events.py``), kept verbatim below this paragraph
so the two packages emit the same schema: the port imports nothing of
the JAX package. ``serve.events`` re-exports everything —
serving-side code and docs address the recorder by that name.

When a chaos scenario or a production incident goes wrong, aggregate
counters (``health_snapshot()`` / ``/metrics``) can say THAT something
failed but never WHY: there is no causal record of what happened to
request X, or why replica 2 browned out at step 841. This module is
that record — the serving/training tier's black box:

  - ``EventType`` / ``Event``: a compact, timestamped schema covering
    the request lifecycle (SUBMIT → ADMIT → PREFILL_CHUNK →
    DECODE_STEP → PREEMPT/REQUEUE/DISPATCH → exactly-one TERMINAL)
    plus the control-plane transitions around it (BROWNOUT levels,
    REPLICA_HEALTH, CHECKPOINT_COMMIT, TRAIN_STEP outcomes,
    SUPERVISOR_RESTART/GIVEUP, CHAOS injections). Every event carries
    a recorder-wide monotone ``seq`` — a total causal order even when
    two events share a clock reading.
  - ``FlightRecorder``: bounded per-component ring buffers (a deque
    per component, ``capacity`` events each) behind ONE emission API —
    ``emit()``. Emission is exactly-once by construction because every
    call site funnels through an existing single-writer point (the
    ``_record_terminal`` / ``StepRecorder.record`` pattern), and the
    mxlint ``terminal-outcome`` pass statically rejects direct ring
    writes outside this class. Overhead is benched under the <=2%
    leave-on bar (BENCH_SERVE.json ``recorder_overhead``, strict-
    alternation methodology per docs/PERF_NOTES.md round 10).
  - postmortems: on a structured failure (chaos invariant breach,
    ``HALTED_POISONED``, supervisor give-up, ``FAILED_REPLICA`` at the
    requeue bound) the recorder dumps a JSON naming the faulted entity
    and its trailing events — kept in ``recorder.postmortems`` and
    written to ``postmortem_dir`` when set (docs/OBSERVABILITY.md).
  - latency histograms: TTFT / TPOT / queue-delay / end-to-end
    observations are ingested FROM the event stream itself (the ADMIT
    and TERMINAL events' derived fields), so the Prometheus histograms
    ``serve/metrics.py`` renders can never disagree with the event
    timeline they summarize.

Everything here is stdlib host-side bookkeeping: no jax, no device
work, nothing enters a compiled program.
"""

from __future__ import annotations

import bisect
import enum
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["EventType", "Event", "FlightRecorder", "NULL_RECORDER",
           "resolve_recorder", "token_gaps", "terminal_fields",
           "validate_event_dict", "validate_postmortem",
           "SCHEMA_VERSION", "LATENCY_METRICS", "DEFAULT_BUCKETS"]

SCHEMA_VERSION = 1


class EventType(enum.Enum):
    """The event vocabulary (docs/OBSERVABILITY.md has the field
    catalog per type). Request lifecycle first, control plane after."""

    SUBMIT = "SUBMIT"                   # request entered admission
    ADMIT = "ADMIT"                     # request took a slot
    PREFILL_CHUNK = "PREFILL_CHUNK"     # one prefill program ran
    DECODE_STEP = "DECODE_STEP"         # one decode/verify step ran
    PREEMPT = "PREEMPT"                 # slot reclaimed by higher tier
    REQUEUE = "REQUEUE"                 # re-queued (preempt/failover)
    DISPATCH = "DISPATCH"               # router → replica assignment
    TERMINAL = "TERMINAL"               # exactly-one final outcome
    BROWNOUT = "BROWNOUT"               # degrade-level transition
    REPLICA_HEALTH = "REPLICA_HEALTH"   # SERVING/DEGRADED/DEAD move
    CHECKPOINT_COMMIT = "CHECKPOINT_COMMIT"
    TRAIN_STEP = "TRAIN_STEP"           # one StepOutcome recorded
    SUPERVISOR_RESTART = "SUPERVISOR_RESTART"
    SUPERVISOR_GIVEUP = "SUPERVISOR_GIVEUP"
    CHAOS = "CHAOS"                     # injector fired
    CACHE_DEMOTE = "CACHE_DEMOTE"       # prefix page HBM → DRAM/disk
    CACHE_PROMOTE = "CACHE_PROMOTE"     # prefix page re-admitted by copy
    CACHE_TIER_MISS = "CACHE_TIER_MISS"  # tier consulted, no usable page
    MIGRATE_OUT = "MIGRATE_OUT"         # slot captured off a replica
    MIGRATE_IN = "MIGRATE_IN"           # capsule installed on a replica
    MIGRATE_FAIL = "MIGRATE_FAIL"       # transfer failed → replay path
    SCALE_UP = "SCALE_UP"               # replica admitted to the fleet
    SCALE_DOWN = "SCALE_DOWN"           # replica drained out / retired
    UPGRADE = "UPGRADE"                 # rolling weight-swap phase
    WARMUP = "WARMUP"                   # cold replica warming / serving

    def __str__(self) -> str:
        return self.value


class Event:
    """One recorded event. ``seq`` is the recorder-wide causal order;
    ``ts`` is ``time.perf_counter()`` seconds (a span event may pass
    its start time explicitly and carry ``dur_s`` in ``data``).
    ``entity`` names the subject when it is not a request (a replica,
    a trainer, an injector); ``data`` holds only JSON-safe scalars."""

    __slots__ = ("seq", "ts", "component", "etype", "entity",
                 "request_id", "data")

    def __init__(self, seq, ts, component, etype, entity, request_id,
                 data):
        self.seq = seq
        self.ts = ts
        self.component = component
        self.etype = etype
        self.entity = entity
        self.request_id = request_id
        self.data = data

    def to_dict(self) -> dict:
        d = {"seq": self.seq, "ts": self.ts,
             "component": self.component, "etype": self.etype.value}
        if self.entity is not None:
            d["entity"] = self.entity
        if self.request_id is not None:
            d["request_id"] = self.request_id
        if self.data:
            d["data"] = self.data
        return d

    def __repr__(self) -> str:
        return (f"Event({self.seq}, {self.etype.value}, "
                f"{self.component}, rid={self.request_id}, "
                f"{self.data})")


# --------------------------------------------------------------------- #
# latency histograms (the /metrics surface — serve/metrics.py renders)
# --------------------------------------------------------------------- #

# Prometheus-style bucket upper bounds (seconds). One shared family:
# TTFT/TPOT/queue-delay/e2e span the same ms→tens-of-seconds range.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

LATENCY_METRICS = ("ttft", "tpot", "queue_delay", "e2e")


class _Hist:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_bounds: int):
        self.counts = [0] * (n_bounds + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0


class HistogramSet:
    """Per-(metric, tier) latency histograms over one shared bucket
    family. Cells are created lazily, so the snapshot only carries
    series that actually observed something."""

    def __init__(self, bounds=DEFAULT_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        self._cells: Dict[tuple, _Hist] = {}

    def observe(self, metric: str, tier: str, value: float) -> None:
        cell = self._cells.get((metric, tier))
        if cell is None:
            cell = self._cells[(metric, tier)] = _Hist(len(self.bounds))
        cell.counts[bisect.bisect_left(self.bounds, value)] += 1
        cell.sum += value
        cell.count += 1

    def snapshot(self) -> dict:
        """Detached copy: {"bounds": [...], "metrics": {metric: {tier:
        {"counts": per-bucket (not cumulative, +Inf last), "sum",
        "count"}}}} — the shape ``render_metrics`` consumes."""
        metrics: dict = {}
        for (metric, tier), cell in self._cells.items():
            metrics.setdefault(metric, {})[tier] = {
                "counts": list(cell.counts),
                "sum": cell.sum,
                "count": cell.count,
            }
        return {"bounds": list(self.bounds), "metrics": metrics}


# --------------------------------------------------------------------- #
# the recorder
# --------------------------------------------------------------------- #

class FlightRecorder:
    """Bounded per-component event rings + postmortem dumps + latency
    histograms, behind the one ``emit()`` API.

    ``capacity`` bounds EACH component's ring (oldest events fall off —
    a flight recorder keeps the trailing window, not the whole flight).
    ``postmortem_dir`` (optional) makes ``postmortem()`` also write a
    JSON file; in-memory dumps are always kept in ``postmortems``
    (bounded). ``histograms=False`` skips latency ingestion (training/
    checkpoint recorders have no request latencies to observe)."""

    def __init__(self, capacity: int = 4096,
                 postmortem_dir: Optional[str] = None,
                 histograms: bool = True, max_postmortems: int = 8):
        self.capacity = int(capacity)
        self.postmortem_dir = postmortem_dir
        self._rings: Dict[str, deque] = {}
        self._seq = itertools.count(1)
        self.hist = HistogramSet() if histograms else None
        self.postmortems: deque = deque(maxlen=int(max_postmortems))
        self.dropped_postmortems = 0
        self.emitted = 0                 # lifetime emissions (rings wrap)
        # a recorder may be SHARED across threads (the checkpoint
        # writer thread emits commits onto the trainer's timeline), so
        # emission and the reads that iterate the rings serialize on
        # one lock. RLock, not Lock: the SIGTERM preemption drain runs
        # a final save — and therefore an emit — ON the main thread,
        # possibly interrupting a main-thread emit already holding the
        # lock (the CheckpointManager RLock precedent). Cost is one
        # uncontended acquire per emit, inside the <=2% bar
        # (BENCH_SERVE.json recorder_overhead re-banked with it).
        self._lock = threading.RLock()

    @property
    def enabled(self) -> bool:
        return True

    # -- emission ------------------------------------------------------ #
    def emit(self, component: str, etype: EventType,
             entity: Optional[str] = None,
             request_id: Optional[int] = None,
             ts: Optional[float] = None, **data) -> Event:
        """Record one event. THE single write path into the rings (the
        mxlint ``terminal-outcome`` pass rejects direct ``_rings``
        access outside this class). Latency ingestion rides specific
        event fields so histograms and the timeline can never
        disagree:

          ADMIT     ``queue_delay_s`` → the queue-delay histogram
          TERMINAL  ``ttft_s`` / ``e2e_s`` → their histograms, and
                    ``tpot_gaps`` (a list — observed then REPLACED by
                    its count ``tpot_n`` so the stored event stays
                    compact) → the TPOT histogram
        """
        if ts is None:
            ts = time.perf_counter()
        with self._lock:
            return self._emit_locked(component, etype, entity,
                                     request_id, ts, data)

    def _emit_locked(self, component, etype, entity, request_id, ts,
                     data) -> Event:
        if self.hist is not None:
            tier = data.get("tier", "")
            if etype is EventType.TERMINAL:
                gaps = data.pop("tpot_gaps", None)
                if gaps:
                    for g in gaps:
                        self.hist.observe("tpot", tier, g)
                    data["tpot_n"] = len(gaps)
                if data.get("ttft_s") is not None:
                    self.hist.observe("ttft", tier, data["ttft_s"])
                if data.get("e2e_s") is not None:
                    self.hist.observe("e2e", tier, data["e2e_s"])
            elif etype in (EventType.ADMIT, EventType.DISPATCH) and \
                    data.get("queue_delay_s") is not None:
                # ADMIT = engine slot admission; DISPATCH = the
                # router's client-level admission analog — each
                # observes once per (re)admission/(re)dispatch
                self.hist.observe("queue_delay", tier,
                                  data["queue_delay_s"])
        seq = next(self._seq)
        ev = Event(seq, ts, component, etype, entity, request_id, data)
        ring = self._rings.get(component)
        if ring is None:
            ring = self._rings[component] = deque(maxlen=self.capacity)
        ring.append(ev)
        self.emitted = seq               # == emission count (seq draws
        return ev                        # happen under the lock)

    # -- reads --------------------------------------------------------- #
    def components(self) -> List[str]:
        return sorted(self._rings)

    def events(self, component: Optional[str] = None,
               etype: Optional[EventType] = None) -> List[Event]:
        """Detached, seq-ordered view (one component, or all merged).
        Taken under the recorder lock — a concurrent emit can neither
        tear the iteration nor interleave a ring out of seq order."""
        with self._lock:
            if component is not None:
                evs = sorted(self._rings.get(component, ()),
                             key=lambda e: e.seq)
            else:
                evs = [e for ring in self._rings.values()
                       for e in ring]
                evs.sort(key=lambda e: e.seq)
        if etype is not None:
            evs = [e for e in evs if e.etype is etype]
        return evs

    def hist_snapshot(self) -> Optional[dict]:
        if self.hist is None:
            return None
        with self._lock:
            return self.hist.snapshot()

    def dump_events(self, path: str) -> str:
        """Write the merged event timeline as JSON — the input format
        ``tools/trace_export.py`` converts to a Perfetto trace."""
        payload = {"schema_version": SCHEMA_VERSION,
                   "events": [e.to_dict() for e in self.events()]}
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
        return path

    # -- postmortems --------------------------------------------------- #
    def postmortem(self, reason: str, entity: str,
                   context: Optional[dict] = None,
                   tail: int = 256) -> dict:
        """Dump the trailing timeline around a structured failure —
        the dict every consumer validates with ``validate_postmortem``.
        Always kept in-memory (bounded: the OLDEST dumps survive — the
        first failure is the root cause, later ones are usually its
        echo); written to ``postmortem_dir`` when configured."""
        evs = self.events()[-int(tail):]
        pm = {"schema_version": SCHEMA_VERSION,
              "reason": str(reason),
              "entity": str(entity),
              "ts": time.perf_counter(),
              "context": dict(context or {}),
              "events": [e.to_dict() for e in evs]}
        with self._lock:                 # RLock: events() above nests
            if len(self.postmortems) == self.postmortems.maxlen:
                self.dropped_postmortems += 1
            else:
                self.postmortems.append(pm)
        if self.postmortem_dir:
            os.makedirs(self.postmortem_dir, exist_ok=True)
            safe = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in entity)[:64]
            path = os.path.join(
                self.postmortem_dir,
                f"postmortem_{safe}_{self.emitted}.json")
            with open(path, "w") as f:
                json.dump(pm, f, indent=1)
                f.write("\n")
            pm["path"] = path
        return pm


class _NullFlightRecorder:
    """The disabled recorder: every API is a no-op with the same
    shape, so call sites stay branch-free (``recorder=False``)."""

    hist = None
    postmortems: deque = deque()
    capacity = 0
    emitted = 0
    dropped_postmortems = 0

    @property
    def enabled(self) -> bool:
        return False

    def emit(self, component, etype, entity=None, request_id=None,
             ts=None, **data):
        return None

    def components(self):
        return []

    def events(self, component=None, etype=None):
        return []

    def hist_snapshot(self):
        return None

    def dump_events(self, path):
        raise ValueError("flight recorder is disabled (recorder=False)")

    def postmortem(self, reason, entity, context=None, tail=256):
        return None


NULL_RECORDER = _NullFlightRecorder()


def resolve_recorder(recorder, **defaults):
    """The one constructor-knob convention: ``None`` → a fresh
    ``FlightRecorder`` (the leave-on default), ``False`` → the shared
    no-op recorder, an existing recorder → itself."""
    if recorder is None:
        return FlightRecorder(**defaults)
    if recorder is False:
        return NULL_RECORDER
    return recorder


# --------------------------------------------------------------------- #
# derivations shared by every emitter (and tools/serve_bench.py)
# --------------------------------------------------------------------- #

def token_gaps(stamps) -> List[float]:
    """Inter-token gaps from a request's absolute per-token stamps
    (``Request.token_stamps`` — universal since round 9): the latency a
    USER sees between consecutive tokens, including stalls caused by
    other slots' prefills. The ONE implementation behind the TPOT
    histograms and the bench's inter-token percentiles."""
    return [b - a for a, b in zip(stamps, stamps[1:])]


def terminal_fields(request) -> dict:
    """The TERMINAL event's derived latency fields for one finished
    request — computed in ONE place so the engine's and router's
    ``_record_terminal`` (and therefore the histograms) can never
    drift: end-to-end latency, time-to-first-token, and the TPOT gap
    list (ingested by the recorder, stored as a count)."""
    data = {"outcome": request.outcome.value,
            "tier": request.tier.value,
            "tokens": len(request.token_ids)}
    if request.detail:
        data["detail"] = request.detail[:200]
    if request.retry_after_s is not None:
        data["retry_after_s"] = request.retry_after_s
    st = request.token_stamps
    if request.submit_time is not None and \
            request.finish_time is not None:
        data["e2e_s"] = request.finish_time - request.submit_time
        if st:
            data["ttft_s"] = st[0] - request.submit_time
    gaps = token_gaps(st)
    if gaps:
        data["tpot_gaps"] = gaps
    return data


# --------------------------------------------------------------------- #
# schema validation (tests + the obssmoke CI gate)
# --------------------------------------------------------------------- #

_EVENT_TYPES = {e.value for e in EventType}


def validate_event_dict(d: dict) -> None:
    """Raise ValueError unless ``d`` is a well-formed serialized event
    (the ``Event.to_dict`` shape, JSON-safe)."""
    if not isinstance(d, dict):
        raise ValueError(f"event must be a dict, got {type(d)}")
    for key, typ in (("seq", int), ("ts", (int, float)),
                     ("component", str), ("etype", str)):
        if key not in d:
            raise ValueError(f"event missing required field {key!r}: "
                             f"{d}")
        if not isinstance(d[key], typ):
            raise ValueError(f"event field {key!r} has wrong type: "
                             f"{d[key]!r}")
    if d["etype"] not in _EVENT_TYPES:
        raise ValueError(f"unknown event type {d['etype']!r}")
    if "data" in d:
        try:
            json.dumps(d["data"])
        except (TypeError, ValueError) as e:
            raise ValueError(f"event data is not JSON-safe: {e}")


def validate_postmortem(pm: dict) -> None:
    """Raise ValueError unless ``pm`` is a well-formed postmortem dump:
    reason + entity + a causally-ordered (seq strictly increasing)
    event timeline of valid events."""
    if not isinstance(pm, dict):
        raise ValueError(f"postmortem must be a dict, got {type(pm)}")
    for key in ("schema_version", "reason", "entity", "events"):
        if key not in pm:
            raise ValueError(f"postmortem missing field {key!r}")
    if pm["schema_version"] != SCHEMA_VERSION:
        raise ValueError(f"postmortem schema_version "
                         f"{pm['schema_version']} != {SCHEMA_VERSION}")
    if not isinstance(pm["events"], list):
        raise ValueError("postmortem events must be a list")
    prev = 0
    for ev in pm["events"]:
        validate_event_dict(ev)
        if ev["seq"] <= prev:
            raise ValueError(
                f"postmortem events out of causal order: seq "
                f"{ev['seq']} after {prev}")
        prev = ev["seq"]
