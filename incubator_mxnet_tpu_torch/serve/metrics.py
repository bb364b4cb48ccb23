"""Prometheus-style text rendering of serving health snapshots (the port
of ``incubator_mxnet_tpu/serve/metrics.py``: the same text for the same
snapshot dict, whichever package's engine or router made it).

``render_metrics`` turns ``InferenceEngine.health_snapshot()`` or
``Router.health_snapshot()`` into the Prometheus text exposition
format (``# TYPE``-annotated lines) — the scrape surface an operator's
monitoring stack expects from a serving tier. It is a PURE renderer
over the detached snapshot dicts (never the live-mutated ``health``
state), so a scrape can never observe torn counters; serving it over
HTTP is one handler around one string.

Conventions:

  - counters end in ``_total``; everything instantaneous is a gauge;
  - per-tier outcome counters carry ``{tier=...,outcome=...}`` labels
    (only non-zero series are emitted — the label space is bounded by
    |Tier| x |Outcome| but sparse in practice);
  - a fleet snapshot nests per-replica engine gauges under a
    ``replica="<idx>"`` label plus a ``..._replica_up`` health gauge
    (1 SERVING, 0.5 DEGRADED, 0 DEAD);
  - ``None`` values (e.g. an uncalibrated EWMA) are skipped rather
    than rendered as NaN — absence is the honest representation.

Every sample line follows a matching ``# TYPE`` declaration and parses
back to the snapshot's numbers.
"""

from __future__ import annotations

from typing import List, Optional

__all__ = ["render_metrics", "render_frontend_metrics"]

_NS = "mxtpu_serve"

# snapshot key -> (metric suffix, prometheus type)
_ENGINE_GAUGES = [
    ("queue_depth", "queue_depth", "gauge"),
    ("active_slots", "active_slots", "gauge"),
    ("free_slots", "free_slots", "gauge"),
    ("num_slots", "num_slots", "gauge"),
    ("free_pages", "free_pages", "gauge"),
    ("ewma_service_s", "ewma_service_seconds", "gauge"),
    ("estimated_queue_delay_s", "estimated_queue_delay_seconds",
     "gauge"),
    ("estimated_queue_delay_priority_s",
     "estimated_queue_delay_priority_seconds", "gauge"),
    ("accept_rate", "accept_rate", "gauge"),
    ("brownout_level", "brownout_level", "gauge"),
    # KV-pool capacity (quantized serving, docs/SERVING.md): the bytes
    # the cache pins (scale metadata included) and how many live pages
    # hold quantized payload — the doubled-working-set dashboard
    ("kv_pool_bytes", "kv_pool_bytes", "gauge"),
    ("kv_quantized_pages", "kv_quantized_pages", "gauge"),
]
_ENGINE_COUNTERS = [
    ("decode_steps", "decode_steps_total"),
    ("drafted_tokens", "drafted_tokens_total"),
    ("accepted_tokens", "accepted_tokens_total"),
    ("prefix_hits", "prefix_hits_total"),
    ("prefix_lookups", "prefix_lookups_total"),
    ("stop_hits", "stop_hits_total"),
    ("constrained_requests", "constrained_requests_total"),
    ("preemptions", "preemptions_total"),
    ("brownout_escalations", "brownout_escalations_total"),
    ("brownout_deescalations", "brownout_deescalations_total"),
    # hierarchical prefix-cache tiers (docs/SERVING.md): demotion /
    # promotion traffic and the integrity-fallback counter — all zero
    # (but present) on an untiered engine
    ("tier_demotions", "kv_tier_demotions_total"),
    ("tier_disk_demotions", "kv_tier_disk_demotions_total"),
    ("tier_promotions", "kv_tier_promotions_total"),
    ("tier_hits", "kv_tier_hits_total"),
    ("tier_hit_tokens", "kv_tier_hit_tokens_total"),
    ("tier_misses", "kv_tier_misses_total"),
    ("tier_crc_fallbacks", "kv_tier_crc_fallbacks_total"),
    ("tier_disk_errors", "kv_tier_disk_errors_total"),
    ("tier_dropped", "kv_tier_dropped_total"),
    # page transport (serve/transport.py): capsule traffic through
    # THIS engine — outbound captures and inbound installs
    ("migrated_out_pages", "kv_migrated_out_pages_total"),
    ("migrated_in_pages", "kv_migrated_in_pages_total"),
    ("migrated_out_bytes", "kv_migrated_out_bytes_total"),
    ("migrated_in_bytes", "kv_migrated_in_bytes_total"),
]
_ROUTER_COUNTERS = [
    ("requeues", "requeues_total"),
    ("replica_deaths", "replica_deaths_total"),
    ("breaker_opens", "breaker_opens_total"),
    ("probes", "probes_total"),
    ("recoveries", "recoveries_total"),
    ("affinity_routed", "affinity_routed_total"),
    ("tier_affinity_routed", "tier_affinity_routed_total"),
    ("spill_routed", "spill_routed_total"),
    # page transport: fleet-level migration tally
    ("migrations", "migrations_total"),
    ("migrations_failed", "migrations_failed_total"),
    ("migrated_pages", "kv_migrated_pages_total"),
    ("migrated_bytes", "kv_migrated_bytes_total"),
    # elastic membership (add/remove/upgrade_replica)
    ("scale_ups", "scale_ups_total"),
    ("scale_downs", "scale_downs_total"),
    ("upgrades", "upgrades_total"),
]

# replica-state gauge: 1.0 fully routable, fractional while joining
# (WARMING: spill-only) or leaving (DRAINING: no admissions), 0.0 gone
_REPLICA_UP = {"SERVING": 1.0, "WARMING": 0.75, "DEGRADED": 0.5,
               "DRAINING": 0.25, "DEAD": 0.0, "RETIRED": 0.0}

# flight-recorder latency metrics (serve/events.py) -> prometheus name
_HIST_METRICS = [
    ("ttft", "ttft_seconds"),
    ("tpot", "tpot_seconds"),
    ("queue_delay", "queue_delay_seconds"),
    ("e2e", "e2e_latency_seconds"),
]


class _Writer:
    """Accumulates samples grouped under one ``# TYPE`` line per
    metric name (the format requires the declaration to precede every
    sample of that name, once). Histogram samples carry the
    Prometheus suffix convention: the ``# TYPE x histogram`` line
    declares ``x``; the samples are ``x_bucket{le=...}`` /
    ``x_sum`` / ``x_count``."""

    def __init__(self):
        self._types: dict = {}           # name -> type
        self._samples: dict = {}         # name -> [(suffix, labels, v)]

    def add(self, name: str, mtype: str, value, labels: str = ""):
        if value is None:
            return
        self._types.setdefault(name, mtype)
        self._samples.setdefault(name, []).append(("", labels,
                                                   float(value)))

    def add_histogram(self, name: str, bounds, counts, hsum, hcount,
                      labels: Optional[dict] = None):
        """One histogram series: ``counts`` is per-bucket (NOT
        cumulative) with the overflow bucket last — rendered as the
        cumulative ``_bucket`` samples the format requires, closed by
        ``le="+Inf"`` == ``_count``."""
        labels = dict(labels or {})
        self._types.setdefault(name, "histogram")
        rows = self._samples.setdefault(name, [])
        cum = 0
        for b, c in zip(bounds, counts):
            cum += c
            rows.append(("_bucket", _labels(**labels, le=repr(float(b))),
                         float(cum)))
        rows.append(("_bucket", _labels(**labels, le="+Inf"),
                     float(hcount)))
        rows.append(("_sum", _labels(**labels), float(hsum)))
        rows.append(("_count", _labels(**labels), float(hcount)))

    def render(self) -> str:
        out: List[str] = []
        for name in self._samples:
            out.append(f"# TYPE {name} {self._types[name]}")
            for suffix, labels, value in self._samples[name]:
                if value == int(value):
                    sval = str(int(value))
                else:
                    sval = repr(value)
                out.append(f"{name}{suffix}{labels} {sval}")
        return "\n".join(out) + "\n"


def _labels(**kv) -> str:
    if not kv:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in kv.items())
    return "{" + inner + "}"


def _emit_hists(w: _Writer, snap: dict, ns: str = _NS,
                extra: Optional[dict] = None):
    """Tier-labeled TTFT/TPOT/queue-delay/e2e histograms from the
    flight recorder's snapshot (``latency_hists``) — derived from the
    SAME event stream as the outcome counters, so the percentiles a
    dashboard computes from these can never disagree with the
    counters next to them (docs/OBSERVABILITY.md)."""
    hists = snap.get("latency_hists")
    if not hists:
        return
    extra = extra or {}
    bounds = hists["bounds"]
    for metric, suffix in _HIST_METRICS:
        for tier, cell in sorted(hists["metrics"].get(metric,
                                                      {}).items()):
            labels = dict(extra)
            if tier:
                labels["tier"] = tier
            w.add_histogram(f"{ns}_{suffix}", bounds, cell["counts"],
                            cell["sum"], cell["count"], labels)


def _emit_outcomes(w: _Writer, snap: dict, ns: str = _NS,
                   extra: Optional[dict] = None):
    extra = extra or {}
    name = f"{ns}_requests_total"
    for outcome, n in snap.get("outcomes", {}).items():
        if n:
            w.add(name, "counter", n,
                  _labels(outcome=outcome, **extra))
    tname = f"{ns}_tier_requests_total"
    for tier, d in snap.get("outcomes_by_tier", {}).items():
        for outcome, n in d.items():
            if n:
                w.add(tname, "counter", n,
                      _labels(tier=tier, outcome=outcome, **extra))
    qname = f"{ns}_tier_queue_depth"
    for tier, n in snap.get("queue_depth_by_tier", {}).items():
        w.add(qname, "gauge", n, _labels(tier=tier, **extra))


def _emit_engine(w: _Writer, snap: dict, ns: str = _NS,
                 extra: Optional[dict] = None):
    extra = extra or {}
    _emit_outcomes(w, snap, ns, extra)
    if "kv_dtype" in snap:
        # info-style gauge: the payload dtype and quant mode ride as
        # labels (strings cannot be sample values), value constant 1
        w.add(f"{ns}_kv_pool_info", "gauge", 1,
              _labels(dtype=snap["kv_dtype"],
                      quant=snap.get("kv_quant", "off"), **extra))
    for key, suffix, mtype in _ENGINE_GAUGES:
        if key in snap:
            w.add(f"{ns}_{suffix}", mtype, snap[key],
                  _labels(**extra))
    # per-tier resident bytes of the hierarchical prefix cache: one
    # gauge, ``tier`` label ("dram"/"disk") — bounded label space
    for tier, nbytes in sorted(snap.get("kv_tier_bytes", {}).items()):
        w.add(f"{ns}_kv_tier_bytes", "gauge", nbytes,
              _labels(tier=tier, **extra))
    for key, suffix in _ENGINE_COUNTERS:
        if key in snap:
            w.add(f"{ns}_{suffix}", "counter", snap[key],
                  _labels(**extra))
    _emit_hists(w, snap, ns, extra)


def render_frontend_metrics(stats: dict) -> str:
    """Prometheus text for the HTTP front end's own counters
    (``ServeFrontend.stats_snapshot()`` — serve/frontend.py): request
    and per-status response totals, disconnect/slow-reader cancels,
    and streamed-token count. Appended to the backend's
    ``render_metrics`` output by the ``/metrics`` handler so one
    scrape covers the client edge and the serving core."""
    w = _Writer()
    w.add(f"{_NS}_http_requests_total", "counter",
          stats.get("http_requests", 0))
    for status, n in sorted(stats.get("http_responses", {}).items()):
        w.add(f"{_NS}_http_responses_total", "counter", n,
              _labels(status=status))
    w.add(f"{_NS}_http_disconnects_total", "counter",
          stats.get("disconnects", 0))
    w.add(f"{_NS}_http_slow_reader_cancels_total", "counter",
          stats.get("slow_reader_cancels", 0))
    w.add(f"{_NS}_sse_tokens_total", "counter",
          stats.get("sse_tokens", 0))
    w.add(f"{_NS}_http_open_streams", "gauge",
          stats.get("open_streams", 0))
    return w.render()


def render_metrics(snapshot: dict) -> str:
    """Render an engine or router ``health_snapshot()`` dict as
    Prometheus text. Router snapshots (detected by their ``replicas``
    entry) emit the fleet-level outcome/routing counters (CLIENT
    requests) plus each live replica's engine metrics under the
    ``{ns}_replica_*`` namespace with a ``replica="<idx>"`` label —
    engine counters count ATTEMPTS (which legitimately exceed client
    requests under requeue), so they must not share a series name
    with the fleet-level counters a dashboard would sum."""
    w = _Writer()
    if "replicas" not in snapshot:
        _emit_engine(w, snapshot)
        return w.render()
    _emit_outcomes(w, snapshot)
    _emit_hists(w, snapshot)             # client-level SLO histograms
    w.add(f"{_NS}_queue_depth", "gauge", snapshot["queue_depth"])
    w.add(f"{_NS}_inflight", "gauge", snapshot["inflight"])
    w.add(f"{_NS}_fleet_size", "gauge",
          snapshot.get("fleet_size", len(snapshot["replicas"])))
    for key, suffix in _ROUTER_COUNTERS:
        w.add(f"{_NS}_{suffix}", "counter", snapshot[key])
    rns = f"{_NS}_replica"
    for rep in snapshot["replicas"]:
        extra = {"replica": rep["idx"]}
        w.add(f"{rns}_up", "gauge",
              _REPLICA_UP.get(rep["state"], 0.0), _labels(**extra))
        if "engine" in rep:
            _emit_engine(w, rep["engine"], rns, extra)
    return w.render()
