"""Flight recorder: structured, causally-ordered lifecycle events.

The canonical serving-side name for the recorder API. The
implementation is the port's stdlib-only top-level ``events`` module
(its own copy of the JAX package's recorder); this module re-exports it
unchanged. See that module (and docs/OBSERVABILITY.md) for the schema,
recorder semantics, postmortem format and histogram ingestion.
"""

from __future__ import annotations

from ..events import (DEFAULT_BUCKETS, LATENCY_METRICS, NULL_RECORDER,
                      SCHEMA_VERSION, Event, EventType, FlightRecorder,
                      HistogramSet, resolve_recorder, terminal_fields,
                      token_gaps, validate_event_dict,
                      validate_postmortem)

__all__ = ["EventType", "Event", "FlightRecorder", "NULL_RECORDER",
           "resolve_recorder", "token_gaps", "terminal_fields",
           "validate_event_dict", "validate_postmortem",
           "SCHEMA_VERSION", "LATENCY_METRICS", "DEFAULT_BUCKETS",
           "HistogramSet"]
