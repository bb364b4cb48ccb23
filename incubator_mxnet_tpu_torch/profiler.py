"""Profiler: the port of the JAX package's
``incubator_mxnet_tpu/profiler.py`` (parity: ``python/mxnet/profiler.py``).

MXNet instruments its dependency engine around every op and dumps Chrome
trace-event JSON plus an aggregate table. Here:

  - **device timeline** -> ``torch.profiler`` with CUDA activity. With
    ``set_config(profile_all=True)`` (or a ``tensorboard_logdir``),
    ``start()`` opens a device trace on the card and ``stop()`` closes it
    and merges its kernel, copy and memset events into the dump;
    ``scope(name)`` also opens a ``record_function`` range then, so the
    device trace attributes work to the region. Without CUDA no device
    trace is taken.
  - **host-side events** -> recorded here (scoped events, ``Task`` /
    ``Frame`` / ``ProfileEvent``, ``Counter``, ``Marker``) and dumped by
    ``dump()`` as Chrome trace-event JSON with the JAX dump's keys
    (``traceEvents``, ``displayTimeUnit``; events ``name`` / ``cat`` /
    ``ph`` / ``ts`` / ``dur`` / ``pid`` / ``tid``). A merged device event
    keeps its own timestamps (the CUDA trace's clock) and ``pid``.
  - **aggregate table** -> ``dumps()``, per-name count / total / min /
    max / avg of the host events.
  - ``mfu(...)``: achieved FLOP/s over the card's dense bf16 peak
    (``utils.flops.peak_flops``) unless a peak is given.

``MXTPU_PROFILER_AUTOSTART=1`` starts it at import (parity:
``MXNET_PROFILER_AUTOSTART``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

from .base import MXNetError, getenv_bool

__all__ = ["set_config", "start", "stop", "dump", "dumps", "pause", "resume",
           "scope", "ProfileEvent", "Task", "Frame", "Domain", "Counter",
           "Marker", "mfu", "set_state", "state_string"]

_lock = threading.Lock()
_config = {
    "filename": "profile.json",
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": False,
    "profile_api": False,
    "aggregate_stats": True,
    "tensorboard_logdir": None,
}
_running = False
_paused = False
_events: List[dict] = []
_agg: Dict[str, List[float]] = defaultdict(list)
_t0 = time.perf_counter()


def set_config(**kwargs) -> None:
    """Parity: ``mx.profiler.set_config`` (`MXSetProcessProfilerConfig`).
    Unknown keys are accepted and ignored for drop-in compatibility."""
    _config.update(kwargs)


def _now_us() -> float:
    return (time.perf_counter() - _t0) * 1e6


_device_prof = None       # the torch.profiler session of a device trace


def _wants_device_trace() -> bool:
    return bool(_config.get("profile_all")
                or _config.get("tensorboard_logdir"))


def start() -> None:
    """Begin profiling (parity: ``mx.profiler.set_state('run')``); opens
    the device trace when ``profile_all`` or a ``tensorboard_logdir`` is
    configured and a CUDA device is present."""
    global _running, _device_prof
    with _lock:
        _running = True
        if _device_prof is None and _wants_device_trace() and \
                torch.cuda.is_available():
            _device_prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            _device_prof.__enter__()


def stop() -> None:
    """Parity: ``mx.profiler.set_state('stop')``; a device trace is
    closed and its device events join the dump."""
    global _running, _device_prof
    with _lock:
        _running = False
        prof, _device_prof = _device_prof, None
    if prof is None:
        return
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    events = _device_events(prof)
    with _lock:
        _events.extend(events)


def _device_events(prof) -> List[dict]:
    """The device-side events (kernels, copies, memsets) of a finished
    ``torch.profiler`` session, as trace-event dicts."""
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    keep = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in keep:
            out.append({"name": e["name"], "cat": e["cat"], "ph": "X",
                        "ts": e["ts"], "dur": e.get("dur", 0),
                        "pid": e.get("pid"), "tid": e.get("tid")})
    return out


def pause() -> None:
    global _paused
    _paused = True


def resume() -> None:
    global _paused
    _paused = False


def state_string() -> str:
    return "run" if _running else "stop"


def is_running() -> bool:
    return _running and not _paused


def _record(name: str, cat: str, t_start_us: float, dur_us: float) -> None:
    with _lock:
        _events.append({"name": name, "cat": cat, "ph": "X",
                        "ts": t_start_us, "dur": dur_us,
                        "pid": os.getpid(),
                        "tid": threading.get_ident() % 1_000_000})
        if _config["aggregate_stats"]:
            _agg[name].append(dur_us)


@contextmanager
def scope(name: str, cat: str = "operator"):
    """A scoped region: its host time is recorded while the profiler
    runs, and under a device trace a ``record_function`` range names the
    device work it launches."""
    if not is_running():
        yield
        return
    rng = torch.profiler.record_function(name) \
        if _device_prof is not None else None
    t = _now_us()
    try:
        if rng is not None:
            with rng:
                yield
        else:
            yield
    finally:
        _record(name, cat, t, _now_us() - t)


class ProfileEvent:
    """Manually started/stopped event (parity: `profiler::ProfileEvent`)."""

    def __init__(self, name: str, cat: str = "event"):
        self.name = name
        self.cat = cat
        self._t = None

    def start(self):
        self._t = _now_us()

    def stop(self):
        if self._t is not None and is_running():
            _record(self.name, self.cat, self._t, _now_us() - self._t)
        self._t = None


class Task(ProfileEvent):
    """Named task duration event (parity: `profiler.Task` — a domain-
    scoped ProfileEvent; domains are a labeling concept here)."""

    def __init__(self, domain=None, name: str = "task"):
        if isinstance(domain, str) and name == "task":
            domain, name = None, domain  # tolerate Task("name")
        super().__init__(name, cat=getattr(domain, "name", None)
                         or (domain if isinstance(domain, str)
                             else "task"))


class Frame(ProfileEvent):
    """Named frame duration event (parity: `profiler.Frame`)."""

    def __init__(self, domain=None, name: str = "frame"):
        if isinstance(domain, str) and name == "frame":
            domain, name = None, domain
        super().__init__(name, cat=getattr(domain, "name", None)
                         or (domain if isinstance(domain, str)
                             else "frame"))


class Domain:
    """Profiling category label (parity: `profiler.Domain`)."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"Domain({self.name!r})"


def set_state(state="stop", profile_process="worker"):
    """start/stop by name (parity: profiler.set_state)."""
    if state in ("run", "start"):
        start()
    elif state == "stop":
        stop()
    else:
        raise MXNetError(f"profiler.set_state: unknown state {state!r}")


class Counter:
    """Named monotonically-adjustable counter (parity: `ProfileCounter`)."""

    def __init__(self, name: str, value: int = 0):
        self.name = name
        self.value = value
        self._emit()

    def _emit(self):
        if is_running():
            with _lock:
                _events.append({"name": self.name, "ph": "C",
                                "ts": _now_us(), "pid": os.getpid(),
                                "args": {"value": self.value}})

    def increment(self, delta: int = 1):
        self.value += delta
        self._emit()

    def decrement(self, delta: int = 1):
        self.value -= delta
        self._emit()

    def set_value(self, value: int):
        self.value = value
        self._emit()


class Marker:
    """Instant event (parity: `ProfileMarker` / instant markers)."""

    def __init__(self, name: str, cat: str = "marker"):
        self.name = name
        self.cat = cat

    def mark(self, scope_: str = "process"):
        if is_running():
            with _lock:
                _events.append({"name": self.name, "cat": self.cat,
                                "ph": "i", "ts": _now_us(),
                                "s": {"process": "p", "thread": "t",
                                      "global": "g"}.get(scope_, "p"),
                                "pid": os.getpid()})


def dump(finished: bool = True, filename: Optional[str] = None) -> str:
    """Write Chrome trace-event JSON (parity: ``mx.profiler.dump`` →
    `trace.json`). Returns the path written."""
    path = filename or _config["filename"]
    with _lock:
        payload = {"traceEvents": list(_events), "displayTimeUnit": "ms"}
        if finished:
            _events.clear()
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def dumps(reset: bool = False) -> str:
    """Aggregate stats table (parity: ``mx.profiler.dumps`` /
    `MXAggregateProfileStatsPrint`)."""
    with _lock:
        rows = []
        for name, durs in sorted(_agg.items()):
            n = len(durs)
            tot = sum(durs)
            rows.append((name, n, tot / 1e3, min(durs) / 1e3,
                         max(durs) / 1e3, tot / n / 1e3))
        if reset:
            _agg.clear()
    header = (f"{'Name':<40}{'Calls':>8}{'Total(ms)':>12}{'Min(ms)':>10}"
              f"{'Max(ms)':>10}{'Avg(ms)':>10}")
    lines = [header, "-" * len(header)]
    for name, n, tot, mn, mx_, avg in rows:
        lines.append(f"{name:<40}{n:>8}{tot:>12.3f}{mn:>10.3f}"
                     f"{mx_:>10.3f}{avg:>10.3f}")
    return "\n".join(lines)


def mfu(model_flops_per_step: float, step_time_s: float,
        n_chips: int = 1, peak_flops_per_chip: Optional[float] = None) -> float:
    """Model-FLOPs utilisation: achieved FLOP/s over the peak of
    ``n_chips`` cards. ``peak_flops_per_chip`` defaults to the card's
    dense bf16 peak (``utils.flops.peak_flops``, which raises for a card
    it does not know)."""
    if peak_flops_per_chip is None:
        from .utils.flops import peak_flops
        peak_flops_per_chip = peak_flops()
    return model_flops_per_step / step_time_s / (n_chips * peak_flops_per_chip)


if getenv_bool("MXTPU_PROFILER_AUTOSTART"):
    set_config(profile_all=True)
    start()
