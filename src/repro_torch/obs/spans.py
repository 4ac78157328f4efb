"""Chrome-trace-event span tracing, loadable in Perfetto (port of
``src/repro/obs/spans.py``).

A :class:`Tracer` collects complete spans (``ph: "X"``), instant events
(``ph: "i"``) and thread-name metadata in the Chrome Trace Event JSON
format; open the written file in https://ui.perfetto.dev or
``chrome://tracing``.  Timestamps are microseconds since the tracer's
creation (``time.perf_counter_ns``, monotonic per process).

* A disabled tracer (``Tracer(enabled=False)``, or the shared :data:`NULL`)
  still times a ``span()`` body (two ``perf_counter_ns`` calls) but
  records nothing, so callers time through the span API unconditionally.
* The tracer is thread safe: the serving engine's ingest and device
  threads append concurrently under one lock.  A span only reads the host
  clock; it never waits on the device.
* Span ``args`` carry the absolute flush-window indices (``win0``,
  ``window``) that the flight recorder stamps its rows with, so host spans
  and device windows line up on one timeline.

Span names are ``<component>/<stage>``, e.g. ``ingest/fill``,
``device/dispatch``, ``drain/walk``, ``serve/decode``.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager


class SpanHandle:
    """Mutable view of one span in flight: ``args`` may be updated inside
    the ``with`` body; ``dur_us`` / ``dur_s`` are valid after it exits."""

    __slots__ = ("name", "t0_us", "dur_us", "args")

    def __init__(self, name: str, t0_us: float, args: dict):
        self.name = name
        self.t0_us = t0_us
        self.dur_us = 0.0
        self.args = args

    @property
    def dur_s(self) -> float:
        return self.dur_us * 1e-6


class Tracer:
    """Collects Chrome-trace events; one per process or run."""

    def __init__(self, enabled: bool = True,
                 process_name: str = "repro_torch"):
        self.enabled = enabled
        self.process_name = process_name
        self._t0_ns = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._tids: dict[str, int] = {}     # track name -> tid

    def now_us(self) -> float:
        """Microseconds since the tracer's creation (monotonic)."""
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    def _tid(self, track: str | None) -> int:
        name = track or threading.current_thread().name
        with self._lock:
            if name not in self._tids:
                self._tids[name] = len(self._tids)
            return self._tids[name]

    @contextmanager
    def span(self, name: str, *, track: str | None = None,
             cat: str = "host", **args):
        """Time a block; record it as a complete span when enabled.  The
        yielded :class:`SpanHandle` is timed either way."""
        sp = SpanHandle(name, self.now_us(), dict(args))
        try:
            yield sp
        finally:
            sp.dur_us = self.now_us() - sp.t0_us
            if self.enabled:
                self._append({"name": name, "ph": "X", "cat": cat,
                              "ts": sp.t0_us, "dur": sp.dur_us,
                              "pid": 0, "tid": self._tid(track),
                              "args": sp.args})

    def complete(self, name: str, t0_us: float, dur_us: float, *,
                 track: str | None = None, cat: str = "device", **args):
        """Record a span with explicit timestamps."""
        if self.enabled:
            self._append({"name": name, "ph": "X", "cat": cat,
                          "ts": float(t0_us), "dur": max(float(dur_us), 0.0),
                          "pid": 0, "tid": self._tid(track), "args": args})

    def instant(self, name: str, *, track: str | None = None,
                cat: str = "host", ts_us: float | None = None, **args):
        if self.enabled:
            self._append({"name": name, "ph": "i", "cat": cat, "s": "t",
                          "ts": self.now_us() if ts_us is None
                          else float(ts_us),
                          "pid": 0, "tid": self._tid(track), "args": args})

    def _append(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    def to_dict(self) -> dict:
        with self._lock:
            events = list(self._events)
            tids = dict(self._tids)
        meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                 "args": {"name": self.process_name}}]
        for name, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": tid, "args": {"name": name}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
            f.write("\n")


#: Shared disabled tracer: times spans, records nothing.
NULL = Tracer(enabled=False)


def validate_trace(obj: dict | list) -> list[str]:
    """Problems of a Chrome-trace JSON object (empty: valid): the
    container parses as the Trace Event format, complete spans have
    non-negative durations, and timestamps do not decrease along a track
    (what Perfetto's track builder needs)."""
    problems: list[str] = []
    events = obj.get("traceEvents") if isinstance(obj, dict) else obj
    if not isinstance(events, list) or not events:
        return ["no traceEvents list"]
    last_ts: dict[tuple, float] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev or "name" not in ev:
            problems.append(f"event {i}: missing ph/name")
            continue
        if ev["ph"] == "M":
            continue
        if "ts" not in ev:
            problems.append(f"event {i} ({ev['name']}): missing ts")
            continue
        if ev["ph"] == "X" and ev.get("dur", 0) < 0:
            problems.append(f"event {i} ({ev['name']}): negative dur")
        key = (ev.get("pid", 0), ev.get("tid", 0))
        if ev["ts"] < last_ts.get(key, float("-inf")):
            problems.append(f"event {i} ({ev['name']}): ts not monotonic "
                            f"on track {key}")
        last_ts[key] = ev["ts"]
    return problems


def thread_names(obj: dict | list) -> dict[int, str]:
    """tid -> track name from the trace's metadata events."""
    events = obj.get("traceEvents") if isinstance(obj, dict) else obj
    out: dict[int, str] = {}
    for ev in events or []:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            out[ev.get("tid", 0)] = ev.get("args", {}).get("name", "")
    return out
