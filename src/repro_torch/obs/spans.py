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
  clock; it never waits on the device.  ``span(..., cpu_time=True)``
  also records ``cpu_us``, the calling thread's CPU time over the span
  (``time.thread_time_ns``), only when the tracer is enabled.
* Span ``args`` carry the absolute flush-window indices (``win0``,
  ``window``) that the flight recorder stamps its rows with, so host spans
  and device windows line up on one timeline.
* Spans may nest on one track (an inner span is recorded first, since a
  span is recorded when it ends); :meth:`Tracer.to_dict` orders each
  track's events by start, as Perfetto's track builder needs.

Two anchors put the spans on ``torch.profiler``'s clock.  The tracer reads
``time.time_ns()`` (the wall clock) beside its ``perf_counter_ns`` origin,
and the OS thread id (``threading.get_native_id()``) of every thread that
writes to a track, with its pthread id (``threading.get_ident()``);
:meth:`Tracer.to_dict` exports them under the top-level key
``"otherData"``, outside ``traceEvents``.  The profiler's Chrome trace
stamps epoch microseconds less its ``baseTimeNanoseconds``.  So a span at
``ts`` stands at ``ts + epoch_origin_ns / 1e3 - baseTimeNanoseconds / 1e3``
on the profiler's timeline: :func:`on_profiler_clock` applies that shift,
taken from the two anchors alone and never fitted.  The profiler's host
events name their thread by ``tid``: the OS thread id where the profiler
registered the thread (it ran ATen calls under the profiler, or the
profiler's experimental ``profile_all_threads`` was on), else, for CUDA
runtime calls, the low 32 bits of the pthread id read as a signed 32-bit
integer, without its sign (so torch 2.11 with CUDA 12.8 wrote them on an
H100).  :func:`on_profiler_clock` tags each span with both of its
writer's ids.

Span names are ``<component>/<stage>``, e.g. ``ingest/fill``,
``device/dispatch``, ``window/exchange``, ``drain/walk``, ``serve/decode``.
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
        self._epoch0_ns = time.time_ns()    # the wall clock at the origin
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._writers: list[int] = []       # each event's OS thread id
        self._pthreads: dict[int, int] = {}   # OS thread id -> pthread id
        self._thread = threading.local()      # the calling thread's ids
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
             cat: str = "host", cpu_time: bool = False, **args):
        """Time a block; record it as a complete span when enabled.  The
        yielded :class:`SpanHandle` is timed either way.  ``cpu_time``:
        when enabled, also record ``cpu_us``, the calling thread's CPU
        time over the block; wall time less it is the time the thread was
        runnable but not running (the GIL, preemption) or blocked in the
        kernel.  A wait that spins on the CPU, such as a device
        synchronize that spin-waits, counts as CPU time."""
        sp = SpanHandle(name, self.now_us(), dict(args))
        cpu0 = time.thread_time_ns() if cpu_time and self.enabled else None
        try:
            yield sp
        finally:
            if cpu0 is not None:
                sp.args["cpu_us"] = (time.thread_time_ns() - cpu0) / 1e3
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
        ids = getattr(self._thread, "ids", None)
        if ids is None:     # read once a thread: a system call on some hosts
            ids = self._thread.ids = (threading.get_native_id(),
                                      threading.get_ident())
        with self._lock:
            self._events.append(ev)
            self._writers.append(ids[0])
            self._pthreads.setdefault(*ids)

    def to_dict(self) -> dict:
        """The Chrome trace: ``traceEvents`` (each track's events in order
        of start) and ``otherData``: ``epoch_origin_ns`` (the wall clock
        at the tracer's origin), ``pthread_ids`` (``[OS thread id,
        pthread id]`` of each writer) and
        ``event_os_threads`` (the OS thread id that wrote each of
        ``traceEvents``, None for metadata)."""
        with self._lock:
            events = list(self._events)
            writers = list(self._writers)
            pthreads = sorted(map(list, self._pthreads.items()))
            tids = dict(self._tids)
        order = _by_track_in_time(events)
        events = [events[i] for i in order]
        writers = [writers[i] for i in order]
        meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                 "args": {"name": self.process_name}}]
        for name, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": tid, "args": {"name": name}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"epoch_origin_ns": self._epoch0_ns,
                              "pthread_ids": pthreads,
                              "event_os_threads": [None] * len(meta)
                              + writers}}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
            f.write("\n")


#: Shared disabled tracer: times spans, records nothing.
NULL = Tracer(enabled=False)


def _by_track_in_time(events: list[dict]) -> list[int]:
    """A permutation of ``events`` that orders each track's events by
    start (the outer of two nested spans first) and keeps the places the
    track's events take in the list; the identity where every track is in
    order already."""
    places: dict[int, list[int]] = {}
    for i, ev in enumerate(events):
        places.setdefault(ev["tid"], []).append(i)
    order = list(range(len(events)))
    for idx in places.values():
        for i, j in zip(idx, sorted(idx, key=lambda k: (
                events[k]["ts"], -events[k].get("dur", 0.0)))):
            order[i] = j
    return order


def on_profiler_clock(trace: dict, profiler_trace: dict) -> dict:
    """``profiler_trace`` (a ``torch.profiler`` Chrome trace, as
    ``export_chrome_trace`` writes it) with the program's events of
    ``trace`` (:meth:`Tracer.to_dict`) added on its time base: shifted by
    ``epoch_origin_ns / 1e3 - baseTimeNanoseconds / 1e3`` microseconds, in
    a process of their own (named after the tracer's), on their own
    tracks, each tagged with the ids by which the profiler may name the
    thread that wrote it: ``args["os_tid"]``, its OS thread id, and
    ``args["pthread_tid"]``, the low 32 bits of its pthread id read as a
    signed 32-bit integer, without the sign (module docstring)."""
    other = trace["otherData"]
    shift_us = (other["epoch_origin_ns"]
                - profiler_trace.get("baseTimeNanoseconds", 0)) / 1e3
    pthread_tid = {}
    for os_tid, pthread in other["pthread_ids"]:
        low = pthread & 0xFFFFFFFF
        pthread_tid[os_tid] = (1 << 32) - low if low >> 31 else low
    theirs = profiler_trace["traceEvents"]
    pid = 1 + max([e["pid"] for e in theirs
                   if isinstance(e.get("pid"), int)], default=0)
    ours = []
    for ev, writer in zip(trace["traceEvents"], other["event_os_threads"]):
        ev = dict(ev, pid=pid)
        if ev["ph"] != "M":
            ev["ts"] = ev["ts"] + shift_us
            ev["args"] = dict(ev.get("args", {}), os_tid=writer,
                              pthread_tid=pthread_tid[writer])
        ours.append(ev)
    return dict(profiler_trace, traceEvents=theirs + ours)


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
