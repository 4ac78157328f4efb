"""A traced stretch: ``torch.profiler`` over a few segments of the measured
window, reduced to what the per-layer readers need.

Device operations are the trace's kernels, copies and sets.  ``busy_s`` is
the length of the union of their intervals, ``window_s`` the host-clock
length of the traced stretch (which ends in a synchronize, so every
operation it started lies inside).  An idle gap is a stretch of the
timeline between device operations; it is named by the innermost host
operation (an ATen call or a CUDA runtime call) running at its midpoint.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10


class DeviceTrace:
    """One traced stretch of ``windows`` simulated or served windows."""

    def __init__(self, events: list, window_s: float, windows: int):
        self.window_s = window_s
        self.windows = windows
        self.device_ops = sorted(
            (e["ts"], e.get("dur", 0.0), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
        self.host_ops = sorted(
            (e["ts"], e.get("dur", 0.0), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS)
        self._busy = self._union()

    def _union(self) -> list:
        out = []
        for ts, dur, _ in self.device_ops:
            end = ts + dur
            if out and ts <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([ts, end])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy) * 1e-6

    def kernel(self, pattern: str) -> tuple[float, int]:
        """(seconds, launches) of the kernels whose name matches the
        regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [d for _, d, n in self.device_ops if rx.search(n)]
        return sum(hits) * 1e-6, len(hits)

    def _host_at(self, t: float, starts: list) -> str:
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(i - 500, 0) - 1, -1):
            ts, dur, name = self.host_ops[j]
            if ts + dur >= t:
                return name
        return "no host operation"

    def breakdown(self) -> dict:
        """The device operations that took most time and the idle gaps by
        what the host was doing, ``TOP`` of each, in seconds."""
        ops: dict[str, float] = {}
        for _, dur, name in self.device_ops:
            ops[name] = ops.get(name, 0.0) + dur * 1e-6
        starts = [h[0] for h in self.host_ops]
        gaps: dict[str, float] = {}
        for (_, a), (b, _) in zip(self._busy, self._busy[1:]):
            name = self._host_at((a + b) / 2, starts)
            gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def profile(fn, windows: int, device) -> tuple[object, DeviceTrace]:
    """Run ``fn()`` (which simulates or serves ``windows`` windows) under
    the profiler -> (its result, the stretch's :class:`DeviceTrace`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    sync()
    with tprofile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, DeviceTrace(events, window_s, windows)
