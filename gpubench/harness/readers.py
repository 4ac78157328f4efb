"""What a per-layer metric's reader gets: the traced stretch, the cell's
sizes, the program's spans, and the arithmetic they share.

Peaks are the NVIDIA H100 SXM data sheet's (dense, at the 700 W limit):
3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor cores.
"""
from __future__ import annotations

from gpubench.harness import manifest

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def program_spans(tracer) -> list:
    """The complete events (``ph`` ``"X"``) of a ``repro_torch.obs.spans``
    tracer, each with its track's name under ``track``."""
    events = tracer.to_dict()["traceEvents"]
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e["name"] == "thread_name"}
    done = [e for e in events if e.get("ph") == "X"]
    for e in done:
        e["track"] = names.get(e.get("tid"))
    return done


class Context:
    """``trace`` a ``harness.trace.DeviceTrace`` (or None), ``sizes`` the
    cell's sizes as the program runs it (the counters in
    ``gpubench/rooflines/`` work out each launch's operands from them),
    ``spans`` the program's tracer events (or None), ``root`` the checkout
    whose ``gpubench/rooflines/<kernel>.py`` names and counts each
    kernel."""

    def __init__(self, trace, sizes: dict, spans=None,
                 root=manifest.BENCH.parent):
        self.trace, self.sizes, self.spans = trace, sizes, spans
        self.root = root

    def _launches(self, kernel: str):
        """(seconds, launches) of ``kernel`` in the traced stretch."""
        return self.trace.kernel(manifest.roofline(kernel, self.root).PATTERN)

    def idle_pct(self):
        t = self.trace
        return 100.0 * (1.0 - t.busy_s / t.window_s)

    def fns_per_window(self):
        return len(self.trace.device_ops) / self.trace.windows

    def kernel_us_per_window(self, kernel: str):
        secs, n = self._launches(kernel)
        return secs * 1e6 / self.trace.windows if n else None

    def roofline_pct(self, kernel: str):
        """Least time of one launch (its bytes at the HBM rate or its
        operations at the f32 rate, whichever is longer) over the measured
        device time per launch, in percent; None without a launch."""
        secs, n = self._launches(kernel)
        if n == 0:
            return None
        n_bytes, n_ops = manifest.roofline(kernel, self.root).count(
            self.sizes)
        least = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
        return 100.0 * least / (secs / n)

    def span_total_s(self, name: str, track: str | None = None):
        """(seconds, count) of the program's complete spans ``name``."""
        hits = [e["dur"] for e in self.spans or ()
                if e.get("ph") == "X" and e["name"] == name
                and (track is None or e.get("track") == track)]
        return sum(hits) * 1e-6, len(hits)
