"""The spike engine's tracer spans as the serving readers need them.

A reader gets the spans the program recorded after the profiled stretch
(``Context.spans``: complete events, each with its ``track``).  A served
window is one that the engine's device thread issued inside a
``device/dispatch`` span on the ``spike-device`` track; the warm-up and
the drain run windows on the caller's thread, outside any such span, and
do not count.  Every function returns None where the program recorded no
such span, as a program without them does.
"""
from __future__ import annotations

import bisect

DEVICE_TRACK = "spike-device"


def _complete(ctx, name: str, track: str | None = None) -> list:
    return [e for e in ctx.spans or () if e.get("ph") == "X"
            and e["name"] == name
            and (track is None or e.get("track") == track)]


def served_stage_ms(ctx, name: str):
    """Mean milliseconds of the spans ``name`` that lie inside a
    ``device/dispatch`` span on the device track: host issue time of the
    stage per served window."""
    segs = sorted((e["ts"], e["ts"] + e["dur"]) for e in _complete(
        ctx, "device/dispatch", DEVICE_TRACK))
    starts = [a for a, _ in segs]
    durs = []
    for e in _complete(ctx, name):
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0 and e["ts"] + e["dur"] <= segs[i][1]:
            durs.append(e["dur"])
    return sum(durs) / len(durs) * 1e-3 if durs else None

