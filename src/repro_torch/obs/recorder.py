"""Device-side flight recorder: a fixed-depth per-window telemetry ring
(port of ``src/repro/obs/recorder.py``).

End-of-run ``LinkStats`` totals say how much congestion a run saw; the
ring says when and where it formed.  Each flush window it keeps

* the absolute window index,
* the window's deltas of the conservation counters (:data:`COUNTER_FIELDS`),
* the end-of-window credit occupancy (``FabricState.bank.credits``) and
  credit holds (``parked_by_link``), the two sides of the per-link
  identity ``credits + pending + parked_by_link == limit``,
* the deferred events per physical egress link
  (``LinkStats.stalled_by_link``, kernel F's stall lane, present when the
  transport is built with ``stall_attribution=True``; zeros otherwise, so
  the ring's layout never varies),
* the window's latency-histogram delta.

Differences from the reference, all of form:

* The ring lives on the device and :func:`record` writes one slot per lane
  in place, at ``cursor % depth``; ``cursor`` is a Python int, because
  the port's window loop runs on the host.  Nothing goes to the host
  until :func:`ring_rows` (or :func:`global_rows`).
* The shard axis is a tensor dimension: a ring built with ``n_shards``
  keeps it leading on the per-shard counter and histogram lanes; the
  descriptor lanes (``credits``, ``parked_by_link``, ``stalled_by_link``),
  which the reference replicates on every shard, are held once.
  :func:`ring_shard` gives one shard's view, the reference's per-shard
  ring.

The recorder is off by default; a simulator or engine built without it
runs exactly the program it ran before the recorder existed.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

#: LinkStats fields recorded per window: () per shard in single-tenant
#: stats, (T,) in the tenant transport's stats.
COUNTER_FIELDS = (
    "offered_events",
    "sent_events",
    "deferred_events",
    "delivered_events",
    "credit_stalls",
    "parked_events",
    "unparked_events",
    "in_fabric_events",
    "rerouted",
)


class RecorderConfig(NamedTuple):
    """``depth`` is the ring's window capacity: a run longer than
    ``depth`` windows keeps the most recent ``depth``."""

    depth: int = 64


class TelemetryRing(NamedTuple):
    """The ring.  ``cursor`` counts the records ever written; the write
    slot is ``cursor % depth``.  ``window`` starts at -1 (a slot never
    written).  Lane shapes (depth D, B = (S,) with ``n_shards`` else (),
    C the counter shape () or (T,), K' the bank's slots, K the physical
    links, H the histogram shape), all int32 on the device:

    * ``window``          (D,)
    * ``counters``        (*B, D, 9, *C)
    * ``credits``         (D, K')
    * ``parked_by_link``  (D, K')
    * ``stalled_by_link`` (D, K)
    * ``hist``            (*B, D, *H)
    """

    cursor: int
    window: torch.Tensor
    counters: torch.Tensor
    credits: torch.Tensor
    parked_by_link: torch.Tensor
    stalled_by_link: torch.Tensor
    hist: torch.Tensor
    n_shards: int | None = None

    @property
    def depth(self) -> int:
        return self.window.shape[-1]


def ring_init(depth: int, state, counter_shape: Sequence[int],
              hist_shape: Sequence[int], n_links: int, *,
              n_shards: int | None = None) -> TelemetryRing:
    """Empty ring on the device of ``state`` (a ``FabricState``).

    ``counter_shape`` is one COUNTER_FIELDS entry's shape per shard (``()``
    single-tenant, ``(T,)`` multi-tenant), ``hist_shape`` the latency
    histogram's per shard, ``n_links`` the physical link count K;
    ``n_shards`` adds the leading shard axis to the per-shard lanes.
    """
    depth = int(depth)
    if depth < 1:
        raise ValueError(f"ring depth must be >= 1, got {depth}")
    credits = state.bank.credits
    lead = () if n_shards is None else (int(n_shards),)
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                   device=credits.device)
    return TelemetryRing(
        cursor=0,
        window=torch.full((depth,), -1, dtype=torch.int32,
                          device=credits.device),
        counters=z(*lead, depth, len(COUNTER_FIELDS), *counter_shape),
        credits=z(depth, *credits.shape),
        parked_by_link=z(depth, *credits.shape),
        stalled_by_link=z(depth, int(n_links)),
        hist=z(*lead, depth, *hist_shape),
        n_shards=None if n_shards is None else int(n_shards))


def ring_clone(ring: TelemetryRing) -> TelemetryRing:
    """A copy whose lanes the caller may write without touching
    ``ring``'s."""
    return ring._replace(**{f: getattr(ring, f).clone() for f in (
        "window", "counters", "credits", "parked_by_link",
        "stalled_by_link", "hist")})


def record(ring: TelemetryRing, win, link_stats, state,
           hist) -> TelemetryRing:
    """Write one window's record at ``cursor % depth``, in place, and
    return the ring with the cursor advanced.

    ``link_stats`` is the window's ``LinkStats`` (per shard, the shard
    axis leading when the ring has one), ``state`` the end-of-window
    ``FabricState``, ``hist`` the window's latency-histogram delta.
    """
    slot = ring.cursor % ring.depth
    lead = 0 if ring.n_shards is None else 1
    counters = torch.stack([getattr(link_stats, f).to(torch.int32)
                            for f in COUNTER_FIELDS], dim=lead)
    ring.window[slot] = win
    if lead:
        ring.counters[:, slot] = counters
        ring.hist[:, slot] = hist
    else:
        ring.counters[slot] = counters
        ring.hist[slot] = hist
    ring.credits[slot] = state.bank.credits
    ring.parked_by_link[slot] = state.parked_by_link
    sbl = getattr(link_stats, "stalled_by_link", None)
    if sbl is None:
        ring.stalled_by_link[slot] = 0
    else:           # the per-shard copies of one global table
        ring.stalled_by_link[slot] = sbl[0] if sbl.dim() == 2 else sbl
    return ring._replace(cursor=ring.cursor + 1)


def ring_shard(ring: TelemetryRing, s: int = 0) -> TelemetryRing:
    """Shard ``s``'s view of a ring with a shard axis: its counter and
    histogram lanes, and the descriptor lanes every shard shares."""
    if ring.n_shards is None:
        raise ValueError("ring has no shard axis (built without n_shards)")
    return ring._replace(counters=ring.counters[s], hist=ring.hist[s],
                         n_shards=None)


def _host(ring: TelemetryRing) -> TelemetryRing:
    """The ring's lanes as numpy arrays (the one device-to-host copy)."""
    return ring._replace(**{f: getattr(ring, f).detach().cpu().numpy()
                            for f in ("window", "counters", "credits",
                                      "parked_by_link", "stalled_by_link",
                                      "hist")})


def _rows(ring: TelemetryRing) -> list[dict]:
    cursor, depth = ring.cursor, ring.depth
    n = min(cursor, depth)
    overwritten = cursor - n
    counters = ring.counters
    if cursor <= depth:
        order = list(range(n))
    else:
        start = cursor % depth
        order = [(start + i) % depth for i in range(depth)]
    rows = []
    for slot in order:
        rows.append({
            "window": int(ring.window[slot]),
            "counters": {
                f: (int(counters[slot, i]) if counters.ndim == 2
                    else counters[slot, i].astype(int).tolist())
                for i, f in enumerate(COUNTER_FIELDS)},
            "credits": ring.credits[slot].astype(int).tolist(),
            "parked_by_link": ring.parked_by_link[slot].astype(int).tolist(),
            "stalled_by_link":
                ring.stalled_by_link[slot].astype(int).tolist(),
            "hist": ring.hist[slot].astype(int).tolist(),
            "overwritten": overwritten,
        })
    return rows


def ring_rows(ring: TelemetryRing) -> list[dict]:
    """Host-side decode of a ring without a shard axis (or one shard's
    view), oldest to newest, wrap-aware: one JSON-serializable dict per
    recorded window::

        {"window": int, "counters": {field: int | [int, ...]},
         "credits": [...], "parked_by_link": [...],
         "stalled_by_link": [...], "hist": [...], "overwritten": int}

    ``overwritten`` (the same on every row) is how many older windows the
    ring dropped; 0 means the whole run is present.
    """
    if ring.n_shards is not None:
        raise ValueError("ring has a shard axis: take ring_shard(ring, s) "
                         "or global_rows(ring, n_shards)")
    return _rows(_host(ring))


def global_rows(ring: TelemetryRing, n_shards: int) -> list[dict]:
    """Global per-window rows of a ring with a shard axis: the per-shard
    counter and histogram lanes summed over the shards, the descriptor
    lanes as they are (the run directory's ``recorder.jsonl``)."""
    if ring.n_shards != int(n_shards):
        raise ValueError(f"ring has {ring.n_shards} shards, asked for "
                         f"{n_shards}")
    host = _host(ring)
    per = [_rows(ring_shard(host, s)) for s in range(int(n_shards))]
    rows = per[0]
    for other in per[1:]:
        for r, o in zip(rows, other):
            for f in COUNTER_FIELDS:
                r["counters"][f] = (
                    np.asarray(r["counters"][f], np.int64)
                    + np.asarray(o["counters"][f], np.int64)).tolist()
            r["hist"] = (np.asarray(r["hist"], np.int64)
                         + np.asarray(o["hist"], np.int64)).tolist()
    return rows


def counter_totals(rows: list[dict]) -> dict[str, np.ndarray]:
    """Each COUNTER_FIELDS lane summed over a row list: what the
    conservation checks compare with the run's ``LinkStats`` totals
    (valid when ``overwritten == 0``)."""
    if rows and rows[0]["overwritten"]:
        raise ValueError("ring wrapped: totals would undercount "
                         f"({rows[0]['overwritten']} windows dropped)")
    out: dict[str, np.ndarray] = {}
    for f in COUNTER_FIELDS:
        vals = [np.asarray(r["counters"][f], np.int64) for r in rows]
        out[f] = (np.sum(vals, axis=0) if vals
                  else np.zeros((), np.int64))
    return out
