"""Per-event latency model (port of ``src/repro/wire/latency.py``).

A delivered event is charged its waiting time since injection plus, per
traversed link, one switch latency and one re-serialization of its row's
frame train (store-and-forward), plus the queueing dwell behind parked
traffic.  The per-window digest is a 16-bin log histogram and weighted
p50/p99/max/mean; leading axes of the inputs give one digest each.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.wire.framing import WireFormat, frame_bytes

LATENCY_BIN_EDGES_US = tuple(float(2.0 ** e) for e in range(-2, 13))
N_LATENCY_BINS = len(LATENCY_BIN_EDGES_US) + 1


class LatencySummary(NamedTuple):
    """Per-window event-latency digest (f32 scalars, int32 hist)."""

    p50_us: torch.Tensor       # (...) weighted median
    p99_us: torch.Tensor       # (...) weighted 99th percentile
    max_us: torch.Tensor       # (...) slowest delivered event
    mean_us: torch.Tensor      # (...) weighted mean
    hist: torch.Tensor         # (..., N_LATENCY_BINS) events per bin


def zero_latency_summary(batch: tuple = (), *, device=None) -> LatencySummary:
    device = dispatch.resolve_device(device)
    z = torch.zeros(batch, dtype=torch.float32, device=device)
    return LatencySummary(z, z, z, z,
                          torch.zeros(batch + (N_LATENCY_BINS,),
                                      dtype=torch.int32, device=device))


def hop_latency_us(fmt: WireFormat, counts, hops) -> torch.Tensor:
    """Wire time of a bucket row: per traversed link one switch plus one
    re-serialization of the row's frame train (f32 microseconds)."""
    ser = frame_bytes(fmt, counts).to(torch.float32) / fmt.bytes_per_us
    return torch.as_tensor(hops).to(torch.float32) * (
        fmt.switch_latency_us + ser)


def queueing_latency_us(fmt: WireFormat, queued_events) -> torch.Tensor:
    """Serialization time of the events queued ahead of a row (f32 us)."""
    return frame_bytes(fmt, queued_events).to(torch.float32) / \
        fmt.bytes_per_us


@functools.lru_cache(maxsize=None)
def _bin_edges(device: torch.device) -> torch.Tensor:
    """``LATENCY_BIN_EDGES_US`` as an f32 tensor on ``device``, made once:
    a copy from the host each call could not be captured in a CUDA
    graph."""
    return torch.tensor(LATENCY_BIN_EDGES_US, dtype=torch.float32,
                        device=device)


def percentile_from_hist(hist, q: float) -> float:
    """Host-side quantile from a ``LATENCY_BIN_EDGES_US`` histogram: the
    upper edge of the bin holding the ``ceil(q * total)``-th event (twice
    the last edge for the open top bin, 0 for an empty histogram)."""
    hist = np.asarray(hist)
    total = int(hist.sum())
    if total == 0:
        return 0.0
    thresh = max(int(np.ceil(q * total)), 1)
    b = int(np.argmax(np.cumsum(hist) >= thresh))
    edges = LATENCY_BIN_EDGES_US
    return float(edges[b]) if b < len(edges) else float(edges[-1] * 2)


def summarize_latency(lat_us: torch.Tensor, weights: torch.Tensor, *,
                      batch_dims: int = 0) -> LatencySummary:
    """Weighted digest of per-row (or per-event) latencies.

    The first ``batch_dims`` axes are kept (one digest each); the rest are
    flattened.  ``weights`` are event counts; an all-zero weight vector
    yields the zero summary.  A percentile is the smallest latency whose
    cumulative event weight reaches ``ceil(q * total)``.
    """
    batch = tuple(lat_us.shape[:batch_dims])
    lat = lat_us.reshape(batch + (-1,)).to(torch.float32)
    w = weights.reshape(batch + (-1,)).to(torch.int32)
    total = w.sum(-1, dtype=torch.int32)
    lat_s, order = torch.sort(lat, dim=-1, stable=True)
    cw = torch.cumsum(torch.gather(w, -1, order), dim=-1, dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.float32, device=lat.device)

    def pct(q: float):
        # f32 product as in the reference; the threshold is compared in f32
        thresh = torch.ceil(total.to(torch.float32) * q)
        thresh = torch.clamp(thresh.to(torch.int32), min=1)
        idx = torch.argmax((cw >= thresh[..., None]).to(torch.uint8), dim=-1)
        val = torch.gather(lat_s, -1, idx[..., None])[..., 0]
        return torch.where(total > 0, val, zero)

    bins = torch.searchsorted(_bin_edges(lat.device), lat, right=True)
    hist = torch.zeros(batch + (N_LATENCY_BINS,), dtype=torch.int32,
                       device=lat.device).scatter_add_(-1, bins, w)
    mean = (lat * w.to(torch.float32)).sum(-1) / torch.clamp(total, min=1)
    return LatencySummary(
        p50_us=pct(0.5),
        p99_us=pct(0.99),
        max_us=torch.where(w > 0, lat, zero).amax(-1),
        mean_us=torch.where(total > 0, mean.to(torch.float32), zero),
        hist=hist,
    )
