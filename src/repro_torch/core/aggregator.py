"""Capacity-bounded bucket aggregation of a flush window and its wire-cost
model (port of ``src/repro/core/aggregator.py``, paper §3.1).

``aggregate(..., impl=)`` bins a window of events into per-destination
buckets in window order: ``"pallas"`` through the flush-window kernel A
(``kernels.fused_route_bucket.flush_window``), ``"fused"`` through the
sort-based chain beside it, ``"onehot"`` and ``"sort"`` as staged
cross-check oracles.  Functions
reduce over the last axis, so a leading shard axis gives one result per
shard.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import events as ev


class Buckets(NamedTuple):
    """Result of one aggregation window (leading batch axes allowed).

    data:     (..., D, C) int32 packed events (slot j < counts[d] is valid)
    guids:    (..., D, C) int32 meta travelling with the events
    counts:   (..., D)    int32 events accepted per destination
    overflow: (...)       int32 events beyond a bucket's capacity
    """

    data: torch.Tensor
    guids: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor


def _place(values, rows, slots, n_dest: int, capacity: int):
    """Scatter (..., N) ``values`` to ``[rows, slots]`` of (..., D, C)
    zeros; row ``n_dest`` is a spare that takes the dropped events and is
    cut off (the reference's ``.at[].set(mode="drop")``)."""
    batch = values.shape[:-1]
    out = torch.zeros(batch + ((n_dest + 1) * capacity,), dtype=torch.int32,
                      device=values.device)
    out.scatter_(-1, (rows * capacity + slots).long(),
                 values.to(torch.int32))
    return out.reshape(batch + (n_dest + 1, capacity))[..., :n_dest, :] \
        .contiguous()


def _positions_onehot(dest, valid, n_dest: int):
    """Slot of each event within its destination's bucket (window order)
    and the raw count per destination."""
    oh = torch.nn.functional.one_hot(
        torch.where(valid, dest, n_dest).long(),
        n_dest + 1)[..., :n_dest].to(torch.int32)          # (..., N, D)
    pos = torch.cumsum(oh, dim=-2, dtype=torch.int32) - oh  # exclusive
    return (pos * oh).sum(-1, dtype=torch.int32), oh.sum(-2,
                                                         dtype=torch.int32)


def _buckets(words, guids, rows, slots, keep, counts, n_dest: int,
             capacity: int) -> Buckets:
    rows = torch.where(keep, rows, n_dest)
    slots = torch.where(keep, slots, 0)
    accepted = torch.clamp(counts, max=capacity)
    return Buckets(_place(words, rows, slots, n_dest, capacity),
                   _place(guids, rows, slots, n_dest, capacity), accepted,
                   (counts - accepted).sum(-1, dtype=torch.int32))


def aggregate_onehot(words, dest, guids, n_dest: int,
                     capacity: int) -> Buckets:
    valid = ev.is_valid(words) & (dest >= 0) & (dest < n_dest)
    pos, counts = _positions_onehot(dest, valid, n_dest)
    return _buckets(words, guids, dest, pos, valid & (pos < capacity),
                    counts, n_dest, capacity)


def aggregate_sort(words, dest, guids, n_dest: int,
                   capacity: int) -> Buckets:
    valid = ev.is_valid(words) & (dest >= 0) & (dest < n_dest)
    key = torch.where(valid, dest, n_dest).to(torch.int32)  # invalid last
    skey, order = torch.sort(key, dim=-1, stable=True)
    swords = torch.gather(words, -1, order)
    sguids = torch.gather(guids, -1, order)
    # slot within group: index - index of the first with the same key
    first = torch.searchsorted(skey, skey, out_int32=True)
    pos = torch.arange(key.shape[-1], dtype=torch.int32,
                       device=key.device) - first
    counts = torch.zeros(key.shape[:-1] + (n_dest + 1,), dtype=torch.int32,
                         device=key.device).scatter_add_(
        -1, key.long(), torch.ones_like(key))[..., :n_dest]
    return _buckets(swords, sguids, skey, pos,
                    (skey < n_dest) & (pos < capacity), counts, n_dest,
                    capacity)


def aggregate(words, dest, guids, n_dest: int, capacity: int,
              impl: str = "auto") -> Buckets:
    """Bin a window of events into per-destination buckets.

    impl: ``"onehot" | "sort" | "fused" | "pallas" | "auto"``.  ``"pallas"``
    names the hand-written flush-window kernel
    (``kernels.ops.fused_scatter``; its plain version on CPU tensors); ``"auto"`` is the kernel on a CUDA
    tensor and ``"fused"`` on a CPU one.
    """
    if guids is None:
        guids = torch.zeros_like(words, dtype=torch.int32)
    dest = dest.to(torch.int32)
    if impl == "auto":
        from repro_torch.kernels import dispatch
        impl = "pallas" if dispatch.on_cuda(words) else "fused"
    if impl == "onehot":
        return aggregate_onehot(words, dest, guids, n_dest, capacity)
    if impl == "sort":
        return aggregate_sort(words, dest, guids, n_dest, capacity)
    if impl == "fused":
        from repro_torch.kernels import fused_route_bucket as frb
        return frb.fused_aggregate(words, dest, guids, n_dest,
                                   capacity).buckets
    if impl == "pallas":
        from repro_torch.kernels import ops
        return ops.fused_scatter(words, dest, guids, n_dest, capacity)
    raise ValueError(f"unknown impl {impl!r}")


def overflow_mask(words, dest, n_dest: int, capacity: int) -> torch.Tensor:
    """True for events not accepted this window (their bucket was full);
    callers offer them again next window."""
    valid = ev.is_valid(words) & (dest >= 0) & (dest < n_dest)
    pos, _ = _positions_onehot(dest.to(torch.int32), valid, n_dest)
    return valid & (pos >= capacity)


class WindowCost(NamedTuple):
    packets: torch.Tensor      # int32 packets emitted
    bytes: torch.Tensor        # int32 wire bytes (headers + padded payload)
    cycles: torch.Tensor       # int32 serial port cycles to drain the window
    efficiency: torch.Tensor   # f32 useful payload fraction


def window_cost(counts: torch.Tensor,
                max_events_per_packet: int = ev.PACKET_MAX_EVENTS
                ) -> WindowCost:
    """Cost of flushing buckets with ``counts`` (..., D) events; a bucket of
    more than 124 events emits ceil(count / 124) packets."""
    c = counts.to(torch.int32)
    full = c // max_events_per_packet
    rem = c % max_events_per_packet
    packets = full + (rem > 0).to(torch.int32)
    bytes_full = full * int(ev.packet_bytes(max_events_per_packet))
    bytes_rem = ev.packet_bytes(rem)            # 0 where rem == 0
    total = (bytes_full + bytes_rem).sum(-1, dtype=torch.int32)
    cycles = ((total + ev.DATAPATH_BYTES_PER_CYCLE - 1)
              // ev.DATAPATH_BYTES_PER_CYCLE)
    useful = c.sum(-1, dtype=torch.int32) * ev.EVENT_BYTES
    eff = useful / torch.clamp(total, min=1)
    eff = torch.where(total > 0, eff, torch.zeros_like(eff))
    return WindowCost(packets.sum(-1, dtype=torch.int32), total, cycles,
                      eff.to(torch.float32))


def unaggregated_cost(n_events) -> WindowCost:
    """Cost of the no-aggregation baseline: one packet per event."""
    n = torch.as_tensor(n_events).to(torch.int32)
    total = n * int(ev.packet_bytes(1))
    cycles = n * int(ev.wire_cycles(1))
    eff = (n * ev.EVENT_BYTES) / torch.clamp(total, min=1)
    eff = torch.where(n > 0, eff, torch.zeros_like(eff))
    return WindowCost(n, total, cycles, eff.to(torch.float32))
