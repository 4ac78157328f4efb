"""Bucket containers and the wire-cost model of a flush window, plain
PyTorch (frozen from the port's ``core/aggregator.py``, paper §3.1)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import events as ev


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
