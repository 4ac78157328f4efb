"""Packed spike-event words (frozen from the port's version of ``src/repro/core/events.py``).

Bit layout (LSB first)::

    [ 0:15)  timestamp  (15 bits, systemtime units, wraps)
    [15:29)  address    (14 bits: 12-bit pulse address + 2-bit link id)
    [29:30)  valid flag
    [30:32)  reserved

Words are ``int32`` tensors holding the u32 bit pattern; with the reserved
bits clear they are non-negative, so ``>>`` and comparisons behave as on
``uint32``.
"""
from __future__ import annotations

import torch

TS_BITS = 15
ADDR_BITS = 14
TS_MASK = (1 << TS_BITS) - 1
ADDR_MASK = (1 << ADDR_BITS) - 1
VALID_BIT = 1 << (TS_BITS + ADDR_BITS)      # bit 29
EVENT_BITS = 30
EVENT_BYTES = 4

# Extoll packet geometry (paper §3.1): max payload 496 B == 124 events.
PACKET_PAYLOAD_BYTES = 496
PACKET_MAX_EVENTS = PACKET_PAYLOAD_BYTES // EVENT_BYTES   # == 124
PACKET_HEADER_BYTES = 16
DATAPATH_BYTES_PER_CYCLE = 16
DESERIAL_GROUP = 4

INVALID_EVENT = 0                            # valid bit clear


def _i32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def pack(address, timestamp, valid=None) -> torch.Tensor:
    """Pack (address, timestamp[, valid]) into int32 event words."""
    word = ((_i32(address) & ADDR_MASK) << TS_BITS) | (_i32(timestamp)
                                                       & TS_MASK)
    if valid is None:
        return word | VALID_BIT
    return torch.where(torch.as_tensor(valid, device=word.device),
                       word | VALID_BIT, torch.zeros_like(word))


def address(event: torch.Tensor) -> torch.Tensor:
    return (event >> TS_BITS) & ADDR_MASK


def timestamp(event: torch.Tensor) -> torch.Tensor:
    return event & TS_MASK


def is_valid(event: torch.Tensor) -> torch.Tensor:
    return (event & VALID_BIT) != 0


def ts_slack(deadline, now) -> torch.Tensor:
    """Signed systemtime units until ``deadline`` (negative = missed)."""
    d = (_i32(deadline) - _i32(now)) & TS_MASK
    return torch.where(d > (TS_MASK >> 1), d - (TS_MASK + 1), d)


def packet_bytes(n_events) -> torch.Tensor:
    """Wire bytes for a packet of ``n_events`` events (header included);
    the payload rounds up to 4-event groups, 0 events cost nothing."""
    n = _i32(n_events)
    groups = (n + (DESERIAL_GROUP - 1)) // DESERIAL_GROUP
    payload = groups * DESERIAL_GROUP * EVENT_BYTES
    return torch.where(n > 0, payload + PACKET_HEADER_BYTES,
                       torch.zeros_like(n))


