"""Frame-level byte accounting (frozen from the port's version of ``src/repro/wire/framing.py``).

Payload per frame is capped at ``mtu_payload`` and padded to
``cell_bytes``; every frame pays header + CRC, is clamped to
``min_frame_bytes`` and followed by ``gap_bytes`` of line idle.  All
accounting is int32 tensor math over per-destination event counts.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class WireFormat(NamedTuple):
    """One wire protocol profile (framing geometry + link timing)."""

    name: str
    mtu_payload: int          # max payload bytes per frame (multiple of word)
    cell_bytes: int           # frame payload padded up to this granularity
    header_bytes: int         # per-frame protocol header
    crc_bytes: int            # per-frame checksum
    min_frame_bytes: int      # minimum header+payload+crc on the wire
    gap_bytes: int            # preamble + inter-frame gap per frame
    bytes_per_us: float       # link serialization bandwidth
    switch_latency_us: float  # per-hop switch/forwarding latency
    word_bytes: int = 8       # one encoded spike event (64-bit wire word)

    @property
    def events_per_frame(self) -> int:
        return self.mtu_payload // self.word_bytes

    def validate(self) -> "WireFormat":
        if self.mtu_payload % self.word_bytes:
            raise ValueError(
                f"{self.name}: mtu_payload {self.mtu_payload} must be a "
                f"multiple of word_bytes {self.word_bytes} (events never "
                f"straddle frames)")
        if min(self.mtu_payload, self.cell_bytes, self.word_bytes) <= 0:
            raise ValueError(f"{self.name}: non-positive geometry: {self}")
        if self.bytes_per_us <= 0 or self.switch_latency_us < 0:
            raise ValueError(f"{self.name}: bad link timing: {self}")
        return self


def _i32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def _frame_wire_bytes(fmt: WireFormat, payload_bytes) -> torch.Tensor:
    """On-wire cost of ONE frame carrying ``payload_bytes`` of payload."""
    p = _i32(payload_bytes)
    cells = (p + fmt.cell_bytes - 1) // fmt.cell_bytes * fmt.cell_bytes
    frame = torch.clamp(cells + fmt.header_bytes + fmt.crc_bytes,
                        min=fmt.min_frame_bytes)
    return frame + fmt.gap_bytes


def frame_bytes(fmt: WireFormat, n_events) -> torch.Tensor:
    """Exact on-wire bytes for ``n_events`` events."""
    n = _i32(n_events)
    epf = fmt.events_per_frame
    full = n // epf
    rem = n % epf
    total = full * int(_frame_wire_bytes(fmt, fmt.mtu_payload))
    last = _frame_wire_bytes(fmt, rem * fmt.word_bytes)
    return (total + torch.where(rem > 0, last, torch.zeros_like(last))
            ).to(torch.int32)


