"""The two wire protocol profiles the paper compares (port of
``src/repro/wire/profiles.py``): ``extoll`` (64-byte cells, small header,
~100 Gbit/s, sub-microsecond switches) and ``ethernet`` (GbE with the full
Eth+IP+UDP stack, 64-byte minimum frames, preamble and gap,
store-and-forward switches)."""
from __future__ import annotations

from .framing import WireFormat

# Tourmalet: 12 lanes x 8.4 Gbit/s ~ 100 Gbit/s -> 12.5 GB/s = 12500 B/us.
EXTOLL = WireFormat(
    name="extoll",
    mtu_payload=512,            # 64 events of 8 B per cell train
    cell_bytes=64,
    header_bytes=8,
    crc_bytes=8,
    min_frame_bytes=0,
    gap_bytes=0,
    bytes_per_us=12500.0,
    switch_latency_us=0.6,
).validate()

# GbE: 125 B/us on the wire; 42 B L2-L4 headers, 4 B FCS, 64 B minimum
# frame, 20 B preamble+IFG, store-and-forward switches.
ETHERNET = WireFormat(
    name="ethernet",
    mtu_payload=1456,           # 182 events; fits the 1458 B UDP payload
    cell_bytes=1,
    header_bytes=42,
    crc_bytes=4,
    min_frame_bytes=64,
    gap_bytes=20,
    bytes_per_us=125.0,
    switch_latency_us=10.0,
).validate()

PROFILES: dict[str, WireFormat] = {p.name: p for p in (EXTOLL, ETHERNET)}


def get_profile(fmt: str | WireFormat) -> WireFormat:
    """Resolve a profile name or explicit format to a :class:`WireFormat`."""
    if isinstance(fmt, WireFormat):
        return fmt
    try:
        return PROFILES[fmt]
    except KeyError:
        raise ValueError(
            f"unknown wire format {fmt!r} (want one of "
            f"{sorted(PROFILES)} or a WireFormat)") from None
