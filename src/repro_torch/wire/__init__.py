"""Wire subsystem (port of ``src/repro/wire``): the 64-bit wire-word codec
(CUDA kernel on the card), frame-exact byte accounting, the two protocol
profiles and the per-event latency model."""
from __future__ import annotations

from repro_torch.wire.codec import (DEFAULT_WORD, WireWordFormat,
                                    decode_planar, decode_words,
                                    encode_planar, encode_words)
from repro_torch.wire.framing import (WireFormat, frame_bytes, frame_count,
                                      frame_overhead_bytes, wire_efficiency)
from repro_torch.wire.latency import (LATENCY_BIN_EDGES_US, N_LATENCY_BINS,
                                      LatencySummary, hop_latency_us,
                                      percentile_from_hist,
                                      queueing_latency_us, summarize_latency,
                                      zero_latency_summary)
from repro_torch.wire.profiles import ETHERNET, EXTOLL, PROFILES, get_profile

__all__ = [
    "DEFAULT_WORD", "WireWordFormat", "encode_words", "decode_words",
    "encode_planar", "decode_planar",
    "WireFormat", "frame_bytes", "frame_count", "frame_overhead_bytes",
    "wire_efficiency",
    "LATENCY_BIN_EDGES_US", "N_LATENCY_BINS", "LatencySummary",
    "hop_latency_us", "percentile_from_hist",
    "queueing_latency_us", "summarize_latency", "zero_latency_summary",
    "EXTOLL", "ETHERNET", "PROFILES", "get_profile",
]
