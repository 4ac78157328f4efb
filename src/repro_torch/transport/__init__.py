"""Flush-window transports (port of ``src/repro/transport``).

``create("alltoall", n_shards=..., wire_format=...)`` returns the crossbar
backend.  The torus backends are not ported yet (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

from repro_torch.transport.base import (FabricState, LinkState, LinkStats,
                                        Transport, TransportOut,
                                        init_fabric_state, zero_link_stats)

BACKENDS = ("alltoall", "torus2d", "torus3d")


def create(name: str, *, n_shards: int, **opts) -> Transport:
    """Instantiate a transport backend by config key (``wire_format`` is
    the only option of ``alltoall``)."""
    if name == "alltoall":
        from repro_torch.transport.alltoall import AllToAllTransport
        extra = set(opts) - {"wire_format"}
        if extra:
            raise TypeError(f"alltoall takes no options beyond wire_format, "
                            f"got {sorted(extra)}")
        return AllToAllTransport(n_shards, **opts)
    if name in ("torus2d", "torus3d"):
        raise NotImplementedError(
            f"transport {name!r} is not ported yet (ROADMAP queue 1, item 7: "
            f"credits and the torus)")
    raise ValueError(f"unknown transport {name!r} (want one of {BACKENDS})")


__all__ = ["BACKENDS", "create", "FabricState", "LinkState", "LinkStats",
           "Transport", "TransportOut", "init_fabric_state",
           "zero_link_stats"]
