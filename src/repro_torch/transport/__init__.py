"""Flush-window transports (port of ``src/repro/transport``).

``create("alltoall" | "torus2d" | "torus3d", n_shards=..., **opts)``
returns a :class:`~repro_torch.transport.base.Transport`: the crossbar
(``alltoall``) or the dimension-ordered torus backends with hop-by-hop
credits and transit buffers (``torus``; ``torus3d`` adds the wafer Z axis).
"""
from __future__ import annotations

from repro_torch.transport.base import (FabricState, LinkState, LinkStats,
                                        Transport, TransportOut,
                                        init_fabric_state, zero_link_stats)

BACKENDS = ("alltoall", "torus2d", "torus3d")


def create(name: str, *, n_shards: int, **opts) -> Transport:
    """Instantiate a transport backend by config key.

    Every backend takes ``wire_format`` (a ``WireFormat`` or profile name,
    ``"extoll"`` or ``"ethernet"``).  The torus backends also take
    ``nx`` / ``ny`` [/ ``nz``] (0 = most-square / most-cubic), the
    per-window ``link_credits`` of every directed egress link (0 =
    unthrottled), ``notify_latency`` windows before spent credits return,
    and ``max_row_events``, the largest row the caller offers (raises if
    ``link_credits`` could never admit one).
    """
    if name == "alltoall":
        from repro_torch.transport.alltoall import AllToAllTransport
        extra = set(opts) - {"wire_format"}
        if extra:
            raise TypeError(f"alltoall takes no options beyond wire_format, "
                            f"got {sorted(extra)}")
        return AllToAllTransport(n_shards, **opts)
    if name == "torus2d":
        from repro_torch.transport.torus import Torus2DTransport
        return Torus2DTransport(n_shards, **opts)
    if name == "torus3d":
        from repro_torch.transport.torus import Torus3DTransport
        return Torus3DTransport(n_shards, **opts)
    raise ValueError(f"unknown transport {name!r} (want one of {BACKENDS})")


__all__ = ["BACKENDS", "create", "FabricState", "LinkState", "LinkStats",
           "Transport", "TransportOut", "init_fabric_state",
           "zero_link_stats"]
