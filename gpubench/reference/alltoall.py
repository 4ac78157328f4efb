"""Crossbar transport (frozen from the port's version of ``src/repro/transport/alltoall.py``).

The reference packs each shard's rows and counts into one ``(S, W + 1)``
buffer and ships it with one ``all_to_all(tiled=True)``.  With the shard
axis as a tensor dimension, that collective is a transpose of the
``(src, dst)`` axes of the packed ``(S, S, W + 1)`` buffer.  Every row is
admitted; ``LinkStats`` carries the off-shard wire cost, both the legacy
Extoll packet estimate and the frame-exact bytes of the wire profile.
"""
from __future__ import annotations

import torch

from . import aggregator
from . import transport_base as base
from .transport_base import pack_payload
from .transport_base import unpack_payload
from . import framing as wire_framing


class AllToAllTransport(base.Transport):
    """One packed exchange per window; no link-level state."""

    name = "alltoall"

    def __init__(self, n_shards: int, **kw):
        super().__init__(n_shards, **kw)
        self._constants: dict[torch.device, tuple] = {}

    def _window_constants(self, device: torch.device):
        """The tensors that are the same in every window, made once per
        device and shared (read-only): route hops, the all-true sent mask,
        the zero dwell and unparked tables and the zero link statistics."""
        if device not in self._constants:
            n = self.n_shards
            self._constants[device] = (
                self.route_hops(device=device),
                torch.ones((n, n), dtype=torch.bool, device=device),
                torch.zeros((n, n), dtype=torch.float32, device=device),
                torch.zeros((n, n), dtype=torch.int32, device=device),
                base.zero_link_stats((n,), device=device))
        return self._constants[device]

    def exchange(self, state: base.LinkState, payload: torch.Tensor,
                 counts: torch.Tensor, *,
                 enforce_credits: bool = True) -> base.TransportOut:
        hops, sent_mask, zero_us, zero_i, zero_stats = \
            self._window_constants(payload.device)
        packed = pack_payload(payload, counts)            # [src, dst, W+1]
        recv = packed.transpose(0, 1).contiguous()        # [dst, src, W+1]
        recv_payload, recv_counts = unpack_payload(recv)
        off = counts * hops                               # own row stays
        offered = counts.sum(-1, dtype=torch.int32)
        stats = zero_stats._replace(
            offered_events=offered,
            sent_events=offered,
            delivered_events=recv_counts.sum(-1, dtype=torch.int32),
            forwarded_bytes=aggregator.window_cost(off).bytes,
            bytes_on_wire=wire_framing.frame_bytes(self.wire_fmt, off).sum(
                -1, dtype=torch.int32),
        )
        return base.TransportOut(
            state=state,
            recv_payload=recv_payload,
            recv_counts=recv_counts,
            sent_mask=sent_mask,
            stats=stats,
            sent_now=sent_mask,
            queue_us=zero_us,
            unparked_now=zero_i,
            park_wait_us=zero_us,
        )
