"""Transport API (frozen from the port's version of ``src/repro/transport/base.py``).

A :class:`Transport` moves one flush window of per-destination bucket rows
between shards.  In the reference each shard calls ``exchange`` inside
``shard_map``; here the shard axis is the leading tensor dimension, so one
call ships every shard's rows:

* ``payload`` is ``(S, S, W)`` int32, row ``[s, d]`` offered by shard ``s``
  to shard ``d``; ``counts`` is ``(S, S)``;
* the result's ``recv_payload[d, s]`` is the row shard ``d`` received from
  shard ``s`` (the reference's per-shard ``recv_payload[s]``);
* per-shard statistics are ``(S,)`` tensors.

State that the reference replicates on every shard (the credit bank, the
transit-buffer tables) is held once; only ``parked_payload`` is per shard.

Credits (paper §2.1, ``core.flow_control``): each directed egress link of
each torus node holds ``link_credits`` credits; admitting a row spends its
event count on every link of its route as it crosses it, and a spent
credit returns ``notify_latency`` windows later, unless the row parks in
the downstream buffer, whose arrival link's credit is then held
(``FabricState.parked_by_link``) until the row departs.  Per link,
``credits + pending.sum(-1) + parked_by_link == limit`` in every window.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import flow_control as fc
from .flow_control import CreditBank
from .dispatch import resolve_device
from . import framing as wire_framing
from .profiles import get_profile


class FabricState(NamedTuple):
    """Carried fabric state: credit bank + in-fabric transit buffers
    (``parked_count[s, d]`` events of row (s, d) parked mid-route at hop
    ``parked_hop[s, d]`` for ``parked_age[s, d]`` windows, holding
    ``parked_by_link[l]`` credits; ``parked_payload[s]`` holds shard s's
    parked rows).  The crossbar carries zero-size tables."""

    bank: CreditBank
    parked_count: torch.Tensor        # (n, n) int32
    parked_hop: torch.Tensor          # (n, n) int32
    parked_age: torch.Tensor          # (n, n) int32
    parked_by_link: torch.Tensor      # (K,) int32
    parked_payload: torch.Tensor      # (S, n, W) int32, per shard
    parked_hold_shared: torch.Tensor  # (n, n) int32


LinkState = FabricState


def init_fabric_state(bank: CreditBank, n_shards: int, n_rows: int = 0,
                      payload_width: int = 0) -> FabricState:
    device = bank.credits.device
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)
    return FabricState(
        bank=bank,
        parked_count=z(n_rows, n_rows),
        parked_hop=z(n_rows, n_rows),
        parked_age=z(n_rows, n_rows),
        parked_by_link=z(bank.credits.shape[0]),
        parked_payload=z(n_shards, n_rows, payload_width),
        parked_hold_shared=z(n_rows, n_rows),
    )


class LinkStats(NamedTuple):
    """Per-window link-level statistics, one entry per shard.

    Per shard and window ``offered == sent + deferred + parked``; summed
    over shards ``sum(sent) + sum(unparked) == sum(delivered)``.  The
    array fields have a trailing backend-static length (0 for alltoall).
    ``stalled_by_link`` (the port's flight-recorder stall table) stays
    None here: no cell turns it on, and the program's must be None too.
    """

    offered_events: torch.Tensor
    sent_events: torch.Tensor
    deferred_events: torch.Tensor
    delivered_events: torch.Tensor
    credit_stalls: torch.Tensor
    hops: torch.Tensor
    forwarded_bytes: torch.Tensor     # legacy Extoll packet model
    bytes_on_wire: torch.Tensor       # frame-exact bytes of the profile
    max_in_flight: torch.Tensor
    stalled_by_hop: torch.Tensor      # (..., max_hops)
    max_in_flight_by_phase: torch.Tensor  # (..., ndim)
    parked_events: torch.Tensor
    unparked_events: torch.Tensor
    in_fabric_events: torch.Tensor
    parked_by_hop: torch.Tensor       # (..., max_hops)
    queue_dwell_us: torch.Tensor      # f32
    rerouted: torch.Tensor
    stalled_by_link: torch.Tensor | None = None


def zero_link_stats(batch: tuple = (), max_hops: int = 0, ndim: int = 0, *,
                    device=None) -> LinkStats:
    device = resolve_device(device)
    z = torch.zeros(batch, dtype=torch.int32, device=device)
    zh = torch.zeros(batch + (max_hops,), dtype=torch.int32, device=device)
    return LinkStats(z, z, z, z, z, z, z, z, z, zh,
                     torch.zeros(batch + (ndim,), dtype=torch.int32,
                                 device=device),
                     z, z, z, zh,
                     torch.zeros(batch, dtype=torch.float32, device=device),
                     z)


def pack_payload(payload: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Append the count column: (..., W) + (...,) -> (..., W + 1) int32."""
    return torch.cat([payload, counts.to(torch.int32)[..., None]], dim=-1)


def unpack_payload(buf: torch.Tensor):
    """Inverse of :func:`pack_payload` -> (payload, counts) views."""
    return buf[..., :-1], buf[..., -1]


class TransportOut(NamedTuple):
    """Result of shipping one window (shapes for S shards; ``[s, d]`` is
    the row shard s offered to shard d).

    ``sent_mask`` is the custody bit: True rows have left the sender
    (delivered this window or parked in the fabric's transit buffers);
    False rows were deferred and are offered again next window.
    ``sent_now`` narrows it to rows delivered this window.
    """

    state: LinkState
    recv_payload: torch.Tensor   # (S, S, W) row [d, s] came from shard s
    recv_counts: torch.Tensor    # (S, S) int32 events per received row
    sent_mask: torch.Tensor      # (S, S) bool
    stats: LinkStats             # (S,) per field
    sent_now: torch.Tensor       # (S, S) bool rows delivered this window
    queue_us: torch.Tensor       # (S, S) f32 queueing dwell of row (s, d)
                                 #   behind parked traffic on its route
    unparked_now: torch.Tensor   # (S, S) int32 events of parked rows
                                 #   delivered from the fabric this window
    park_wait_us: torch.Tensor   # (S, S) f32 park-dwell charge of rows
                                 #   delivered after parking


class Transport:
    """Base class: a window-granular bucket mover over ``n_shards``."""

    name: str = "base"

    def __init__(self, n_shards: int, *,
                 wire_format: str | wire_framing.WireFormat = "extoll"):
        self.n_shards = n_shards
        self.wire_fmt = get_profile(wire_format)

    def init_state(self, payload_width: int = 0, *, device=None) -> LinkState:
        """Fresh fabric state.  ``payload_width`` is the int32 width of the
        rows the caller will offer, which a transit buffer must hold; the
        crossbar never parks a row, so its tables are empty."""
        return init_fabric_state(fc.init_credits(0, 0, 1, device=device),
                                 self.n_shards)

    def drain_fabric(self, state: LinkState,
                     payload_width: int | None = None) -> TransportOut:
        """Deliver every row still parked in the transit buffers, credits
        ignored.  The crossbar never parks, so nothing is delivered."""
        n, device = self.n_shards, state.bank.credits.device
        w = (state.parked_payload.shape[-1] if payload_width is None
             else payload_width)
        zi = torch.zeros((n, n), dtype=torch.int32, device=device)
        zf = torch.zeros((n, n), dtype=torch.float32, device=device)
        full = torch.ones((n, n), dtype=torch.bool, device=device)
        return TransportOut(
            state=state,
            recv_payload=torch.zeros((n, n, w), dtype=torch.int32,
                                     device=device),
            recv_counts=zi, sent_mask=full,
            stats=zero_link_stats((n,), device=device),
            sent_now=full, queue_us=zf, unparked_now=zi, park_wait_us=zf)

    def route_hops(self, *, device=None) -> torch.Tensor:
        """(S, S) int32 links traversed by a row s -> d: one for every
        off-shard row on the crossbar."""
        return 1 - torch.eye(self.n_shards, dtype=torch.int32,
                             device=resolve_device(device))

    def exchange(self, state: LinkState, payload: torch.Tensor,
                 counts: torch.Tensor, *,
                 enforce_credits: bool = True) -> TransportOut:
        """Ship one window: payload (S, S, W) int32, counts (S, S) int32.
        ``enforce_credits=False`` ships regardless of the credit state (the
        end-of-run flush)."""
        raise NotImplementedError
