"""One flush window of the multi-shard spike exchange (port of
``src/repro/core/exchange.py``, paper §3).

A window is:

1. **route + aggregate** -- the source LUT lookup (§3, LUT 1) and the
   capacity-bounded per-destination buckets (§3.1): ``impl`` ``"fused"``
   / ``"pallas"`` / ``"auto"`` in one launch of the flush-window kernel A
   (``kernels.fused_route_bucket.flush_window``: route, rank, placement
   with the GUID lookup, encode); ``"onehot"`` /
   ``"sort"`` staged through ``RoutingTables.route`` and
   ``core.aggregator.aggregate``;
2. **transport** -- every (event, guid) pair becomes one 64-bit wire word
   (lane-planar rows; the fused impls encode inside kernel A,
   the staged ones with codec kernel B), a ``transport`` backend ships the
   rows (``alltoall`` crossbar, or the credited ``torus2d`` / ``torus3d``)
   and kernel B decodes them;
3. **multicast** -- the destination-side GUID lookup replays each received
   event onto the local HICANN links its mask names (§3, LUT 2).

The shard axis is the leading dimension: ``words`` is ``(S, N)``, tables
are stacked ``(S, ...)`` and every result carries a leading ``S``, as the
reference's ``make_exchange`` returns it; the reference's
``axis_index(my)`` is the shard index along that dimension.  Rows refused
by a congested link (``sent_mask`` False) are the caller's to offer again.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import transport as tp
from repro_torch import wire
from repro_torch.core import aggregator, events as ev
from repro_torch.core.routing import RoutingTables
from repro_torch.kernels import fused_route_bucket as frb


class ExchangeOut(NamedTuple):
    """Result of one flush window, per shard (leading axis S)."""

    recv_events: torch.Tensor   # (S, S, C) int32 events [dst, src, slot]
    recv_guids: torch.Tensor    # (S, S, C) int32
    recv_counts: torch.Tensor   # (S, S) int32 events received per source
    link_events: torch.Tensor   # (S, n_links, S * C) int32 after multicast
    sent_counts: torch.Tensor   # (S, S) int32 events sent per destination
    overflow: torch.Tensor      # (S,) int32 events beyond bucket capacity
    wire_bytes: torch.Tensor    # (S,) int32 off-shard bytes (all hops)
    sent_mask: torch.Tensor     # (S, S) bool False = row deferred by the
                                #   link flow control (offer it again)
    link: tp.LinkStats          # (S,) per field
    link_state: tp.LinkState    # advanced fabric state (thread it across
                                #   windows)
    latency: wire.LatencySummary  # (S,) digest of the off-shard rows each
                                #   shard delivered this window


def exchange_window(words: torch.Tensor, tables: RoutingTables, *,
                    n_shards: int, capacity: int, n_links: int = 8,
                    impl: str = "auto",
                    transport: tp.Transport | None = None,
                    link_state: tp.LinkState | None = None,
                    wire_format: str | wire.WireFormat = "extoll"
                    ) -> ExchangeOut:
    """One flush window of every shard: ``words`` (S, N) int32 new events,
    ``tables`` stacked over shards.  ``wire_format`` selects the frame
    profile of the default transport; a passed ``transport`` keeps its
    own."""
    # 1. route + aggregate
    if impl in ("auto", "fused", "pallas"):
        fw = frb.flush_window(words, n_shards, capacity,
                              dest_lut=tables.dest_of_addr,
                              guid_lut=tables.guid_of_addr,
                              wire_fmt=wire.DEFAULT_WORD)
        b, payload = fw.buckets, fw.payload
    else:
        dest, guid, routed = tables.route(words)
        words = torch.where(routed, words, ev.INVALID_EVENT)
        b = aggregator.aggregate(words, dest, guid, n_shards, capacity,
                                 impl=impl)
        payload = wire.encode_planar(b.data, b.guids)

    # 2. wire words through the transport
    if transport is None:
        transport = tp.create("alltoall", n_shards=n_shards,
                              wire_format=wire_format)
    device = words.device
    if link_state is None:
        link_state = transport.init_state(payload.shape[-1], device=device)
    out = transport.exchange(link_state, payload, b.counts)
    recv_events, recv_guids = wire.decode_planar(out.recv_payload)
    live = (torch.arange(capacity, device=device)
            < out.recv_counts[..., None])
    recv_events = torch.where(live, recv_events, ev.INVALID_EVENT)

    # 3. destination-side GUID -> multicast mask -> local links
    S = words.shape[0]
    flat_ev = recv_events.reshape(S, -1)
    masks = tables.multicast(torch.where(live, recv_guids, -1).reshape(S, -1))
    links = torch.arange(n_links, dtype=torch.int32, device=device)
    bits = (masks[:, None, :] >> links[None, :, None]) & 1
    link_events = torch.where(bits.bool(), flat_ev[:, None, :],
                              ev.INVALID_EVENT)

    # wire latency of the rows each shard delivered: per traversed link a
    # switch and one re-serialization, plus the queueing dwell behind
    # parked traffic and, for rows the fabric delivers from its transit
    # buffers, their park dwell.  Rows parked this window are charged by
    # the window that delivers them.
    c_row = torch.where(out.unparked_now > 0, out.unparked_now, b.counts)
    lat_us = (wire.hop_latency_us(transport.wire_fmt, c_row,
                                  transport.route_hops(device=device))
              + out.queue_us + out.park_wait_us)
    off = ~torch.eye(S, dtype=torch.bool, device=device)
    lat_w = torch.where(off & out.sent_now, b.counts, 0) + out.unparked_now
    return ExchangeOut(
        recv_events=recv_events,
        recv_guids=recv_guids,
        recv_counts=out.recv_counts,
        link_events=link_events,
        sent_counts=b.counts,
        overflow=b.overflow,
        wire_bytes=out.stats.forwarded_bytes,
        sent_mask=out.sent_mask,
        link=out.stats,
        link_state=out.state,
        latency=wire.summarize_latency(lat_us, lat_w, batch_dims=1),
    )


def make_exchange(*, n_shards: int, capacity: int, n_addr_per_shard: int,
                  n_links: int = 8, impl: str = "auto",
                  transport: str = "alltoall",
                  transport_opts: dict | None = None,
                  wire_format: str | wire.WireFormat = "extoll"):
    """The multi-shard exchange: returns ``f(words (S, N), tables stacked
    over S) -> ExchangeOut`` with a leading shard dimension, each call on
    a fresh fabric state (thread :func:`exchange_window` by hand for
    several windows).  ``transport_opts`` go to ``transport.create`` (torus
    shape, link credits, ...); a torus refuses credits that could never
    admit a full ``capacity`` row."""
    transport_opts = dict(transport_opts or {})
    transport_opts.setdefault("wire_format", wire_format)
    if transport in ("torus2d", "torus3d"):
        transport_opts.setdefault("max_row_events", capacity)
    backend = tp.create(transport, n_shards=n_shards, **transport_opts)

    def run(words: torch.Tensor, tables: RoutingTables) -> ExchangeOut:
        return exchange_window(words, tables, n_shards=n_shards,
                               capacity=capacity, n_links=n_links, impl=impl,
                               transport=backend)

    return run
