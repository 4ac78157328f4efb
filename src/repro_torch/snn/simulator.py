"""Windowed multi-shard SNN simulation over the bucket-exchange fabric
(port of ``src/repro/snn/simulator.py``).

The simulation advances in flush windows of ``window`` dt steps, with
``window <= min axonal delay`` so every spike of a window reaches its
destination before its timestamp deadline.  The window loop is software
pipelined as in the reference: iteration k

  1. ships window k-1's pending buckets, already encoded into 64-bit wire
     words by the flush-window kernel that built them, through the transport
     (``cfg.transport``: the ``alltoall`` crossbar, or ``torus2d`` /
     ``torus3d`` with hop-by-hop credits), decodes them (CUDA codec
     kernel), charges their wire latency and
     scatters their weighted input into the delay ring, checking
     deadlines.  A row refused at its source egress link is deferred and
     re-enters this window's aggregation ahead of everything else; a row
     refused at a transit link parks in the fabric and resumes from its
     hop in a later window;
  2. runs ``window`` LIF steps off the ring (one launch of the CUDA LIF
     window kernel);
  3. compacts the spikes into event words, puts the transport-deferred
     rows first, then the residue of window k-1, then the fresh events, and
     runs the flush window (one launch of the CUDA flush-window kernel:
     route through ``dest_of_addr``, rank, placement, the wire encode of
     the placed rows and the residue); the new buckets, their wire
     payload and the residue become the pending half of the carry.

One ``drain`` after the last window walks the fabric's transit buffers
empty and then flushes the last window's buckets, credits bypassed.

A window reads its step count from the card (``ShardState.t``), never from
the host, so a segment's windows can be replayed as one CUDA graph: on a
CUDA device, without a fault schedule or a recorder, ``run_segment``'s
first call for a number of windows runs them eagerly (which warms every
lazy table and library), the next captures them into a graph with its own
memory pool, and every later call copies the carry and the drive into the
graph's buffers, replays it and clones its outputs out, so what a call
returns is the caller's.  The faulted and recorded windows index their
schedule and ring by window on the host and stay eager.  :data:`SEGMENTS`
counts how segments ran.

``recorder`` (an ``obs.RecorderConfig``) turns on the flight recorder: the
carry gains a ``TelemetryRing`` and every window records its exchange's
counters, credit occupancy, the per-link stall table (kernel F's stall
lane: a credited torus is built with ``stall_attribution=True``) and its
latency histogram.  Without it the window runs exactly what it ran before
the recorder existed.

Differences from the reference, all of form:

* The shard axis is the leading tensor dimension ``S``; one call of each
  kernel serves every shard.  ``all_to_all`` is a transpose,
  ``lax.axis_index`` an ``arange(S)``, a per-shard ``[:, me]`` pick a
  transpose or diagonal.
* ``lax.scan`` is a Python loop.  The rings are updated in place, on
  copies made at the start of each segment, so a caller's carry is never
  modified.  The delay ring is laid out ``(ring_len, S, per)`` so that the
  slot read each step is contiguous.
* ``jax.random`` cannot be replayed by torch: the background drive and the
  initial potentials come from a ``torch.Generator`` in ``ShardState``, or
  are passed in (``run_segment(..., drive=...)``, ``ShardState`` built by
  the caller), which is how tests replay the reference's draws.
* Ring currents are summed with one batched f32 matrix product on the
  device (``torch.bmm``, in IEEE f32 unless the caller enables TF32); the
  reference sums through an einsum in another order, so ring currents and
  ``v`` agree within the LIF tolerances while all integer outputs agree
  exactly.

A ``network.SparsePartition`` (no reference counterpart) runs the same
window in the *source* address layout with a sparse synapse store: a
spike's event word carries its local id, and each replica k travels with
its destination ``fanout[id, k]`` as a per-event operand of the flush
window (held rows re-enter with their row's destination, the residue keeps
its destinations in ``SourcePendingWindow.residue_dest``).  The receiver's
source is ``src_base + address``.  Delivery walks the live events in order
(``kernels/synapse_deliver.py``, one launch a window), each synapse one
f32 add into the rings, inside a ``window/deliver`` span of the segments'
tracer.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import transport as tp
from repro_torch import wire
from repro_torch.core import aggregator, events as ev
from repro_torch.core.routing import RoutingTables
from repro_torch.fabric import faults as fabric_faults
from repro_torch.kernels import dispatch
from repro_torch.kernels import fused_route_bucket as frb
from repro_torch.kernels.lif_step import lif_window
from repro_torch.kernels.synapse_deliver import synapse_deliver
from repro_torch.obs import recorder as obs_recorder, spans
from repro_torch.snn import lif, network


SEGMENTS: dict[str, int] = {"eager": 0, "replayed": 0, "captured": 0}
"""Segments run by every ``run_segment``: ``eager`` window by window from
Python, ``replayed`` by replaying a captured CUDA graph; ``captured``
counts the graphs captured (one per simulator and number of windows)."""


def reset_segments() -> None:
    for k in SEGMENTS:
        SEGMENTS[k] = 0


class SimConfig(NamedTuple):
    n_shards: int
    per_shard: int            # neurons per shard
    max_fan: int              # max destination shards per source
    window: int = 8           # dt steps per flush window (<= min delay)
    ring_len: int = 32        # delay ring slots (> max delay + window)
    e_max: int = 512          # spike-compaction buffer per window
    capacity: int = 256       # bucket capacity (events per dest per window)
    params: lif.LIFParams = lif.LIFParams()
    residue: int = 256        # deferred-event carry buffer (re-offered)
    transport: str = "alltoall"   # "alltoall" | "torus2d" | "torus3d"
    torus_nx: int = 0         # torus shape (0 = most-square/cubic)
    torus_ny: int = 0
    torus_nz: int = 0         # wafer (Z) axis, torus3d only
    link_credits: int = 0     # events per window per egress link (0 = off;
                              #   spent on every hop of a row's route)
    notify_latency: int = 2   # windows before spent link credits return
    wire_format: str = "extoll"   # frame/latency profile
    step_us: float = 0.1      # wire microseconds per dt step


class ShardState(NamedTuple):
    neuron: lif.LIFState      # (S, per) per field
    ring_exc: torch.Tensor    # (ring_len, S, per) scheduled exc current
    ring_inh: torch.Tensor    # (ring_len, S, per) scheduled inh current
    t: torch.Tensor           # (S,) int32 global step
    generator: torch.Generator | None = None   # background-drive draws


class PendingWindow(NamedTuple):
    """Window k's aggregated buckets, shipped at the start of window k+1,
    plus the deferred events re-offered into window k+1.  ``meta`` carries
    each event's injection step, for the latency model; ``payload`` is
    ``wire.encode_planar(data, meta)``, written by the flush-window
    kernel that built the buckets."""

    data: torch.Tensor          # (S, S, C) int32 events [src, dst, slot]
    meta: torch.Tensor          # (S, S, C) int32 injection steps
    counts: torch.Tensor        # (S, S) int32 accepted per destination
    residue: torch.Tensor       # (S, residue) int32 deferred events
    residue_meta: torch.Tensor  # (S, residue) int32 their injection steps
    payload: torch.Tensor       # (S, S, 2C) int32 wire lanes (lo | hi)


class SourcePendingWindow(NamedTuple):
    """:class:`PendingWindow` of the source address layout: the residue's
    words do not name their destinations, so they travel beside them."""

    data: torch.Tensor
    meta: torch.Tensor
    counts: torch.Tensor
    residue: torch.Tensor
    residue_meta: torch.Tensor
    payload: torch.Tensor
    residue_dest: torch.Tensor  # (S, residue) int32 destination shards


class WindowStats(NamedTuple):
    """Per-shard statistics of one window (``run`` stacks them to
    ``(S, n_windows)``).  ``deadline_miss``, ``link`` and ``latency`` of
    row k belong to the exchange of window k-1's buckets, as in the
    reference; the final drain's misses are added to the last row."""

    spikes: torch.Tensor
    events_sent: torch.Tensor
    overflow: torch.Tensor
    wire_bytes: torch.Tensor
    deadline_miss: torch.Tensor
    offered: torch.Tensor
    deferred: torch.Tensor
    link: tp.LinkStats
    latency: wire.LatencySummary


class SimCarry(NamedTuple):
    """Resumable between-segment state of a sharded simulation; ``ring``
    is the flight recorder's ring (only with ``recorder=``)."""

    state: ShardState
    pending: PendingWindow
    link: tp.LinkState
    ring: obs_recorder.TelemetryRing | None = None


def tensors_of(tree) -> list:
    """The tensors of a nest of tuples (a carry, its stats), in order;
    other leaves skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [x for sub in tree for x in tensors_of(sub)]
    return []


def _refill(tree, tensors):
    """``tree`` with its tensors taken in order from the iterator
    ``tensors``."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, tuple):
        subs = [_refill(sub, tensors) for sub in tree]
        return type(tree)(*subs) if hasattr(tree, "_fields") else tuple(subs)
    return tree


def stack_windows(rows):
    """Stack per-window (S,)-leaved NamedTuples into (S, n_windows, ...)."""
    first = rows[0]
    if first is None:
        return None
    if hasattr(first, "_fields"):
        return type(first)(*(stack_windows([r[i] for r in rows])
                             for i in range(len(first))))
    return torch.stack(rows, dim=1)


def make_pipeline_fns(cfg: SimConfig, *, device=None, fault_schedule=None,
                      recorder=None, sparse: bool = False,
                      tracer: spans.Tracer = spans.NULL):
    """Build the pipelined per-window machinery.

    ``fault_schedule`` (a ``fabric.faults.FaultSchedule``; credited torus
    only) stamps window ``t // window``'s dead-link mask on the fabric
    state before each exchange.  ``recorder`` (an ``obs.RecorderConfig``)
    makes ``body`` carry a ``TelemetryRing`` as a fourth element and record
    every window into it, stamped with the exchanged window's index
    (``t // window - 1``: row 0 is the empty bootstrap exchange, -1).

    ``sparse`` runs the source address layout with a sparse store (the
    module docstring): ``body``'s ``tables`` is then the fan-out (S, per,
    max_fan) int32, and ``weights_t`` (of ``body`` and ``drain``) a
    ``network.SynapseStore``; delivery is recorded as ``window/deliver``
    spans on ``tracer``, on the issuing thread's track.

    Returns ``(init_pending, init_link, body, drain)``:
      init_pending()  -> empty PendingWindow (sparse: SourcePendingWindow)
      init_link()     -> transport fabric state
      body(carry, t, tables, weights_t, inh_src, delays, drive)
                      -> (carry', WindowStats) for carry (state, pending,
                         link) at the global step ``state.t``, read on the
                         device; ``t`` is the same step on the host, or
                         None in a captured window: the fault schedule and
                         the recorder need it, and with it the sparse
                         delivery's span is recorded; ``drive`` (window,
                         S, per) f32 is the background current of the
                         window's steps
      drain(state, pending, link, t, weights_t, inh_src)
                      -> (S,) deadline misses of the final flush: the
                         fabric's parked rows, then the pending buckets
                         (updates the state's rings in place)
    """
    device = dispatch.resolve_device(device)
    S, C, L = cfg.n_shards, cfg.capacity, cfg.ring_len
    opts = {"wire_format": cfg.wire_format}
    if cfg.transport in ("torus2d", "torus3d"):
        opts.update(nx=cfg.torus_nx, ny=cfg.torus_ny,
                    link_credits=cfg.link_credits,
                    notify_latency=cfg.notify_latency,
                    max_row_events=C)                 # livelock guard
        if cfg.transport == "torus3d":
            opts["nz"] = cfg.torus_nz
        if recorder is not None and cfg.link_credits > 0:
            opts["stall_attribution"] = True
    backend = tp.create(cfg.transport, n_shards=S, **opts)
    # can the transport ever refuse a row?  (the deferred re-offer runs
    # only where it can)
    can_defer = (cfg.transport in ("torus2d", "torus3d")
                 and cfg.link_credits > 0)
    if fault_schedule is not None:
        if not can_defer:
            raise ValueError(
                "fault injection needs a credit-throttled torus transport "
                "(transport='torus2d'/'torus3d' with link_credits > 0): an "
                "uncredited fabric has no admission point to reroute at")
        fault_schedule = fabric_faults.FaultSchedule(
            fault_schedule.link_down.to(device))
    fmt = backend.wire_fmt
    hops = backend.route_hops(device=device)
    own = torch.eye(S, dtype=torch.bool, device=device)
    slots = torch.arange(C, dtype=torch.int32, device=device)
    ring_slots = torch.arange(L, dtype=torch.int32, device=device)
    fan = torch.arange(cfg.max_fan, dtype=torch.int32, device=device)
    src_base = (torch.arange(S, dtype=torch.int32, device=device)[:, None]
                * cfg.per_shard)
    shard_ix = torch.arange(S, device=device)[:, None]
    row_dest = torch.arange(S, dtype=torch.int32, device=device)[
        None, :, None].expand(S, S, C).reshape(S, -1) if sparse else None

    def init_pending():
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                       device=device)
        pend = (z(S, S, C), z(S, S, C), z(S, S), z(S, cfg.residue),
                z(S, cfg.residue), z(S, S, 2 * C))
        if sparse:
            return SourcePendingWindow(*pend, z(S, cfg.residue))
        return PendingWindow(*pend)

    def init_link() -> tp.LinkState:
        return backend.init_state(2 * C, device=device)

    def _exchange(pend: PendingWindow, lstate, *, enforce_credits: bool):
        """Ship window k-1's buckets as 64-bit wire words; returns the
        received rows [dst, src], their meta and counts, the rows that
        left their senders [src, dst], the link statistics, the fabric
        state, the queueing dwell of the rows delivered to each shard and,
        under fault injection, the links each delivered row crossed
        [dst, src] (else None)."""
        out = backend.exchange(lstate, pend.payload, pend.counts,
                               enforce_credits=enforce_credits)
        recv, recv_meta = wire.decode_planar(out.recv_payload)
        links = None if out.links_used is None else out.links_used.T
        return (recv, recv_meta, out.recv_counts, out.sent_mask, out.stats,
                out.state, out.queue_us.T, links)

    def _window_latency(t, recv_meta, counts, queue_us, links=None):
        """Wire latency of the events just delivered at the (S,) steps
        ``t``: waiting since each event's injection step + the row's
        per-link switch and serialization charges + the queueing dwell.
        ``links`` (fault injection only) are the links each row actually
        crossed, so detour hops are charged."""
        live = slots < counts[..., None]
        wait_us = (t[:, None, None] - recv_meta).to(torch.float32) \
            * cfg.step_us
        hop_us = wire.hop_latency_us(fmt, counts,
                                     hops if links is None else links) \
            + queue_us
        lat = torch.clamp(wait_us, min=0.0) + hop_us[..., None]
        return wire.summarize_latency(lat, live, batch_dims=1)

    def _apply_events(ring_exc, ring_inh, words, counts, t, weights_t,
                      inh_src, window=None):
        """Scatter the weighted input of received events (S, S_src, C) into
        the delay rings (in place) at the (S,) steps ``t``; returns (S,)
        deadline misses.  ``window`` (the window's index on the host, or
        None) labels the sparse delivery's span; without it none is
        recorded."""
        if sparse:
            if window is None:
                return synapse_deliver(ring_exc, ring_inh, words, counts, t,
                                       weights_t, inh_src, cfg.per_shard)
            with tracer.span("window/deliver", window=window):
                return synapse_deliver(ring_exc, ring_inh, words, counts, t,
                                       weights_t, inh_src, cfg.per_shard)
        t = t[:, None, None]
        live = slots < counts[..., None]
        src = src_base + ev.address(words) // cfg.max_fan
        slack = ev.ts_slack(ev.timestamp(words), t & ev.TS_MASK)
        miss = (live & (slack < 0)).sum((1, 2), dtype=torch.int32)
        slot = (t + torch.clamp(slack, min=0)) % L
        flat_live = live.reshape(S, -1)
        flat_src = torch.where(flat_live, src.reshape(S, -1), 0).long()
        rows = weights_t[shard_ix, flat_src]                 # (S, E, per)
        inh = inh_src[flat_src] & flat_live
        onehot = (slot.reshape(S, -1)[..., None] == ring_slots).to(
            torch.float32)                                   # (S, E, L)
        lhs = torch.cat([onehot * (flat_live & ~inh)[..., None],
                         onehot * inh[..., None]], dim=-1)   # (S, E, 2L)
        acc = torch.bmm(lhs.transpose(1, 2), rows)           # (S, 2L, per)
        ring_exc += acc[:, :L].transpose(0, 1)
        ring_inh += acc[:, L:].transpose(0, 1)
        return miss

    def _simulate_steps(neuron, ring_exc, ring_inh, t0, drive):
        """``window`` LIF steps off the rings (consumed slots cleared in
        place) -> (neuron, spikes (S, window, per) bool)."""
        return lif_window(neuron, cfg.params, ring_exc, ring_inh, t0,
                          drive.contiguous())

    def _spikes_to_events(spikes, t0, delays, fanout=None):
        """Compact the (S, window, per) raster of the window starting at
        the (S,) steps ``t0`` into <= e_max spikes per
        shard, each replicated to ``max_fan`` event words (addr = id * fan
        + k; with the (S, per, max_fan) ``fanout`` of the source layout
        addr = id, and each replica's destination beside it), with each
        replica's injection step, the spikes lost, the (S,) spike counts
        and the destinations (None in the replica layout)."""
        _, w, per = spikes.shape
        t0 = t0[:, None]
        flat = spikes.reshape(S, w * per)
        # stable compaction: spiking slots first, window order kept
        order = torch.sort((~flat).to(torch.uint8), dim=-1,
                           stable=True).indices[:, :cfg.e_max]
        sel = torch.gather(flat, 1, order)
        sel_step = (order // per).to(torch.int32)
        sel_id = order % per
        fired = flat.sum(-1, dtype=torch.int32)
        lost = torch.clamp(fired - cfg.e_max, min=0)
        ts = (t0 + sel_step + torch.gather(delays, 1, sel_id)) & ev.TS_MASK
        if fanout is None:
            addr = (sel_id.to(torch.int32)[..., None] * cfg.max_fan
                    + fan).reshape(S, -1)
            dest = None
        else:
            addr = sel_id.to(torch.int32).repeat_interleave(cfg.max_fan, -1)
            dest = fanout[shard_ix, sel_id].reshape(S, -1)
        words = ev.pack(addr, ts.repeat_interleave(cfg.max_fan, -1),
                        valid=sel.repeat_interleave(cfg.max_fan, -1))
        inject = (t0 + sel_step).repeat_interleave(cfg.max_fan, -1)
        return words, inject, lost, fired, dest

    def body(carry, t: int | None, tables: RoutingTables, weights_t,
             inh_src, delays, drive):
        state, pend, lstate = carry[:3]
        now = state.t
        if t is None and (fault_schedule is not None or recorder is not None):
            raise ValueError("a fault schedule or a recorder needs the "
                             "window's step on the host")
        # 1. exchange + decode window k-1 (state.t == that window's end),
        #    under this window's dead-link mask when faults are injected
        #    (the exchange returns a state without it)
        if fault_schedule is not None:
            lstate = lstate._replace(link_down=fabric_faults.mask_at(
                fault_schedule, t // cfg.window))
        recv, rmeta, counts, sent_mask, lstats, lstate, qcol, links = \
            _exchange(pend, lstate, enforce_credits=True)
        latency = _window_latency(now, rmeta, counts, qcol, links)
        miss = _apply_events(state.ring_exc, state.ring_inh, recv, counts,
                             now, weights_t, inh_src,
                             None if t is None else t // cfg.window)
        # 2. simulate window k
        neuron, spikes = _simulate_steps(state.neuron, state.ring_exc,
                                         state.ring_inh, now, drive)
        # 3. route + aggregate: transport-deferred rows first, then the
        #    residue, then fresh spikes (oldest deadlines win bucket slots)
        words, inject, lost, fired, dest = _spikes_to_events(
            spikes, now, delays, tables if sparse else None)
        if can_defer:
            held = (~sent_mask[..., None]) & (slots < pend.counts[..., None])
            words = torch.cat([torch.where(held, pend.data, 0).reshape(S, -1),
                               pend.residue, words], dim=-1)
            inject = torch.cat([torch.where(held, pend.meta, 0).reshape(
                S, -1), pend.residue_meta, inject], dim=-1)
            if sparse:                    # a held row's destination: its row
                dest = torch.cat([row_dest, pend.residue_dest, dest], dim=-1)
        else:
            words = torch.cat([pend.residue, words], dim=-1)
            inject = torch.cat([pend.residue_meta, inject], dim=-1)
            if sparse:
                dest = torch.cat([pend.residue_dest, dest], dim=-1)
        if sparse:
            fw = frb.flush_window(words, S, C, dest=dest, meta=inject,
                                  residue_len=cfg.residue,
                                  with_residue_meta=True,
                                  with_residue_dest=True,
                                  wire_fmt=wire.DEFAULT_WORD)
        else:
            fw = frb.flush_window(words, S, C, dest_lut=tables.dest_of_addr,
                                  meta=inject, residue_len=cfg.residue,
                                  with_residue_meta=True,
                                  wire_fmt=wire.DEFAULT_WORD)
        b = fw.buckets
        cost = aggregator.window_cost(b.counts.masked_fill(own, 0))
        stats = WindowStats(
            spikes=fired,
            events_sent=b.counts.sum(-1, dtype=torch.int32),
            overflow=lost + fw.dropped,
            wire_bytes=cost.bytes,
            deadline_miss=miss,
            offered=fw.offered,
            deferred=fw.deferred,
            link=lstats,
            latency=latency,
        )
        state = ShardState(neuron, state.ring_exc, state.ring_inh,
                           now + cfg.window, state.generator)
        pend = (b.data, b.guids, b.counts, fw.residue, fw.residue_meta,
                fw.payload)
        pend = (SourcePendingWindow(*pend, fw.residue_dest) if sparse
                else PendingWindow(*pend))
        if recorder is not None:
            ring = obs_recorder.record(carry[3], t // cfg.window - 1, lstats,
                                       lstate, latency.hist)
            return (state, pend, lstate, ring), stats
        return (state, pend, lstate), stats

    def drain(state: ShardState, pend: PendingWindow, lstate, t: int,
              weights_t, inh_src):
        """Deliver every row still parked in the fabric (``drain_fabric``),
        then flush the last window's buckets with credits bypassed, into
        the rings, at the step ``state.t`` (``t`` on the host); the final
        residue stays deferred.  The drain's link statistics are not
        reported (they would break the per-window identities); its
        deadline misses are."""
        miss = torch.zeros((S,), dtype=torch.int32, device=device)
        window = t // cfg.window
        if can_defer:
            fab = backend.drain_fabric(lstate)
            recv_f, _ = wire.decode_planar(fab.recv_payload)
            miss = miss + _apply_events(state.ring_exc, state.ring_inh,
                                        recv_f, fab.recv_counts, state.t,
                                        weights_t, inh_src, window)
            lstate = fab.state
        recv, _, counts, *_ = _exchange(pend, lstate, enforce_credits=False)
        return miss + _apply_events(state.ring_exc, state.ring_inh, recv,
                                    counts, state.t, weights_t, inh_src,
                                    window)

    return init_pending, init_link, body, drain


class WindowInputs(NamedTuple):
    """What ``body`` reads besides its carry and drive, on the device."""

    tables: RoutingTables | torch.Tensor  # sparse: the (S, per, F) fan-out
    weights_t: torch.Tensor | network.SynapseStore  # dense: (S, N, per)
    inh_src: torch.Tensor        # (N,) bool inhibitory sources
    delays: torch.Tensor         # (S, per) int32 axonal delays in steps
    bg: torch.Tensor             # (S, per) f32 background rates [Hz]


def window_inputs(cfg: SimConfig,
                  part: network.Partition | network.SparsePartition,
                  bg_rates: np.ndarray, *, device=None) -> WindowInputs:
    """``part``'s weights, tables, delays and background rates on
    ``device``: a dense partition's weights as an (S, N, per) matrix, a
    sparse one's store and fan-out moved."""
    device = dispatch.resolve_device(device)
    S, per, n_tot = cfg.n_shards, cfg.per_shard, part.n_neurons
    if isinstance(part, network.SparsePartition):
        weights_t = network.SynapseStore(*(x.to(device)
                                           for x in part.store))
        tables = part.fanout.to(device).reshape(S, per, -1)
        delay_local = part.delays_steps.reshape(S, per)
    else:
        w_local, _fan, delay_local = network.shard_arrays(part)
        weights_t = torch.from_numpy(np.ascontiguousarray(w_local)).to(
            device).transpose(1, 2).contiguous()             # (S, N, per)
        tables = stack_tables([network.routing_tables_for_shard(
            part, s, device=device) for s in range(S)], device=device)
    inh_src = torch.from_numpy(part.is_inh).to(device)
    delays = torch.from_numpy(delay_local.astype(np.int32)).to(device)
    bg = torch.from_numpy(np.pad(bg_rates, (0, n_tot - len(bg_rates)))
                          .reshape(S, per).astype(np.float32)).to(device)
    return WindowInputs(tables, weights_t, inh_src, delays, bg)


def build_sharded_segments(cfg: SimConfig,
                           part: network.Partition | network.SparsePartition,
                           bg_rates: np.ndarray, bg_weight: float = 87.8,
                           fault_schedule=None, recorder=None, *,
                           device=None, tracer: spans.Tracer = spans.NULL):
    """Segment-granular simulator of all ``cfg.n_shards`` shards on one
    device (``None`` = CUDA, raising without one).

    ``part`` is a dense ``network.Partition`` (the replica layout, its
    weights uploaded as an (S, N, per) matrix) or a
    ``network.SparsePartition`` (the source layout; its store and fan-out
    moved to ``device``, its delivery spans recorded on ``tracer``).

    Returns ``(init, run_segment, finish)``:
      init(seed)                     -> SimCarry: potentials drawn from a
                                        generator seeded with ``seed``
                                        (kept for the drive), empty
                                        buckets, fresh fabric
      run_segment(carry, n_windows, drive=None)
                                     -> (SimCarry, WindowStats stacked to
                                        (S, n_windows)); ``drive`` is the
                                        background current, (n_windows,
                                        window, S, per) f32, else drawn
                                        from the state's generator
      finish(carry)                  -> (ShardState, (S,) deadline misses)
                                        after flushing the pending buckets

    With ``recorder`` the carry holds a ``TelemetryRing`` with a leading
    shard axis (``SimCarry.ring``), which each segment records into.

    On CUDA without ``fault_schedule`` and ``recorder``, ``run_segment``
    replays a CUDA graph of its windows from the second call for a number
    of windows on (the module docstring), recording a ``segment/capture``
    and ``segment/replay`` span on ``tracer``; the kernel launches of each
    replay are counted in ``dispatch.LAUNCHES`` as the eager loop would
    count them, and no window records a ``window/deliver`` span.
    """
    sparse = isinstance(part, network.SparsePartition)
    init_pending, init_link, body, drain = make_pipeline_fns(
        cfg, device=device, fault_schedule=fault_schedule, recorder=recorder,
        sparse=sparse, tracer=tracer)
    device = dispatch.resolve_device(device)
    S, per = cfg.n_shards, cfg.per_shard
    tables, weights_t, inh_src, delays, bg = window_inputs(
        cfg, part, bg_rates, device=device)
    drive_shape = (cfg.window, S, per)

    def init(seed: int = 0) -> SimCarry:
        gen = torch.Generator(device=device).manual_seed(seed)
        neuron = lif.init_state((S, per), cfg.params, generator=gen,
                                device=device)
        ring = torch.zeros((cfg.ring_len, S, per), dtype=torch.float32,
                           device=device)
        state = ShardState(neuron, ring, ring.clone(),
                           torch.zeros((S,), dtype=torch.int32,
                                       device=device), gen)
        link = init_link()
        telemetry = None if recorder is None else obs_recorder.ring_init(
            recorder.depth, link, (), (wire.N_LATENCY_BINS,),
            link.bank.credits.shape[0], n_shards=S)
        return SimCarry(state, init_pending(), link, telemetry)

    def _own_rings(state: ShardState) -> ShardState:
        return state._replace(ring_exc=state.ring_exc.clone(),
                              ring_inh=state.ring_inh.clone())

    def _windows(loop, n_windows: int, drive_of, t: int | None):
        """``n_windows`` windows of ``body`` from ``loop``; ``t`` the step
        on the host, or None in a captured segment."""
        rows = []
        for k in range(n_windows):
            loop, stats = body(loop, t, tables, weights_t, inh_src, delays,
                               drive_of(k))
            rows.append(stats)
            if t is not None:
                t += cfg.window
        return SimCarry(*loop), stack_windows(rows)

    def _draw(gen) -> torch.Tensor:
        return lif.poisson_input(bg.expand(drive_shape), bg_weight,
                                 cfg.params.dt, generator=gen)

    graphable = (device.type == "cuda" and fault_schedule is None
                 and recorder is None)
    # by number of windows: None once a segment ran eagerly, then its graph
    graphs: dict[int, _SegmentGraph | None] = {}

    def _capture(carry: SimCarry, n_windows: int) -> _SegmentGraph:
        """Capture ``n_windows`` windows into a graph whose inputs are
        copies of ``carry``'s tensors and a drive buffer."""
        inputs = [x.clone() for x in tensors_of(carry)]
        drive_buf = torch.empty((n_windows,) + drive_shape,
                                dtype=torch.float32, device=device)
        loop = _refill(carry, iter(inputs))[:3]
        before = dispatch.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with tracer.span("segment/capture", windows=n_windows):
            with torch.cuda.graph(graph):
                out = _windows(loop, n_windows, lambda k: drive_buf[k], None)
        launched = dispatch.take_launches(before)
        SEGMENTS["captured"] += 1
        return _SegmentGraph(graph, inputs, drive_buf, out, launched)

    def _replay(carry: SimCarry, n_windows: int, drive):
        g = graphs[n_windows]
        if g is None:
            g = graphs[n_windows] = _capture(carry, n_windows)
        for dst, src in zip(g.inputs, tensors_of(carry), strict=True):
            dst.copy_(src)
        if drive is not None:
            g.drive.copy_(drive)
        else:                   # the eager loop's draws, in its order
            for k in range(n_windows):
                g.drive[k].copy_(_draw(carry.state.generator))
        with tracer.span("segment/replay", windows=n_windows):
            g.graph.replay()
        dispatch.count_launches(g.launched)
        SEGMENTS["replayed"] += 1
        end, stats = _refill(g.out, (x.clone() for x in tensors_of(g.out)))
        return end._replace(state=end.state._replace(
            generator=carry.state.generator)), stats

    def run_segment(carry: SimCarry, n_windows: int, drive=None):
        if n_windows < 1:
            raise ValueError(f"n_windows must be >= 1, got {n_windows}")
        if drive is None and carry.state.generator is None:
            raise ValueError("no background drive: pass drive=... or a "
                             "state that carries a generator (init)")
        if drive is not None:
            if tuple(drive.shape) != (n_windows,) + drive_shape:
                raise ValueError(f"drive must be {(n_windows,) + drive_shape}"
                                 f", got {tuple(drive.shape)}")
            drive = drive.to(device=device, dtype=torch.float32)
        if graphable:
            if n_windows in graphs:
                return _replay(carry, n_windows, drive)
            graphs[n_windows] = None
        state = _own_rings(carry.state)
        loop = (state, carry.pending, carry.link)
        if recorder is not None:
            loop += (obs_recorder.ring_clone(carry.ring),)
        t = int(state.t[0])               # all shards share the step count
        SEGMENTS["eager"] += 1
        return _windows(loop, n_windows, (
            (lambda k: drive[k]) if drive is not None
            else lambda k: _draw(loop[0].generator)), t)

    def finish(carry: SimCarry):
        state = _own_rings(carry.state)
        miss = drain(state, carry.pending, carry.link, int(state.t[0]),
                     weights_t, inh_src)
        return state, miss

    return init, run_segment, finish


class _SegmentGraph(NamedTuple):
    """A captured segment: its graph, the input tensors it reads (the
    carry's, in ``tensors_of`` order, and the drive), the ``(SimCarry,
    WindowStats)`` it writes, and the kernel launches its capture counted
    (``dispatch.take_launches``)."""

    graph: torch.cuda.CUDAGraph
    inputs: list
    drive: torch.Tensor
    out: tuple
    launched: tuple


def stack_tables(tabs, *, device=None) -> RoutingTables:
    """Stack per-shard tables into (S, n) tensors on ``device``, padding
    each to the longest (destinations with NO_ROUTE, GUIDs and masks
    with 0)."""
    device = dispatch.resolve_device(device)

    def stack(field, fill):
        cols = [getattr(t, field) for t in tabs]
        n = max(c.shape[0] for c in cols)
        return torch.stack([torch.nn.functional.pad(c, (0, n - c.shape[0]),
                                                    value=fill)
                            for c in cols]).to(device)
    return RoutingTables(stack("dest_of_addr", -1), stack("guid_of_addr", 0),
                         stack("mcast_of_guid", 0))


def build_sharded_sim(cfg: SimConfig, part: network.Partition,
                      bg_rates: np.ndarray, bg_weight: float = 87.8,
                      fault_schedule=None, recorder=None, *, device=None):
    """Whole-run simulator (one segment + finish).

    Returns ``(init(seed) -> ShardState, run(state, n_windows, drive=None)
    -> (ShardState, WindowStats stacked to (S, n_windows)))``; the final
    flush's deadline misses land on the last window.  With ``recorder``
    ``run`` returns ``(state, stats, ring)``, the ring with a leading shard
    axis (decode with ``obs.global_rows`` or ``ring_shard`` +
    ``ring_rows``).
    """
    seg_init, run_segment, finish = build_sharded_segments(
        cfg, part, bg_rates, bg_weight, fault_schedule, recorder,
        device=device)
    fresh = seg_init(0)          # pending/link halves are seed-independent

    def init(seed: int = 0) -> ShardState:
        return seg_init(seed).state

    def run(state: ShardState, n_windows: int, drive=None):
        carry, stats = run_segment(
            SimCarry(state, fresh.pending, fresh.link, fresh.ring),
            n_windows, drive)
        state, miss_d = finish(carry)
        miss = stats.deadline_miss.clone()
        miss[:, -1] += miss_d
        stats = stats._replace(deadline_miss=miss)
        if recorder is not None:
            return state, stats, carry.ring
        return state, stats

    return init, run
