"""Torus transports with hop-by-hop credits (port of
``src/repro/transport/torus.py``, paper §1 and §2.1).

The Extoll fabric is a 3-D torus with dimension-ordered routing: a row
walks its X ring to the destination column, then Y, then Z (the wafer
axis), each on the shortest signed direction (``core.torus.Torus.route``).
Shard ``s`` sits at ``(c0 = s % n0, c1 = (s // n0) % n1, ...)``.

Per ring phase the reference runs a bidirectional store-and-forward
rotation with ``ppermute``: every node seeds two bundles (one per ring
direction) indexed by target coordinate, ships them one neighbour over
``floor(n/2)`` forward and ``floor((n-1)/2)`` backward hops, and each
arriving node absorbs the bundle addressed to it.  With the shard axis a
tensor dimension, the rotation is replayed on the ``(S, S)`` matrix of row
counts (the count column is all that ``LinkStats`` reads: bytes per hop,
store-and-forward occupancy, hops) with ``torch.roll`` along one torus
coordinate of the holder axis; the payload itself reaches its owner by one
transpose, which is where a healthy rotation delivers every row.

Flow control (``core.flow_control``): a bank of ``link_credits`` credits
for every directed egress link of every node (``n_shards * 2 * ndim``
links, ordered (x+, x-, y+, y-, z+, z-) per node).  Admission is the
reference's deterministic two-phase replay over the ``n²`` rows,
source-major, rotated by the bank's epoch: parked rows resume first from
their blocked hop, then fresh rows walk their route; a row short of
credits at a transit hop parks there (holding its arrival link's credit),
one short at hop 0 is deferred and head-of-line blocks its source egress
link for the rest of the window.  Here the replay is a loop over the rows
whose body is tensor operations over the route's hops (``admission``).

Only healthy windows are replayed: the port's fault injection (a dead-link
mask, reroutes, evictions) and its flight recorder's stall table have no
cell, and no counterpart here.

:class:`TenantTorusTransport` multiplexes T tenants on the same fabric
with per-tenant credit partitions (``core.flow_control.CreditPartition``):
its rows carry a tenant axis, its admission is kernel F's tenant form, and
each bundle of the rotation carries T count columns, one frame train per
tenant.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import aggregator
from . import flow_control as fc
from .topology import Torus
from . import admission
from .dispatch import resolve_device
from . import transport_base as base
from . import framing as wire_framing
from . import latency as wire_latency


class TorusTransport(base.Transport):
    """Dimension-ordered torus exchange with hop-by-hop per-link credits.

    ``prod(dims) == n_shards``.  ``link_credits=0`` disables throttling;
    a positive value is the per-window event budget of each directed
    egress link, spent on every hop of a row's route and returned
    ``notify_latency`` windows later.  Credits never exceed their limit,
    so ``link_credits`` must be at least the largest row the caller can
    offer (``max_row_events``): a larger row could never be admitted and
    would block its route forever, and construction refuses it.
    """

    name = "torus"

    def __init__(self, n_shards: int, dims: tuple[int, ...], *,
                 link_credits: int = 0, notify_latency: int = 2,
                 max_row_events: int = 0,
                 wire_format: str | wire_framing.WireFormat = "extoll"):
        super().__init__(n_shards, wire_format=wire_format)
        if 0 < link_credits < max_row_events:
            raise ValueError(
                f"link_credits ({link_credits}) must be >= the largest "
                f"bucket row ({max_row_events} events): credits never "
                f"exceed their initial limit, so an oversized row would "
                f"head-of-line-block its route forever")
        dims = tuple(int(d) for d in dims)
        if math.prod(dims) != n_shards:
            raise ValueError(f"mesh {dims} != n_shards {n_shards}")
        if not 1 <= len(dims) <= 3:
            raise ValueError(f"1..3 torus dimensions supported, got {dims}")
        self.dims = dims
        self.ndim = len(dims)
        self.n_links = 2 * self.ndim                  # per node
        self.link_credits = int(link_credits)
        self.notify_latency = int(notify_latency)
        pad = dims + (1,) * (3 - self.ndim)
        self._host = Torus(nx=pad[0], ny=pad[1], nz=pad[2])
        self._build_routes()
        self._tables: dict[torch.device, dict] = {}

    # -- static topology ---------------------------------------------------
    def _build_routes(self):
        """Host precompute of every pair's dimension-ordered route as
        hop-ordered egress link ids (node * n_links + direction, -1
        padded; local rows all -1), ``_link_seq`` (n², max_hops), and the
        host model's hop counts."""
        n, nl = self.n_shards, self.n_links
        self.max_hops = max(sum(d // 2 for d in self.dims), 1)
        seq = np.full((n * n, self.max_hops), -1, np.int32)
        for s in range(n):
            for d in range(n):
                for h, (u, dir_) in enumerate(self._host.route_links(s, d)):
                    seq[s * n + d, h] = u * nl + dir_
        self._link_seq = seq
        self._route_len = (seq >= 0).sum(-1).astype(np.int32)
        ids = np.arange(n)
        self._hops_matrix = self._host.hops(
            ids[:, None], ids[None, :]).astype(np.int32)

    def _dev(self, device: torch.device) -> dict:
        """The static tables on ``device``, made once per device."""
        if device not in self._tables:
            to = lambda a: torch.from_numpy(a).to(device)
            ids = torch.arange(self.n_shards, device=device)
            self._tables[device] = dict(
                routes=admission.RouteTables(seq=to(self._link_seq),
                                             length=to(self._route_len)),
                hops=to(self._hops_matrix),
                coords=[c.long() for c in self._coords_of(ids)],
                eye=torch.eye(self.n_shards, dtype=torch.bool,
                              device=device),
                shards=ids)
        return self._tables[device]

    def route_hops(self, *, device=None) -> torch.Tensor:
        """(S, S) int32 links of the dimension-ordered route s -> d."""
        return self._dev(resolve_device(device))["hops"]

    # -- flow-control state ------------------------------------------------
    def init_state(self, payload_width: int = 0, *,
                   device=None) -> base.LinkState:
        """Bank of every node's egress links + empty transit buffers.
        Throttled callers pass the int32 ``payload_width`` of their rows:
        a parked row's buffer keeps custody of its wire words."""
        limit = self.link_credits if self.link_credits > 0 else 1 << 30
        bank = fc.init_credits(self.n_shards * self.n_links, limit,
                               self.notify_latency, device=device)
        if self.link_credits <= 0:       # nothing can park: empty tables
            return base.init_fabric_state(bank, self.n_shards)
        return base.init_fabric_state(bank, self.n_shards, self.n_shards,
                                      payload_width)

    # -- canonical hop-by-hop admission with transit buffers ---------------
    def _admit_global(self, state: base.FabricState,
                      counts_all: torch.Tensor) -> admission.AdmissionOut:
        """The two-phase admission replay over the global state
        (``admission.admission``): parked rows resume first from their
        blocked hop, then fresh rows walk their route, source-major with
        the sources rotated by ``bank.epoch``."""
        return admission.admission(
            counts_all.to(torch.int32), state,
            self._dev(counts_all.device)["routes"])

    # -- the rotation, replayed on the row counts ----------------------------
    # A holder's (S,) row axis keeps the reference's flattened layout
    # c0 + n0*c1 + n0*n1*c2, where axis a's coordinate is the DESTINATION
    # coordinate before phase a has run and the SOURCE coordinate after.
    def _phase_perm(self, a: int):
        nd = self.ndim
        lead = nd - 1 - a            # axis of dim ``a`` in the reshaped view
        perm = (lead, *(i for i in range(nd) if i != lead))
        return perm, tuple(int(i) for i in np.argsort(perm))

    def _to_phase(self, buf: torch.Tensor, a: int) -> torch.Tensor:
        """(S, S, *E) [holder, row, ...] -> (S, n_a, B, *E) bundles by ring
        coordinate (``E``: the tenant transport's count columns)."""
        perm, _ = self._phase_perm(a)
        extra = tuple(buf.shape[2:])
        tail = range(1 + self.ndim, 1 + self.ndim + len(extra))
        t = buf.reshape(buf.shape[0], *reversed(self.dims), *extra)
        return t.permute(0, *(1 + p for p in perm), *tail).reshape(
            buf.shape[0], self.dims[a], -1, *extra)

    def _from_phase(self, recv: torch.Tensor, a: int) -> torch.Tensor:
        """Inverse layout of :meth:`_to_phase`."""
        _, inv = self._phase_perm(a)
        extra = tuple(recv.shape[3:])
        tail = range(1 + self.ndim, 1 + self.ndim + len(extra))
        other = [d for i, d in enumerate(reversed(self.dims))
                 if i != self.ndim - 1 - a]
        t = recv.reshape(recv.shape[0], self.dims[a], *other, *extra)
        return t.permute(0, *(1 + p for p in inv), *tail).reshape(
            recv.shape[0], self.n_shards, *extra)

    def _neighbour(self, v: torch.Tensor, a: int, step: int) -> torch.Tensor:
        """Every holder passes ``v`` one step along its axis-``a`` ring
        (the reference's ``ppermute``): holder c receives c - step's."""
        s = v.shape
        t = v.reshape(*reversed(self.dims), *s[1:])
        return torch.roll(t, step, dims=self.ndim - 1 - a).reshape(s)

    def _ring_phase(self, bundles: torch.Tensor, a: int, acc: dict):
        """Rotate (S, n, B, *E) bundle counts (by target ring coordinate)
        to their owners -> the same shape by source ring coordinate; every
        count (of every trailing column) is one frame train.  ``acc``
        gathers each holder's LinkStats terms: wire bytes of every hop
        (legacy packet model and frame-exact), hops, and the peak
        store-and-forward occupancy after each absorption."""
        t = self._dev(bundles.device)
        n, my_c, ar = self.dims[a], t["coords"][a], t["shards"]
        k = torch.arange(n, device=bundles.device)
        fwd = (k[None, :] - my_c[:, None]) % n
        plus = (fwd >= 1) & (fwd <= n // 2)
        minus = fwd > n // 2
        hops_p, hops_m = n // 2, (n - 1) // 2
        zero = torch.zeros((), dtype=bundles.dtype, device=bundles.device)
        recv = torch.zeros_like(bundles)
        recv[ar, my_c] = bundles[ar, my_c]
        flat = lambda v: v.reshape(v.shape[0], -1)
        sel = lambda m: m.reshape(m.shape + (1,) * (bundles.dim() - 2))
        for step, v, n_hops in (
                (1, torch.where(sel(plus), bundles, zero), hops_p),
                (-1, torch.where(sel(minus), bundles, zero), hops_m)):
            for h in range(1, n_hops + 1):
                acc["bytes"] = (acc["bytes"]
                                + aggregator.window_cost(flat(v)).bytes)
                acc["owire"] = acc["owire"] + wire_framing.frame_bytes(
                    self.wire_fmt, flat(v)).sum(-1, dtype=torch.int32)
                v = self._neighbour(v, a, step)
                src = (my_c - step * h) % n
                recv[ar, src] = recv[ar, src] + v[ar, my_c]
                v = v.clone()
                v[ar, my_c] = 0
                acc["hops"] += 1
                occ = flat(v).sum(-1, dtype=torch.int32)
                acc["in_flight"] = torch.maximum(acc["in_flight"], occ)
                acc["in_flight_phase"][a] = torch.maximum(
                    acc["in_flight_phase"][a], occ)
        return recv

    def _rotate(self, cnt: torch.Tensor):
        """All dimension-ordered phases over the (S, S, *E) [src, dst, ...]
        counts -> (rotation statistics, (S, S, *E) [dst, src, ...]
        delivered counts)."""
        z = torch.zeros((self.n_shards,), dtype=torch.int32,
                        device=cnt.device)
        acc = {"bytes": z, "owire": z, "hops": 0, "in_flight": z,
               "in_flight_phase": [z] * self.ndim}
        buf = cnt
        for a in range(self.ndim):
            buf = self._from_phase(
                self._ring_phase(self._to_phase(buf, a), a, acc), a)
        return acc, buf

    @staticmethod
    def _deliver(payload: torch.Tensor, counts: torch.Tensor):
        """Row (s, d) lands at d as row s -> (recv_payload, recv_counts)."""
        recv = base.pack_payload(payload, counts).transpose(0, 1).contiguous()
        return base.unpack_payload(recv)

    # -- the full window ---------------------------------------------------
    def exchange(self, state: base.LinkState, payload: torch.Tensor,
                 counts: torch.Tensor, *,
                 enforce_credits: bool = True) -> base.TransportOut:
        n, H = self.n_shards, self.max_hops
        device = payload.device
        t = self._dev(device)
        eye = t["eye"]
        counts = counts.to(torch.int32)
        zero_w = torch.zeros((), dtype=payload.dtype, device=device)
        throttled = enforce_credits and self.link_credits > 0
        if throttled:
            if state.parked_payload.shape != payload.shape:
                raise ValueError(
                    f"FabricState payload buffer "
                    f"{tuple(state.parked_payload.shape)} != offered payload "
                    f"{tuple(payload.shape)}: initialize with "
                    f"init_state(payload_width=W) so parked rows keep "
                    f"custody of their wire words")
            # the reference replicates the (S, S) counts with a ring
            # all-gather whose hops enter no LinkStats counter; on one card
            # the matrix is global already
            adm = self._admit_global(state, counts)
            fresh_c, fresh_p = adm.fresh_complete, adm.fresh_park
            resumed, stall_hop = adm.resumed_complete, adm.stall_hop
            pc0 = state.parked_count
            # fresh completions ship the caller's payload, resumed rows
            # the fabric's custody copy (a fresh row behind a parked one
            # is deferred, so the two never share a slot)
            ship_fresh = fresh_c | (eye & (counts > 0))
            cnt_in = (torch.where(ship_fresh, counts, 0)
                      + torch.where(resumed, pc0, 0))
            row_payload = torch.where(
                resumed[..., None], state.parked_payload,
                torch.where(ship_fresh[..., None], payload, zero_w))
            bank = fc.credit_tick(state.bank, adm.spent, notify=adm.notify)
            state = base.FabricState(
                bank=bank,
                parked_count=adm.park_count,
                parked_hop=adm.park_hop,
                parked_age=adm.park_age,
                parked_by_link=adm.parked_by_link,
                parked_payload=torch.where(fresh_p[..., None], payload,
                                           state.parked_payload),
                parked_hold_shared=torch.zeros_like(adm.park_count))
            sent_mask = fresh_c | fresh_p | eye | (counts == 0)
            sent_now = fresh_c | eye | (counts == 0)
            queue_us = wire_latency.queueing_latency_us(
                self.wire_fmt, adm.queue_events)
            # park dwell: per window parked, one link credit budget drained
            # ahead of the row
            park_wait_us = wire_latency.queueing_latency_us(
                self.wire_fmt, adm.resume_age * self.link_credits)
        else:
            stall_hop = torch.full((n, n), -1, dtype=torch.int32,
                                   device=device)
            cnt_in, row_payload = counts, payload
            state = state._replace(bank=fc.credit_tick(
                state.bank, torch.zeros_like(state.bank.credits)))
            sent_mask = sent_now = torch.ones((n, n), dtype=torch.bool,
                                              device=device)
            queue_us = park_wait_us = torch.zeros((n, n),
                                                  dtype=torch.float32,
                                                  device=device)
        acc, rot = self._rotate(cnt_in)
        recv_payload, recv_counts = self._deliver(row_payload, cnt_in)

        # deferred rows histogrammed by their blocking hop, parked rows by
        # the hop they wait at
        stalled_by_hop = torch.zeros((n, H), dtype=torch.int32,
                                     device=device).scatter_add_(
            1, torch.clamp(stall_hop, 0, H - 1).long(),
            torch.where(stall_hop >= 0, counts, 0))
        offered = counts.sum(-1, dtype=torch.int32)
        zi = torch.zeros((n,), dtype=torch.int32, device=device)
        if throttled:
            sent = torch.where(sent_now, counts, 0).sum(-1, dtype=torch.int32)
            parked = torch.where(fresh_p, counts, 0).sum(-1,
                                                         dtype=torch.int32)
            unparked_now = torch.where(resumed, pc0, 0)
            unparked = unparked_now.sum(-1, dtype=torch.int32)
            parked_by_hop = torch.zeros((n, H), dtype=torch.int32,
                                        device=device).scatter_add_(
                1, torch.clamp(state.parked_hop, 0, H - 1).long(),
                state.parked_count)
            # each row pays one frame train per link it crossed this
            # window, so a route is counted once across park and resume
            c_row = torch.where(resumed, pc0, counts)
            owire = (wire_framing.frame_bytes(self.wire_fmt, c_row)
                     * adm.links_traversed).sum(-1, dtype=torch.int32)
            dwell = torch.where(fresh_c | resumed, queue_us + park_wait_us,
                                0.0).sum(-1)
            in_fabric = state.parked_count.sum(-1, dtype=torch.int32)
        else:
            sent = cnt_in.sum(-1, dtype=torch.int32)
            parked = unparked = in_fabric = zi
            unparked_now = torch.zeros((n, n), dtype=torch.int32,
                                       device=device)
            parked_by_hop = torch.zeros((n, H), dtype=torch.int32,
                                        device=device)
            owire = acc["owire"]
            dwell = torch.zeros((n,), dtype=torch.float32, device=device)
        stats = base.LinkStats(
            offered_events=offered,
            sent_events=sent,
            deferred_events=offered - sent - parked,
            delivered_events=rot.sum(-1, dtype=torch.int32),
            credit_stalls=(stall_hop >= 0).sum(-1, dtype=torch.int32),
            hops=torch.full((n,), acc["hops"], dtype=torch.int32,
                            device=device),
            forwarded_bytes=acc["bytes"],
            bytes_on_wire=owire,
            max_in_flight=acc["in_flight"],
            stalled_by_hop=stalled_by_hop,
            max_in_flight_by_phase=torch.stack(acc["in_flight_phase"], -1),
            parked_events=parked,
            unparked_events=unparked,
            in_fabric_events=in_fabric,
            parked_by_hop=parked_by_hop,
            queue_dwell_us=dwell.to(torch.float32),
            rerouted=zi,          # healthy windows take no detours
        )
        return base.TransportOut(
            state=state,
            recv_payload=recv_payload,
            recv_counts=recv_counts,
            sent_mask=sent_mask,
            stats=stats,
            sent_now=sent_now,
            queue_us=queue_us,
            unparked_now=unparked_now,
            park_wait_us=park_wait_us,
        )

    # -- end-of-run fabric walk --------------------------------------------
    def drain_fabric(self, state: base.LinkState,
                     payload_width: int | None = None) -> base.TransportOut:
        """Deliver every parked row from its blocked hop, credits ignored
        (the end-of-run flush quiesces the fabric), releasing every held
        credit into the delay line; the returned tables are empty.  Each
        row's bytes on wire count only its remaining links, so a route is
        still counted once across its lifetime."""
        if state.parked_count.numel() == 0:    # unthrottled: nothing parked
            return super().drain_fabric(state, payload_width)
        n, device = self.n_shards, state.parked_count.device
        t = self._dev(device)
        pc, ph = state.parked_count, state.parked_hop
        payload = torch.where((pc > 0)[..., None], state.parked_payload,
                              torch.zeros((), dtype=torch.int32,
                                          device=device))
        acc, rot = self._rotate(pc)
        recv_payload, recv_counts = self._deliver(payload, pc)
        bank = fc.credit_tick(state.bank,
                              torch.zeros_like(state.bank.credits),
                              notify=state.parked_by_link)
        new_state = base.FabricState(
            bank=bank, parked_count=torch.zeros_like(pc),
            parked_hop=torch.zeros_like(ph),
            parked_age=torch.zeros_like(state.parked_age),
            parked_by_link=torch.zeros_like(state.parked_by_link),
            parked_payload=torch.zeros_like(state.parked_payload),
            parked_hold_shared=torch.zeros_like(state.parked_hold_shared))
        remaining_links = torch.clamp(t["hops"] - ph, min=0)
        owire = (wire_framing.frame_bytes(self.wire_fmt, pc)
                 * torch.where(pc > 0, remaining_links, 0)).sum(
                     -1, dtype=torch.int32)
        stats = base.zero_link_stats((n,), self.max_hops, self.ndim,
                                     device=device)._replace(
            delivered_events=rot.sum(-1, dtype=torch.int32),
            unparked_events=pc.sum(-1, dtype=torch.int32),
            hops=torch.full((n,), acc["hops"], dtype=torch.int32,
                            device=device),
            forwarded_bytes=acc["bytes"],
            bytes_on_wire=owire,
            max_in_flight=acc["in_flight"],
            max_in_flight_by_phase=torch.stack(acc["in_flight_phase"], -1))
        zf = torch.zeros((n, n), dtype=torch.float32, device=device)
        full = torch.ones((n, n), dtype=torch.bool, device=device)
        return base.TransportOut(
            state=new_state, recv_payload=recv_payload,
            recv_counts=recv_counts, sent_mask=full, stats=stats,
            sent_now=full, queue_us=zf, unparked_now=pc, park_wait_us=zf)

    def _coords_of(self, me):
        """Shard indices -> per-dimension ring coordinates."""
        out = []
        for d in self.dims:
            out.append(me % d)
            me = me // d
        return out


class Torus3DTransport(TorusTransport):
    """(nx, ny, nz) torus: wafer faces stacked along the Z (wafer) axis,
    the paper's full Extoll arrangement (``core.torus.wafer_topology``).
    Every dimension is given: the cells name their torus."""

    name = "torus3d"

    def __init__(self, n_shards: int, *, nx: int, ny: int, nz: int,
                 **opts):
        super().__init__(n_shards, (nx, ny, nz), **opts)
        self.nx, self.ny, self.nz = nx, ny, nz


# ---------------------------------------------------------------------------
# Multi-tenant torus: T concurrent experiments on one fabric with per-tenant
# QoS credit partitions (the serving substrate of ``serve.spike_engine``).
# ---------------------------------------------------------------------------

class TenantTorusTransport(TorusTransport):
    """Torus exchange multiplexing T tenants with partitioned credits.

    The fabric, routes and ring phases of :class:`TorusTransport`, with
    every physical link's budget split by a ``CreditPartition`` into one
    guaranteed slice per tenant plus a shared best-effort pool: a bank of
    ``(T+1) * K`` slots (slot ``t*K + l`` tenant t's slice of link l,
    ``T*K + l`` link l's pool) that ``credit_tick`` advances unchanged.

    Admission (kernel F's tenant form, ``kernels.admission.
    admission_tenants``): a row of tenant t spends reserved-first
    (``min(count, slice)`` from its slice, the rest from the pool) and
    crosses a link when slice + pool cover it; rows go in a round robin
    over (tenant, source) rotated by the epoch; a deferred row blocks only
    its own tenant's later rows on that egress link; a held credit
    remembers its split (``FabricState.parked_hold_shared``) and refunds
    each slot what it took, so ``credits + pending + parked_by_link ==
    slot limit`` holds for every slot.

    Shapes: ``payload`` (S, T, S, W) and ``counts`` (S, T, S), ``[s, t,
    d]`` the row shard s offers to shard d for tenant t (the reference's
    per-shard ``(T, n, W)`` with the shard axis leading).  The result's
    ``recv_payload[d, t, s]`` is the row shard d received from shard s,
    per-shard statistics are (S, T); the global tables (transit buffers,
    ``queue_us``, ``park_wait_us``) are (T, S, S) [tenant,
    src, dst].  Fabric-wide statistics with no per-tenant decomposition
    (hops, forwarded bytes, in-flight peaks; bytes on the wire of an
    uncredited window) go to tenant 0, so sums over tenants stay physical.
    On the wire each tenant's sub-row of a bundle is its own frame train.
    """

    name = "torus_tenant"

    def __init__(self, n_shards: int, dims: tuple[int, ...], *,
                 partition: fc.CreditPartition, notify_latency: int = 2,
                 max_row_events: int = 0,
                 wire_format: str | wire_framing.WireFormat = "extoll"):
        if partition.limit <= 0:
            raise ValueError("tenant partitioning needs link_credits > 0 "
                             "(an unthrottled fabric has nothing to split)")
        if max_row_events > 0:
            for t, r in enumerate(partition.reserve):
                if r + partition.shared < max_row_events:
                    raise ValueError(
                        f"tenant {t}: reserve ({r}) + shared "
                        f"({partition.shared}) < largest bucket row "
                        f"({max_row_events}): its biggest row could never "
                        f"be admitted and would head-of-line-block forever")
        super().__init__(n_shards, dims, link_credits=partition.limit,
                         notify_latency=notify_latency,
                         max_row_events=max_row_events,
                         wire_format=wire_format)
        self.partition = partition
        self.n_tenants = partition.n_tenants

    # -- flow-control state ------------------------------------------------
    def init_state(self, payload_width: int = 0, *,
                   device=None) -> base.LinkState:
        """Partitioned bank + (T, S, S) transit tables; ``parked_payload``
        is (S, T, S, W), shard s's parked rows."""
        T, n = self.n_tenants, self.n_shards
        K = n * self.n_links
        bank = fc.init_partitioned_credits(self.partition, K,
                                           self.notify_latency,
                                           device=device)
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                       device=bank.credits.device)
        return base.FabricState(
            bank=bank, parked_count=z(T, n, n), parked_hop=z(T, n, n),
            parked_age=z(T, n, n), parked_by_link=z((T + 1) * K),
            parked_payload=z(n, T, n, payload_width),
            parked_hold_shared=z(T, n, n))

    # -- tenant-aware canonical admission ----------------------------------
    def _admit_tenants(self, state: base.FabricState,
                       counts_all: torch.Tensor
                       ) -> admission.TenantAdmissionOut:
        """The replay over the T n² rows of ``counts_all`` (T, S, S)
        (``admission.admission_tenants``)."""
        return admission.admission_tenants(
            counts_all.to(torch.int32).contiguous(), state,
            self._dev(counts_all.device)["routes"])

    def _by_hop(self, hop: torch.Tensor, weight: torch.Tensor):
        """(S, T, S) weights -> (S, T, max_hops) hop histograms."""
        H = self.max_hops
        return torch.zeros(hop.shape[:-1] + (H,), dtype=torch.int32,
                           device=hop.device).scatter_add_(
            -1, torch.clamp(hop, 0, H - 1).long(), weight.to(torch.int32))

    def _fabric_level(self, acc: dict):
        """Fabric-wide (non-decomposable) stats, (S,) per holder, put on
        tenant 0 so sums over tenants stay physical -> (S, T) each and
        (S, T, ndim)."""
        n, T = self.n_shards, self.n_tenants
        device = acc["bytes"].device

        def on0(v):
            out = torch.zeros((n, T) + v.shape[1:], dtype=torch.int32,
                              device=device)
            out[:, 0] = v
            return out

        hops = torch.full((n,), acc["hops"], dtype=torch.int32,
                          device=device)
        return (on0(hops), on0(acc["bytes"]), on0(acc["in_flight"]),
                on0(torch.stack(acc["in_flight_phase"], -1)))

    def _ship(self, row_payload: torch.Tensor, cnt: torch.Tensor):
        """Rotate the (S, T, S) [src, tenant, dst] counts with one count
        column per tenant and deliver the rows -> (acc, recv_payload
        (S, T, S, W), recv_counts (S, T, S), delivered (S, T))."""
        acc, rot = self._rotate(cnt.permute(0, 2, 1))
        recv = base.pack_payload(row_payload, cnt).permute(2, 1, 0, 3)
        recv_payload, recv_counts = base.unpack_payload(recv.contiguous())
        return acc, recv_payload, recv_counts, rot.sum(1, dtype=torch.int32)

    # -- the full multi-tenant window --------------------------------------
    def exchange(self, state: base.LinkState, payload: torch.Tensor,
                 counts: torch.Tensor, *,
                 enforce_credits: bool = True) -> base.TransportOut:
        """Ship one window for every tenant: ``payload`` (S, T, S, W),
        ``counts`` (S, T, S); see the class docstring for the result."""
        T, n, H = self.n_tenants, self.n_shards, self.max_hops
        device = payload.device
        counts = counts.to(torch.int32)
        if tuple(payload.shape[:3]) != (n, T, n) or tuple(
                counts.shape) != (n, T, n):
            raise ValueError(
                f"tenant transport wants payload (S={n}, T={T}, S, W) and "
                f"counts (S, T, S); got {tuple(payload.shape)} / "
                f"{tuple(counts.shape)}")
        is_local = self._dev(device)["eye"][:, None, :]      # (S, 1, S)
        zero_w = torch.zeros((), dtype=payload.dtype, device=device)
        zero_q = torch.zeros((T, n, n), dtype=torch.float32, device=device)
        # (T, S, S) [tenant, src, dst] -> each source's (S, T, S) rows
        mine = lambda x: x.transpose(0, 1).contiguous()
        if enforce_credits:
            if state.parked_payload.shape != payload.shape:
                raise ValueError(
                    f"FabricState payload buffer "
                    f"{tuple(state.parked_payload.shape)} != offered "
                    f"payload {tuple(payload.shape)}: initialize with "
                    f"init_state(payload_width=W)")
            # the reference all-gathers the (T, n) counts of every shard;
            # on one card that is a transpose of the stacked counts
            adm = self._admit_tenants(state, mine(counts))
            fresh_c, fresh_p = mine(adm.fresh_complete), mine(adm.fresh_park)
            resumed, stall_hop = mine(adm.resumed_complete), mine(
                adm.stall_hop)
            pc0 = mine(state.parked_count)
            ship_fresh = fresh_c | (is_local & (counts > 0))
            cnt_in = (torch.where(ship_fresh, counts, 0)
                      + torch.where(resumed, pc0, 0))
            row_payload = torch.where(
                resumed[..., None], state.parked_payload,
                torch.where(ship_fresh[..., None], payload, zero_w))
            bank = fc.credit_tick(state.bank, adm.spent, notify=adm.notify)
            state = base.FabricState(
                bank=bank,
                parked_count=adm.park_count,
                parked_hop=adm.park_hop,
                parked_age=adm.park_age,
                parked_by_link=adm.parked_by_link,
                parked_payload=torch.where(fresh_p[..., None], payload,
                                           state.parked_payload),
                parked_hold_shared=adm.hold_shared)
            sent_mask = fresh_c | fresh_p | is_local | (counts == 0)
            sent_now = fresh_c | is_local | (counts == 0)
            queue_us = wire_latency.queueing_latency_us(
                self.wire_fmt, adm.queue_events)
            park_wait_us = wire_latency.queueing_latency_us(
                self.wire_fmt, adm.resume_age * self.link_credits)
        else:
            fresh_p = resumed = torch.zeros((n, T, n), dtype=torch.bool,
                                            device=device)
            pc0 = torch.zeros((n, T, n), dtype=torch.int32, device=device)
            stall_hop = torch.full((n, T, n), -1, dtype=torch.int32,
                                   device=device)
            cnt_in, row_payload = counts, payload
            state = state._replace(bank=fc.credit_tick(
                state.bank, torch.zeros_like(state.bank.credits)))
            sent_mask = sent_now = torch.ones((n, T, n), dtype=torch.bool,
                                              device=device)
            queue_us = park_wait_us = zero_q

        acc, recv_payload, recv_counts, delivered = self._ship(
            row_payload, cnt_in)
        stalled_by_hop = self._by_hop(
            stall_hop, torch.where(stall_hop >= 0, counts, 0))
        offered = counts.sum(-1, dtype=torch.int32)
        zt = torch.zeros((n, T), dtype=torch.int32, device=device)
        unparked_now = torch.where(resumed, pc0, 0)
        if enforce_credits:
            sent = torch.where(sent_now, counts, 0).sum(-1, dtype=torch.int32)
            parked = torch.where(fresh_p, counts, 0).sum(-1,
                                                         dtype=torch.int32)
            unparked = unparked_now.sum(-1, dtype=torch.int32)
            pk_cnt = mine(state.parked_count)
            parked_by_hop = self._by_hop(mine(state.parked_hop), pk_cnt)
            c_row = torch.where(resumed, pc0, counts)
            owire = (wire_framing.frame_bytes(self.wire_fmt, c_row)
                     * mine(adm.links_traversed)).sum(-1, dtype=torch.int32)
            dwell = torch.where(fresh_c | resumed,
                                mine(queue_us + park_wait_us), 0.0).sum(-1)
            in_fabric = pk_cnt.sum(-1, dtype=torch.int32)
        else:
            sent = cnt_in.sum(-1, dtype=torch.int32)
            parked = unparked = zt
            parked_by_hop = torch.zeros((n, T, H), dtype=torch.int32,
                                        device=device)
            owire = zt.clone()
            owire[:, 0] = acc["owire"]
            dwell = torch.zeros((n, T), dtype=torch.float32, device=device)
            in_fabric = mine(state.parked_count).sum(-1, dtype=torch.int32)
        hops_f, bytes_f, inflight_f, inflight_ph = self._fabric_level(acc)
        stats = base.LinkStats(
            offered_events=offered,
            sent_events=sent,
            deferred_events=offered - sent - parked,
            delivered_events=delivered,
            credit_stalls=(stall_hop >= 0).sum(-1, dtype=torch.int32),
            hops=hops_f,
            forwarded_bytes=bytes_f,
            bytes_on_wire=owire,
            max_in_flight=inflight_f,
            stalled_by_hop=stalled_by_hop,
            max_in_flight_by_phase=inflight_ph,
            parked_events=parked,
            unparked_events=unparked,
            in_fabric_events=in_fabric,
            parked_by_hop=parked_by_hop,
            queue_dwell_us=dwell.to(torch.float32),
            rerouted=zt,          # healthy windows take no detours
        )
        return base.TransportOut(
            state=state,
            recv_payload=recv_payload,
            recv_counts=recv_counts,
            sent_mask=sent_mask,
            stats=stats,
            sent_now=sent_now,
            queue_us=queue_us,
            unparked_now=unparked_now,
            park_wait_us=park_wait_us,
        )

    # -- end-of-run fabric walk --------------------------------------------
    def drain_fabric(self, state: base.LinkState,
                     payload_width: int | None = None) -> base.TransportOut:
        """Every parked row of every tenant resumes from its blocked hop
        and completes, credits ignored; every held credit (reserved and
        shared) releases into its slot's delay line, so per-slot
        ``credits + pending == slot limit`` again and the returned tables
        are empty."""
        T, n, H = self.n_tenants, self.n_shards, self.max_hops
        device = state.parked_count.device
        mine = lambda x: x.transpose(0, 1).contiguous()
        pc, ph = mine(state.parked_count), mine(state.parked_hop)
        row_payload = torch.where((pc > 0)[..., None], state.parked_payload,
                                  torch.zeros((), dtype=torch.int32,
                                              device=device))
        acc, recv_payload, recv_counts, delivered = self._ship(row_payload,
                                                               pc)
        bank = fc.credit_tick(state.bank,
                              torch.zeros_like(state.bank.credits),
                              notify=state.parked_by_link)
        z = torch.zeros_like
        new_state = base.FabricState(
            bank=bank, parked_count=z(state.parked_count),
            parked_hop=z(state.parked_hop), parked_age=z(state.parked_age),
            parked_by_link=z(state.parked_by_link),
            parked_payload=z(state.parked_payload),
            parked_hold_shared=z(state.parked_hold_shared))
        remaining = torch.clamp(self._dev(device)["hops"][:, None, :] - ph,
                                min=0)
        owire = (wire_framing.frame_bytes(self.wire_fmt, pc)
                 * torch.where(pc > 0, remaining, 0)).sum(-1,
                                                          dtype=torch.int32)
        hops_f, bytes_f, inflight_f, inflight_ph = self._fabric_level(acc)
        zt = torch.zeros((n, T), dtype=torch.int32, device=device)
        zh = torch.zeros((n, T, H), dtype=torch.int32, device=device)
        stats = base.LinkStats(
            offered_events=zt, sent_events=zt, deferred_events=zt,
            delivered_events=delivered, credit_stalls=zt,
            hops=hops_f, forwarded_bytes=bytes_f, bytes_on_wire=owire,
            max_in_flight=inflight_f, stalled_by_hop=zh,
            max_in_flight_by_phase=inflight_ph, parked_events=zt,
            unparked_events=pc.sum(-1, dtype=torch.int32),
            in_fabric_events=zt, parked_by_hop=zh,
            queue_dwell_us=torch.zeros((n, T), dtype=torch.float32,
                                       device=device),
            rerouted=zt)
        zf = torch.zeros((T, n, n), dtype=torch.float32, device=device)
        full = torch.ones((n, T, n), dtype=torch.bool, device=device)
        return base.TransportOut(
            state=new_state, recv_payload=recv_payload,
            recv_counts=recv_counts, sent_mask=full, stats=stats,
            sent_now=full, queue_us=zf, unparked_now=pc, park_wait_us=zf)
