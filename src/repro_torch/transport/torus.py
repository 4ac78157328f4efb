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
link for the rest of the window.  On the card the replay is one launch of
kernel F (``kernels/admission.py``, ``csrc/admission.cu``), which reads
nothing back to the host; on the CPU it is the tenant form's plain replay
with the fabric as one tenant that reserves nothing, a loop over the rows
with work whose body is tensor operations over the route's hops.

Fault injection: a caller stamps the window's (K,) dead-link mask on the
state (``FabricState.link_down``, ``fabric.faults.mask_at``).  Admission
then reroutes each axis whose short arc crosses a dead link the long way
around its ring, evicts parked rows whose remaining route or held link
died, and admits a detoured row all or nothing (the same kernel and
plain replay); each ring phase flips the same rows, both
directions run ``n - 1`` hops and absorption adds.  A mask needs credits.

:class:`TenantTorusTransport` multiplexes T tenants on the same fabric
with per-tenant credit partitions (``core.flow_control.CreditPartition``):
its rows carry a tenant axis, its admission is kernel F's tenant form, and
each bundle of the rotation carries T count columns, one frame train per
tenant.  Both transports run one window and one drain
(:meth:`TorusTransport.exchange`, :meth:`TorusTransport.drain_fabric`) on
rows shaped (S, *, S), [src, (tenant,) dst]; the tenant class overrides
only what its layout changes: the transposes between admission's (T, S, S)
tables and its rows, the shared-pool holds, the fabric-wide statistics
put on tenant 0 and the order of the dwell sum.

On the card, without a mask, the rotation is one launch
(``kernels/torus_exchange.py``, ``csrc/torus_exchange.cu``) for every
caller, and the tenant transport's credited window is two: kernel F's
tenant form, then kernel H, which forms the shipped and delivered rows,
the new state and every ``LinkStats`` field from F's outputs.  The eager
window is their plain version: it runs on CPU tensors and, on the card,
for the single-tenant torus and under a dead-link mask, whose ring
phases flip bundles.

``stall_attribution=True`` (the flight recorder's per-link congestion
table, reference ``_stall_attr``) has kernel F write one more output, the
window's deferred events per physical egress link, in the same launch;
a credited window's ``LinkStats.stalled_by_link`` carries it, the same
(K,) table on every shard.  Without it the field is None.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import aggregator
from repro_torch.core import flow_control as fc
from repro_torch.core.torus import Torus
from repro_torch.kernels import admission, dispatch, torus_exchange
from repro_torch.transport import base
from repro_torch.wire import framing as wire_framing
from repro_torch.wire import latency as wire_latency


def default_shape(n_shards: int) -> tuple[int, int]:
    """Most-square (nx, ny) factorization with nx <= ny (8 -> (2, 4), the
    paper's 2x4 concentrator face per wafer)."""
    nx = max(int(math.isqrt(n_shards)), 1)
    while n_shards % nx:
        nx -= 1
    return nx, n_shards // nx


def default_shape3d(n_shards: int) -> tuple[int, int, int]:
    """Most-cubic (nx, ny, nz) factorization with nx <= ny <= nz
    (8 -> (2, 2, 2), 16 -> (2, 2, 4))."""
    best = (1, 1, n_shards)
    for nx in range(1, int(round(n_shards ** (1 / 3))) + 1):
        if n_shards % nx:
            continue
        ny, nz = default_shape(n_shards // nx)
        if ny >= nx:
            best = (nx, ny, nz)
    return best


class TorusTransport(base.Transport):
    """Dimension-ordered torus exchange with hop-by-hop per-link credits.

    ``prod(dims) == n_shards``.  ``link_credits=0`` disables throttling;
    a positive value is the per-window event budget of each directed
    egress link, spent on every hop of a row's route and returned
    ``notify_latency`` windows later.  Credits never exceed their limit,
    so ``link_credits`` must be at least the largest row the caller can
    offer (``max_row_events``): a larger row could never be admitted and
    would block its route forever, and construction refuses it.
    ``stall_attribution`` adds ``LinkStats.stalled_by_link`` to credited
    windows.
    """

    name = "torus"

    def __init__(self, n_shards: int, dims: tuple[int, ...], *,
                 link_credits: int = 0, notify_latency: int = 2,
                 max_row_events: int = 0,
                 wire_format: str | wire_framing.WireFormat = "extoll",
                 stall_attribution: bool = False):
        super().__init__(n_shards, wire_format=wire_format)
        self.stall_attribution = bool(stall_attribution)
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
        hops_alt = sum(d - 1 for d in dims)
        if self.link_credits > 0 and hops_alt > admission.MAX_HOPS:
            raise ValueError(
                f"torus {dims}: detour routes of up to {hops_alt} hops; "
                f"the admission kernel replays at most {admission.MAX_HOPS} "
                f"(one lane of a warp per hop)")
        self._build_routes()
        self._tables: dict[torch.device, dict] = {}

    # -- static topology ---------------------------------------------------
    def _build_routes(self):
        """Host precompute of every pair's routes as hop-ordered egress
        link ids (node * n_links + direction, -1 padded; local rows all
        -1): for every subset of axes walking their ring the long way
        (combo bit a set = axis a detours; combo 0 is the default route)
        the whole route, ``_link_seq_alt`` (2^ndim, n², max_hops_alt), and
        each axis' short and long segment, ``_seg_links`` (ndim, 2, n²,
        Hs), which the per-window reroute decision gathers the mask over;
        and the host model's hop counts."""
        n, nl = self.n_shards, self.n_links
        host = self._host
        self.max_hops = max(sum(d // 2 for d in self.dims), 1)
        self.max_hops_alt = max(sum(d - 1 for d in self.dims), 1)
        n_combo = 1 << self.ndim
        alt = np.full((n_combo, n * n, self.max_hops_alt), -1, np.int32)
        seg_len = max(max(d - 1 for d in self.dims), 1)
        seg = np.full((self.ndim, 2, n * n, seg_len), -1, np.int32)
        pad3 = (False,) * (3 - self.ndim)
        for s in range(n):
            for d in range(n):
                if s == d:
                    continue
                for a in range(self.ndim):
                    for var in (0, 1):
                        for h, (u, dir_) in enumerate(host.axis_segment_links(
                                s, d, a, longway=bool(var))):
                            seg[a, var, s * n + d, h] = u * nl + dir_
                for combo in range(n_combo):
                    flips = tuple(bool(combo >> a & 1)
                                  for a in range(self.ndim)) + pad3
                    for h, (u, dir_) in enumerate(
                            host.route_links_detour(s, d, flips)):
                        alt[combo, s * n + d, h] = u * nl + dir_
        self._link_seq_alt = alt
        self._route_len_alt = (alt >= 0).sum(-1).astype(np.int32)
        self._seg_links = seg
        ids = np.arange(n)
        self._hops_matrix = self._host.hops(
            ids[:, None], ids[None, :]).astype(np.int32)

    def _dev(self, device: torch.device) -> dict:
        """The static tables on ``device``, made once per device."""
        if device not in self._tables:
            to = lambda a: torch.from_numpy(a).to(device)
            ids = torch.arange(self.n_shards, device=device)
            self._tables[device] = dict(
                routes=admission.RouteTables(
                    seq_alt=to(self._link_seq_alt),
                    len_alt=to(self._route_len_alt),
                    seg=to(self._seg_links)),
                hops=to(self._hops_matrix),
                coords=[c.long() for c in self._coords_of(ids)],
                eye=torch.eye(self.n_shards, dtype=torch.bool,
                              device=device),
                shards=ids)
        return self._tables[device]

    def route_hops(self, *, device=None) -> torch.Tensor:
        """(S, S) int32 links of the dimension-ordered route s -> d."""
        return self._dev(dispatch.resolve_device(device))["hops"]

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
                      counts_all: torch.Tensor,
                      link_down: torch.Tensor | None = None
                      ) -> admission.AdmissionOut:
        """The two-phase admission replay over the global state
        (``admission.admission``: kernel F on the card; healthy, or under a
        (K,) dead-link mask): parked rows resume first from their blocked
        hop, then fresh rows walk their route, source-major with the
        sources rotated by ``bank.epoch``.  Under a mask rows reroute
        around dead arcs, parked rows whose remaining route or held link
        died are evicted, and detours are all-or-nothing.  With
        ``stall_attribution`` the result carries ``stalled_by_link``."""
        return admission.admission(
            counts_all.to(torch.int32), state,
            self._dev(counts_all.device)["routes"], link_down,
            stall_lane=self.stall_attribution)

    # the reference's name for the replay under a mask
    _admit_global_faulted = _admit_global

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

    def _phase_fault(self, down: torch.Tensor, a: int):
        """Each holder's axis-``a`` ring view of the (K,) mask -> (S, n)
        bool pair: is the + / - link of the ring node at coordinate c
        dead.  That node is ``s + (c - my_c) * stride``."""
        t = self._dev(down.device)
        n = self.dims[a]
        stride = math.prod(self.dims[:a])
        ring = (t["shards"][:, None] + (torch.arange(n, device=down.device)
                                        - t["coords"][a][:, None]) * stride)
        link = ring * self.n_links + 2 * a
        return down[link], down[link + 1]

    def _ring_phase(self, bundles: torch.Tensor, a: int, acc: dict,
                    down: torch.Tensor | None = None):
        """Rotate (S, n, B, *E) bundle counts (by target ring coordinate)
        to their owners -> the same shape by source ring coordinate; every
        count (of every trailing column) is one frame train.  ``acc``
        gathers each holder's LinkStats terms: wire bytes of every hop
        (legacy packet model and frame-exact), hops, and the peak
        store-and-forward occupancy after each absorption.

        Under a dead-link mask each holder flips the bundles whose short
        arc crosses a dead link and whose long arc is clean to the other
        direction (the admission's per-axis rule, on the same mask), both
        directions run ``n - 1`` hops, and absorption adds (a bundle goes
        one way, never both)."""
        t = self._dev(bundles.device)
        n, my_c, ar = self.dims[a], t["coords"][a], t["shards"]
        k = torch.arange(n, device=bundles.device)
        fwd = (k[None, :] - my_c[:, None]) % n
        short_plus = fwd <= n // 2
        if down is None:
            plus = (fwd >= 1) & short_plus
            minus = fwd > n // 2
            hops_p, hops_m = n // 2, (n - 1) // 2
        else:
            down_p, down_m = self._phase_fault(down, a)
            # dead links among the first k walking + / - from the holder
            cum_p = torch.cumsum(down_p.gather(
                1, (my_c[:, None] + k) % n).to(torch.int32), 1)
            cum_m = torch.cumsum(down_m.gather(
                1, (my_c[:, None] - k) % n).to(torch.int32), 1)
            dirty = lambda cum, d: (d >= 1) & (cum.gather(
                1, torch.clamp(d - 1, min=0)) > 0)
            dirty_p, dirty_m = dirty(cum_p, fwd), dirty(cum_m, (n - fwd) % n)
            flip = (torch.where(short_plus, dirty_p, dirty_m)
                    & ~torch.where(short_plus, dirty_m, dirty_p))
            use_plus = short_plus ^ flip
            plus = (fwd >= 1) & use_plus
            minus = (fwd >= 1) & ~use_plus
            hops_p = hops_m = n - 1
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

    def _rotate(self, cnt: torch.Tensor, down: torch.Tensor | None = None
                ) -> torus_exchange.Rotation:
        """All dimension-ordered phases over the (S, S, *E) [src, dst, ...]
        counts -> the rotation's statistics and the (S, *E) events
        delivered to each shard.  Healthy on the card: one launch
        (``kernels.torus_exchange.rotate``); on the CPU or under a mask
        the replay (:meth:`_rotate_plain`)."""
        if down is None and dispatch.on_cuda(cnt):
            return torus_exchange.rotate(cnt, self.dims, self.wire_fmt)
        return self._rotate_plain(cnt, down)

    def _rotate_plain(self, cnt: torch.Tensor,
                      down: torch.Tensor | None = None
                      ) -> torus_exchange.Rotation:
        """The rotation's plain version: every phase's hops replayed."""
        n = self.n_shards
        z = torch.zeros((n,), dtype=torch.int32, device=cnt.device)
        acc = {"bytes": z, "owire": z, "hops": 0, "in_flight": z,
               "in_flight_phase": [z] * self.ndim}
        buf = cnt
        for a in range(self.ndim):
            buf = self._from_phase(
                self._ring_phase(self._to_phase(buf, a), a, acc, down), a)
        # buf is [dst, src, ...]: every row at its destination
        return torus_exchange.Rotation(
            bytes=acc["bytes"], owire=acc["owire"],
            hops=torch.full((n,), acc["hops"], dtype=torch.int32,
                            device=cnt.device),
            in_flight=acc["in_flight"],
            in_flight_phase=torch.stack(acc["in_flight_phase"], -1),
            delivered=buf.sum(1, dtype=torch.int32))

    def _ship(self, row_payload: torch.Tensor, cnt: torch.Tensor,
              down: torch.Tensor | None = None):
        """Rotate the (S, S) [src, dst] counts and deliver the rows: row
        (s, d) lands at d as row s -> (rotation, recv_payload,
        recv_counts)."""
        rot = self._rotate(cnt, down)
        recv = base.pack_payload(row_payload, cnt).transpose(0, 1).contiguous()
        return (rot, *base.unpack_payload(recv))

    # -- the window's layout ------------------------------------------------
    # The window below runs on rows (S, *, S), [src, (tenant,) dst]; the
    # admission's tables are global, (*, S, S).  A subclass with another
    # row layout overrides these.
    _admit = _admit_global

    @staticmethod
    def _rows(x: torch.Tensor) -> torch.Tensor:
        """A global table (or the counts) between admission's layout and
        the rows'; the same (S, S) table here."""
        return x

    # an (S, S) pair table broadcast over the rows
    _pairs = _rows

    @staticmethod
    def _hold_shared(adm) -> torch.Tensor:
        """Post-window shared-pool holds: none without a partition."""
        return torch.zeros_like(adm.park_count)

    @staticmethod
    def _fabric_level(rot: torus_exchange.Rotation):
        """The rotation's per-holder statistics as the rows' per-shard
        ones -> (hops, forwarded bytes, bytes on the wire, in-flight peak,
        peaks by phase)."""
        return rot.hops, rot.bytes, rot.owire, rot.in_flight, \
            rot.in_flight_phase

    @staticmethod
    def _dwell(dwell_row: torch.Tensor) -> torch.Tensor:
        """Per-shard queueing dwell: the sum over destinations."""
        return dwell_row.sum(-1)

    @staticmethod
    def _uncredited_in_fabric(state, zero: torch.Tensor) -> torch.Tensor:
        """Events an uncredited window reports in the fabric: none."""
        return zero

    def _by_hop(self, hop: torch.Tensor, weight: torch.Tensor):
        """(S, *, S) int32 weights -> (S, *, max_hops) hop histograms."""
        H = self.max_hops
        return torch.zeros(hop.shape[:-1] + (H,), dtype=torch.int32,
                           device=hop.device).scatter_add_(
            -1, torch.clamp(hop, 0, H - 1).long(), weight)

    # -- the full window ---------------------------------------------------
    def exchange(self, state: base.LinkState, payload: torch.Tensor,
                 counts: torch.Tensor, *,
                 enforce_credits: bool = True) -> base.TransportOut:
        """Ship one window: ``payload`` (S, S, W) and ``counts`` (S, S)
        (a subclass's rows (S, *, S), through the layout hooks above);
        credited, the admission replay decides which rows ship, park or
        wait, and the rows shipped ride the rotation."""
        n = self.n_shards
        device = payload.device
        t = self._dev(device)
        is_local = self._pairs(t["eye"])
        counts = counts.to(torch.int32)
        lead = counts.shape[:-1]                  # the per-shard statistics
        zero_w = torch.zeros((), dtype=payload.dtype, device=device)
        down = state.link_down       # this window's fault mask, or None
        throttled = enforce_credits and self.link_credits > 0
        if down is not None and not throttled:
            raise ValueError(
                "fault injection (FabricState.link_down) requires credit "
                "flow control: an uncredited window has no per-link "
                "admission to refuse at a dead link (set link_credits > 0 "
                "and enforce_credits)")
        if throttled:
            self._check_buffer(state, payload)
            # the reference replicates the counts with a ring all-gather
            # whose hops enter no LinkStats counter; on one card the matrix
            # is global already
            adm = self._admit(state, self._rows(counts), down)
            fresh_c = self._rows(adm.fresh_complete)
            fresh_p = self._rows(adm.fresh_park)
            resumed = self._rows(adm.resumed_complete)
            stall_hop = self._rows(adm.stall_hop)
            pc0 = self._rows(state.parked_count)
            # fresh completions ship the caller's payload, resumed rows
            # the fabric's custody copy (a fresh row behind a parked one
            # is deferred, so the two never share a slot)
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
                parked_hold_shared=self._hold_shared(adm))
            sent_mask = fresh_c | fresh_p | is_local | (counts == 0)
            sent_now = fresh_c | is_local | (counts == 0)
            queue_us = wire_latency.queueing_latency_us(
                self.wire_fmt, adm.queue_events)
            # park dwell: per window parked, one link credit budget drained
            # ahead of the row
            park_wait_us = wire_latency.queueing_latency_us(
                self.wire_fmt, adm.resume_age * self.link_credits)
        else:
            stall_hop = torch.full_like(counts, -1)
            cnt_in, row_payload = counts, payload
            state = state._replace(bank=fc.credit_tick(
                state.bank, torch.zeros_like(state.bank.credits)),
                link_down=None)
            sent_mask = sent_now = torch.ones_like(counts, dtype=torch.bool)
            queue_us = park_wait_us = torch.zeros(
                (*lead[1:], n, n), dtype=torch.float32, device=device)
        rot, recv_payload, recv_counts = self._ship(row_payload, cnt_in, down)

        # deferred rows histogrammed by their blocking hop, parked rows by
        # the hop they wait at
        stalled_by_hop = self._by_hop(
            stall_hop, torch.where(stall_hop >= 0, counts, 0))
        offered = counts.sum(-1, dtype=torch.int32)
        zi = torch.zeros(lead, dtype=torch.int32, device=device)
        hops, fwd_bytes, rot_owire, in_flight, in_flight_phase = \
            self._fabric_level(rot)
        if throttled:
            sent = torch.where(sent_now, counts, 0).sum(-1, dtype=torch.int32)
            parked = torch.where(fresh_p, counts, 0).sum(-1,
                                                         dtype=torch.int32)
            unparked_now = torch.where(resumed, pc0, 0)
            unparked = unparked_now.sum(-1, dtype=torch.int32)
            pk_cnt = self._rows(state.parked_count)
            parked_by_hop = self._by_hop(self._rows(state.parked_hop), pk_cnt)
            # each row pays one frame train per link it crossed this
            # window, so a route is counted once across park and resume
            c_row = torch.where(resumed, pc0, counts)
            owire = (wire_framing.frame_bytes(self.wire_fmt, c_row)
                     * self._rows(adm.links_traversed)).sum(
                         -1, dtype=torch.int32)
            dwell = self._dwell(torch.where(
                fresh_c | resumed, self._rows(queue_us + park_wait_us), 0.0))
            in_fabric = pk_cnt.sum(-1, dtype=torch.int32)
            rerouted = self._rows(adm.rerouted).sum(-1, dtype=torch.int32)
        else:
            sent = cnt_in.sum(-1, dtype=torch.int32)
            parked = unparked = rerouted = zi
            in_fabric = self._uncredited_in_fabric(state, zi)
            unparked_now = torch.zeros_like(counts)
            parked_by_hop = torch.zeros(lead + (self.max_hops,),
                                        dtype=torch.int32, device=device)
            owire = rot_owire
            dwell = torch.zeros(lead, dtype=torch.float32, device=device)
        stats = base.LinkStats(
            offered_events=offered,
            sent_events=sent,
            deferred_events=offered - sent - parked,
            delivered_events=rot.delivered,
            credit_stalls=(stall_hop >= 0).sum(-1, dtype=torch.int32),
            hops=hops,
            forwarded_bytes=fwd_bytes,
            bytes_on_wire=owire,
            max_in_flight=in_flight,
            stalled_by_hop=stalled_by_hop,
            max_in_flight_by_phase=in_flight_phase,
            parked_events=parked,
            unparked_events=unparked,
            in_fabric_events=in_fabric,
            parked_by_hop=parked_by_hop,
            queue_dwell_us=dwell.to(torch.float32),
            rerouted=rerouted,
            stalled_by_link=self._stall_rows(adm if throttled else None),
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
            links_used=adm.links_done if down is not None else None,
        )

    @staticmethod
    def _check_buffer(state, payload: torch.Tensor):
        if state.parked_payload.shape != payload.shape:
            raise ValueError(
                f"FabricState payload buffer "
                f"{tuple(state.parked_payload.shape)} != offered payload "
                f"{tuple(payload.shape)}: initialize with "
                f"init_state(payload_width=W) so parked rows keep custody "
                f"of their wire words")

    def _stall_rows(self, adm):
        """The admission's (K,) stall table as every shard's copy (a view),
        or None: attribution off, or no credited admission ran."""
        if adm is None or adm.stalled_by_link is None:
            return None
        return adm.stalled_by_link.expand(self.n_shards, -1)

    # -- end-of-run fabric walk --------------------------------------------
    def drain_fabric(self, state: base.LinkState,
                     payload_width: int | None = None) -> base.TransportOut:
        """Deliver every parked row from its blocked hop, credits ignored
        (the end-of-run flush quiesces the fabric), releasing every held
        credit into its slot's delay line; the returned tables are empty.
        Each row's bytes on wire count only its remaining links, so a route
        is still counted once across its lifetime."""
        if state.parked_count.numel() == 0:    # unthrottled: nothing parked
            return super().drain_fabric(state, payload_width)
        device = state.parked_count.device
        pc, ph = self._rows(state.parked_count), self._rows(state.parked_hop)
        payload = torch.where((pc > 0)[..., None], state.parked_payload,
                              torch.zeros((), dtype=torch.int32,
                                          device=device))
        rot, recv_payload, recv_counts = self._ship(payload, pc)
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
        remaining_links = torch.clamp(
            self._pairs(self._dev(device)["hops"]) - ph, min=0)
        owire = (wire_framing.frame_bytes(self.wire_fmt, pc)
                 * torch.where(pc > 0, remaining_links, 0)).sum(
                     -1, dtype=torch.int32)
        hops, fwd_bytes, _, in_flight, in_flight_phase = \
            self._fabric_level(rot)
        stats = base.zero_link_stats(pc.shape[:-1], self.max_hops,
                                     self.ndim, device=device)._replace(
            delivered_events=rot.delivered,
            unparked_events=pc.sum(-1, dtype=torch.int32),
            hops=hops,
            forwarded_bytes=fwd_bytes,
            bytes_on_wire=owire,
            max_in_flight=in_flight,
            max_in_flight_by_phase=in_flight_phase)
        zf = torch.zeros(state.parked_count.shape, dtype=torch.float32,
                         device=device)
        full = torch.ones_like(pc, dtype=torch.bool)
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


class Torus2DTransport(TorusTransport):
    """(nx, ny) torus: the per-wafer concentrator face (2x4 for 8)."""

    name = "torus2d"

    def __init__(self, n_shards: int, *, nx: int = 0, ny: int = 0,
                 link_credits: int = 0, notify_latency: int = 2,
                 max_row_events: int = 0,
                 wire_format: str | wire_framing.WireFormat = "extoll",
                 stall_attribution: bool = False):
        if not nx and not ny:
            nx, ny = default_shape(n_shards)
        elif not ny:
            ny = n_shards // max(nx, 1)
        elif not nx:
            nx = n_shards // max(ny, 1)
        super().__init__(n_shards, (nx, ny), link_credits=link_credits,
                         notify_latency=notify_latency,
                         max_row_events=max_row_events,
                         wire_format=wire_format,
                         stall_attribution=stall_attribution)
        self.nx, self.ny = nx, ny


class Torus3DTransport(TorusTransport):
    """(nx, ny, nz) torus: wafer faces stacked along the Z (wafer) axis,
    the paper's full Extoll arrangement (``core.torus.wafer_topology``)."""

    name = "torus3d"

    def __init__(self, n_shards: int, *, nx: int = 0, ny: int = 0,
                 nz: int = 0, link_credits: int = 0, notify_latency: int = 2,
                 max_row_events: int = 0,
                 wire_format: str | wire_framing.WireFormat = "extoll",
                 stall_attribution: bool = False):
        known = [d for d in (nx, ny, nz) if d]
        if not known:
            nx, ny, nz = default_shape3d(n_shards)
        elif len(known) == 1:
            # one axis pinned (typically nz = wafer count): most-square
            # factorization of the rest onto the remaining face
            rest = n_shards // known[0]
            if nz:
                nx, ny = default_shape(rest)
            elif ny:
                nx, nz = default_shape(rest)
            else:
                ny, nz = default_shape(rest)
        elif len(known) == 2:
            missing = n_shards // max(math.prod(known), 1)
            nx, ny, nz = (nx or missing, ny or missing, nz or missing)
        super().__init__(n_shards, (nx, ny, nz), link_credits=link_credits,
                         notify_latency=notify_latency,
                         max_row_events=max_row_events,
                         wire_format=wire_format,
                         stall_attribution=stall_attribution)
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
    ``queue_us``, ``park_wait_us``, ``links_used``) are (T, S, S) [tenant,
    src, dst].  Fabric-wide statistics with no per-tenant decomposition
    (hops, forwarded bytes, in-flight peaks; bytes on the wire of an
    uncredited window) go to tenant 0, so sums over tenants stay physical.
    On the wire each tenant's sub-row of a bundle is its own frame train.
    """

    name = "torus_tenant"

    def __init__(self, n_shards: int, dims: tuple[int, ...], *,
                 partition: fc.CreditPartition, notify_latency: int = 2,
                 max_row_events: int = 0,
                 wire_format: str | wire_framing.WireFormat = "extoll",
                 stall_attribution: bool = False):
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
                         wire_format=wire_format,
                         stall_attribution=stall_attribution)
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
                       counts_all: torch.Tensor,
                       link_down: torch.Tensor | None = None
                       ) -> admission.TenantAdmissionOut:
        """The replay over the T n² rows of ``counts_all`` (T, S, S): kernel
        F's tenant form on the card; on the CPU
        ``admission.admission_tenants_plain``, healthy or under a (K,)
        dead-link mask; with ``stall_attribution`` it carries
        ``stalled_by_link`` over the physical links."""
        return admission.admission_tenants(
            counts_all.to(torch.int32).contiguous(), state,
            self._dev(counts_all.device)["routes"], link_down,
            stall_lane=self.stall_attribution)

    # -- the window's layout: rows (S, T, S), [src, tenant, dst] ----------
    _admit = _admit_tenants

    @staticmethod
    def _rows(x: torch.Tensor) -> torch.Tensor:
        """(T, S, S) [tenant, src, dst] <-> each source's (S, T, S) rows
        (the reference all-gathers every shard's (T, S) counts; on one card
        that is a transpose)."""
        return x.transpose(0, 1).contiguous()

    @staticmethod
    def _pairs(x: torch.Tensor) -> torch.Tensor:
        return x[:, None, :]

    @staticmethod
    def _hold_shared(adm) -> torch.Tensor:
        return adm.hold_shared

    def _fabric_level(self, rot: torus_exchange.Rotation):
        """Fabric-wide (non-decomposable) stats, (S,) per holder, put on
        tenant 0 so sums over tenants stay physical -> (S, T) each and
        (S, T, ndim)."""
        n, T = self.n_shards, self.n_tenants

        def on0(v):
            out = torch.zeros((n, T) + v.shape[1:], dtype=torch.int32,
                              device=v.device)
            out[:, 0] = v
            return out

        return (on0(rot.hops), on0(rot.bytes), on0(rot.owire),
                on0(rot.in_flight), on0(rot.in_flight_phase))

    @staticmethod
    def _dwell(dwell_row: torch.Tensor) -> torch.Tensor:
        """Summed from the first destination to the last, the order kernel
        H adds in."""
        dwell = dwell_row[..., 0]
        for d in range(1, dwell_row.shape[-1]):
            dwell = dwell + dwell_row[..., d]
        return dwell

    def _uncredited_in_fabric(self, state, zero: torch.Tensor):
        """The rows still parked (the reference reports them)."""
        return self._rows(state.parked_count).sum(-1, dtype=torch.int32)

    def _ship(self, row_payload: torch.Tensor, cnt: torch.Tensor,
              down: torch.Tensor | None = None):
        """Rotate the (S, T, S) [src, tenant, dst] counts with one count
        column per tenant and deliver the rows -> (rotation with
        ``delivered`` (S, T), recv_payload (S, T, S, W), recv_counts
        (S, T, S))."""
        rot = self._rotate(cnt.permute(0, 2, 1), down)
        recv = base.pack_payload(row_payload, cnt).permute(2, 1, 0, 3)
        recv_payload, recv_counts = base.unpack_payload(recv.contiguous())
        return rot, recv_payload, recv_counts

    # -- the full multi-tenant window --------------------------------------
    def exchange(self, state: base.LinkState, payload: torch.Tensor,
                 counts: torch.Tensor, *,
                 enforce_credits: bool = True) -> base.TransportOut:
        """Ship one window for every tenant: ``payload`` (S, T, S, W),
        ``counts`` (S, T, S); see the class docstring for the result.
        Healthy and credited on the card: :meth:`_exchange_card`; on the
        CPU, under a mask or uncredited: the window of
        :class:`TorusTransport` on these rows."""
        T, n = self.n_tenants, self.n_shards
        if tuple(payload.shape[:3]) != (n, T, n) or tuple(
                counts.shape) != (n, T, n):
            raise ValueError(
                f"tenant transport wants payload (S={n}, T={T}, S, W) and "
                f"counts (S, T, S); got {tuple(payload.shape)} / "
                f"{tuple(counts.shape)}")
        if enforce_credits and state.link_down is None and dispatch.on_cuda(
                payload):
            self._check_buffer(state, payload)
            return self._exchange_card(state, payload, counts.to(torch.int32))
        return super().exchange(state, payload, counts,
                                enforce_credits=enforce_credits)

    def _exchange_card(self, state: base.FabricState, payload: torch.Tensor,
                       counts: torch.Tensor) -> base.TransportOut:
        """The healthy credited window on the card in two launches: kernel
        F's tenant form, then kernel H (``kernels.torus_exchange.
        tenant_exchange``) on F's output blocks; every field as the plain
        window gives it."""
        blocks = admission.admission_tenants_blocks(
            counts.transpose(0, 1).contiguous(), state,
            self._dev(payload.device)["routes"],
            stall_lane=self.stall_attribution)
        h = torus_exchange.tenant_exchange(
            counts, payload, state, blocks, dims=self.dims,
            fmt=self.wire_fmt, link_credits=self.link_credits,
            max_hops=self.max_hops)
        adm = admission.tenant_fields(blocks)
        stats = base.LinkStats(
            **{f: getattr(h, f) for f in torus_exchange.SHARD_FIELDS},
            stalled_by_hop=h.stalled_by_hop,
            max_in_flight_by_phase=h.max_in_flight_by_phase,
            parked_by_hop=h.parked_by_hop, queue_dwell_us=h.queue_dwell_us,
            stalled_by_link=self._stall_rows(adm))
        return base.TransportOut(
            state=base.FabricState(
                bank=fc.CreditBank(h.credits, h.pending, h.epoch),
                parked_count=adm.park_count, parked_hop=adm.park_hop,
                parked_age=adm.park_age, parked_by_link=adm.parked_by_link,
                parked_payload=h.parked_payload,
                parked_hold_shared=adm.hold_shared),
            recv_payload=h.recv_payload, recv_counts=h.recv_counts,
            sent_mask=h.sent_mask, stats=stats, sent_now=h.sent_now,
            queue_us=h.queue_us, unparked_now=h.unparked_now,
            park_wait_us=h.park_wait_us)
