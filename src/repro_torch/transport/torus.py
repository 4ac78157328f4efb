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
link for the rest of the window.  The replay is a Python loop over rows
whose body is tensor operations over the route's hops: it stays on the
device and never reads a value back to the host.

Not ported here: fault injection (``_admit_global_faulted``,
``_phase_fault``; ROADMAP queue 1, item 8), the multi-tenant transport
(item 9) and per-link stall attribution for the flight recorder
(``_stall_attr``; item 10).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import aggregator
from repro_torch.core import flow_control as fc
from repro_torch.core.torus import Torus
from repro_torch.kernels import dispatch
from repro_torch.transport import base
from repro_torch.wire import framing as wire_framing
from repro_torch.wire import latency as wire_latency


class AdmissionOut(NamedTuple):
    """One window's admission replay; (S, S) fields are [src, dst]."""

    fresh_complete: torch.Tensor    # bool fresh rows delivered this window
    fresh_park: torch.Tensor        # bool fresh rows newly parked
    resumed_complete: torch.Tensor  # bool parked rows that finished
    resume_age: torch.Tensor        # int32 windows the resumed rows waited
    stall_hop: torch.Tensor         # int32 blocking hop of deferred rows, -1
    park_count: torch.Tensor        # int32 post-window occupancy table
    park_hop: torch.Tensor          # int32 post-window blocked-hop table
    park_age: torch.Tensor          # int32 post-window ages
    parked_by_link: torch.Tensor    # (K,) int32 post-window held units
    links_traversed: torch.Tensor   # int32 links each row crossed now
    spent: torch.Tensor             # (K,) int32 subtracted from credits
    notify: torch.Tensor            # (K,) int32 entering the delay line
    queue_events: torch.Tensor      # int32 parked events ahead on the route


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


def _not_ported(what: str, item: int, topic: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, "
                               f"item {item}: {topic})")


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
                 wire_format: str | wire_framing.WireFormat = "extoll",
                 stall_attribution: bool = False):
        super().__init__(n_shards, wire_format=wire_format)
        if stall_attribution:
            raise _not_ported("per-link stall attribution", 10,
                              "observability")
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
        """Host precompute of every pair's route as hop-ordered egress link
        ids (node * n_links + direction, -1 padded; local rows all -1):
        ``_link_seq`` (n², max_hops), and the host model's hop counts."""
        n, nl = self.n_shards, self.n_links
        self.max_hops = max(sum(d // 2 for d in self.dims), 1)
        seq = np.full((n * n, self.max_hops), -1, np.int32)
        for s in range(n):
            for d in range(n):
                if s == d:
                    continue
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
            seq = torch.from_numpy(self._link_seq).to(device)
            ids = torch.arange(self.n_shards, device=device)
            self._tables[device] = dict(
                idx=torch.clamp(seq, min=0).long(),
                valid=seq >= 0,
                first=torch.clamp(seq[:, 0], min=0).long(),
                routed=seq[:, 0] >= 0,
                route_len=torch.from_numpy(self._route_len).to(device),
                hops=torch.from_numpy(self._hops_matrix).to(device),
                hop_idx=torch.arange(self.max_hops, device=device),
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

    def _stall_attr(self, stall_hop, counts):
        raise _not_ported("per-link stall attribution", 10, "observability")

    def _admit_global_faulted(self, state, counts_all, link_down):
        raise _not_ported("fault-aware admission", 8, "fault injection")

    def _phase_fault(self, down, a: int, me, my_c):
        raise _not_ported("fault detours of the ring phases", 8,
                          "fault injection")

    # -- canonical hop-by-hop admission with transit buffers ---------------
    def _admit_global(self, state: base.FabricState,
                      counts_all: torch.Tensor) -> AdmissionOut:
        """The two-phase admission replay over the global state.

        Rows are processed source-major, the source order rotated by
        ``bank.epoch`` (round-robin over progress rounds).

        **Phase A** -- every parked row tries to resume from its blocked
        hop ``h``: it crosses hops whose links still hold ``count``
        credits and stops at the first short one.  Reaching the end
        completes it; advancing and blocking again re-parks it at the new
        hop (its old arrival link's hold is released into the delay line,
        the new one's held); not moving keeps its hold.

        **Phase B** -- a fresh row whose (src, dst) slot is free and whose
        source egress link is not head-of-line blocked walks its route the
        same way: complete, or park at the first short hop ``h >= 1``, or,
        short at hop 0, deferred (``stall_hop = 0``), blocking every later
        row on that egress link this window.

        Each phase is a loop over the rows whose body is tensor operations
        over the ``max_hops`` hops, with the running credits, notifies and
        holds as one (3, K) tensor updated in place.
        """
        n, H = self.n_shards, self.max_hops
        t = self._dev(counts_all.device)
        hop_idx, idx_all, valid_all = t["hop_idx"], t["idx"], t["valid"]
        flat = counts_all.reshape(-1).to(torch.int32)
        pc0 = state.parked_count.reshape(-1)
        ph0 = state.parked_hop.reshape(-1)
        pa0 = state.parked_age.reshape(-1)
        r_all = torch.arange(n * n, device=flat.device)
        rows = ((r_all // n + state.bank.epoch) % n) * n + r_all % n

        # congestion snapshot: events parked along each row's remaining
        # route at window start (a parked row counts from its blocked hop,
        # past its own held events)
        start_hop = torch.where(pc0 > 0, ph0, 0)[:, None]
        queue_events = torch.where(
            valid_all & (hop_idx >= start_hop),
            state.parked_by_link[idx_all], 0).sum(
                -1, dtype=torch.int32).reshape(n, n)

        # per-row operands in processing order
        idx_p, valid_p = idx_all[rows], valid_all[rows]
        len_p, first_p = t["route_len"][rows], t["first"][rows]
        routed_p = t["routed"][rows]
        c_p, a_p, f_p = pc0[rows], pa0[rows], flat[rows]
        h_p, len_p = ph0[rows].long(), len_p.long()
        # running [remaining credits, notify, held] per link
        run = torch.stack([state.bank.credits,
                           torch.zeros_like(state.bank.credits),
                           state.parked_by_link])
        remaining = run[0]
        zero = torch.zeros((), dtype=torch.int32, device=flat.device)

        res_c, pc_a, ph_a, age_res, age_a, trav_a = ([] for _ in range(6))
        for i in range(n * n):                           # phase A: resume
            c, h, idx, valid, L = c_p[i], h_p[i], idx_p[i], valid_p[i], \
                len_p[i]
            active = c > 0
            from_h = valid & (hop_idx >= h)
            short = from_h & (remaining[idx] < c)
            h_new = torch.where(short, hop_idx, H).amin()
            complete = active & (h_new >= L)
            h_stop = torch.maximum(torch.where(complete, L, h_new), h)
            moved = active & (h_stop > h)
            trav = from_h & (hop_idx < h_stop) & active
            # the last traversed link becomes the new hold when re-parking;
            # leaving the old park spot releases its arrival link's hold
            at_hold = moved & ~complete & (hop_idx == h_stop - 1)
            rel = moved & (h >= 1) & (hop_idx == h - 1)
            cc = torch.where(trav, c, zero)
            hold = torch.where(at_hold, c, zero)
            rel_c = torch.where(rel, c, zero)
            run.index_add_(1, idx, torch.stack([-cc, cc - hold + rel_c,
                                                hold - rel_c]))
            parked_on = active & ~complete
            res_c.append(complete)
            pc_a.append(torch.where(complete, zero, c))
            ph_a.append(torch.where(parked_on, h_stop, zero))
            age_res.append(torch.where(complete, a_p[i], zero))
            age_a.append(torch.where(parked_on, a_p[i] + 1, zero))
            trav_a.append(trav.sum(dtype=torch.int32))

        blocked = torch.zeros(run.shape[1], dtype=torch.int32,
                              device=flat.device)   # deferrals per link
        adm_c, adm_p, stall, hp_b, trav_b = ([] for _ in range(5))
        minus_one = torch.full((), -1, dtype=torch.int32, device=flat.device)
        for i in range(n * n):                           # phase B: offer
            c, idx, valid, L = f_p[i], idx_p[i], valid_p[i], len_p[i]
            fl = first_p[i:i + 1]
            routed = routed_p[i] & (c > 0)
            short = valid & (remaining[idx] < c)
            h_block = torch.where(short, hop_idx, H).amin()
            ok = routed & (c_p[i] <= 0) & (blocked[fl][0] == 0)
            admit_c = ok & (h_block >= L)
            admit_p = ok & (h_block < L) & (h_block >= 1)
            defer = routed & ~admit_c & ~admit_p
            h_stop = torch.where(admit_c, L,
                                 torch.where(admit_p, h_block, zero))
            trav = valid & (hop_idx < h_stop)
            at_hold = admit_p & (hop_idx == h_stop - 1)
            cc = torch.where(trav, c, zero)
            hold = torch.where(at_hold, c, zero)
            run.index_add_(1, idx, torch.stack([-cc, cc - hold, hold]))
            blocked.index_add_(0, fl, defer.to(torch.int32)[None])
            adm_c.append(admit_c)
            adm_p.append(admit_p)
            stall.append(torch.where(defer, zero, minus_one))
            hp_b.append(h_stop)
            trav_b.append(trav.sum(dtype=torch.int32))

        def unrot(xs):              # processing order -> row order
            x = torch.stack(xs)
            out = torch.empty_like(x)
            out[rows] = x
            return out

        fresh_complete, fresh_park = unrot(adm_c), unrot(adm_p)
        resumed_complete = unrot(res_c)
        # a freshly parked row enters at age 1
        park_count = torch.where(fresh_park, flat, unrot(pc_a))
        park_hop = torch.where(fresh_park, unrot(hp_b).to(torch.int32),
                               unrot(ph_a).to(torch.int32))
        park_age = torch.where(fresh_park, 1, unrot(age_a))
        sq = lambda x: x.reshape(n, n)
        return AdmissionOut(
            fresh_complete=sq(fresh_complete),
            fresh_park=sq(fresh_park),
            resumed_complete=sq(resumed_complete),
            resume_age=sq(unrot(age_res)),
            stall_hop=sq(unrot(stall)),
            park_count=sq(park_count),
            park_hop=sq(park_hop),
            park_age=sq(park_age).to(torch.int32),
            parked_by_link=run[2].clone(),
            links_traversed=sq(unrot(trav_a) + unrot(trav_b)),
            spent=state.bank.credits - remaining,
            notify=run[1].clone(),
            queue_events=queue_events,
        )

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
        """(S, S) [holder, row] -> (S, n_a, B) bundles by ring coordinate."""
        perm, _ = self._phase_perm(a)
        t = buf.reshape(buf.shape[0], *reversed(self.dims))
        return t.permute(0, *(1 + p for p in perm)).reshape(
            buf.shape[0], self.dims[a], -1)

    def _from_phase(self, recv: torch.Tensor, a: int) -> torch.Tensor:
        """Inverse layout of :meth:`_to_phase`."""
        _, inv = self._phase_perm(a)
        other = [d for i, d in enumerate(reversed(self.dims))
                 if i != self.ndim - 1 - a]
        t = recv.reshape(recv.shape[0], self.dims[a], *other)
        return t.permute(0, *(1 + p for p in inv)).reshape(
            recv.shape[0], self.n_shards)

    def _neighbour(self, v: torch.Tensor, a: int, step: int) -> torch.Tensor:
        """Every holder passes ``v`` one step along its axis-``a`` ring
        (the reference's ``ppermute``): holder c receives c - step's."""
        s = v.shape
        t = v.reshape(*reversed(self.dims), *s[1:])
        return torch.roll(t, step, dims=self.ndim - 1 - a).reshape(s)

    def _ring_phase(self, bundles: torch.Tensor, a: int, acc: dict):
        """Rotate (S, n, B) bundle counts (by target ring coordinate) to
        their owners -> (S, n, B) by source ring coordinate; ``acc``
        gathers each holder's LinkStats terms: wire bytes of every hop
        (legacy packet model and frame-exact), hops, and the peak
        store-and-forward occupancy after each absorption."""
        t = self._dev(bundles.device)
        n, my_c, ar = self.dims[a], t["coords"][a], t["shards"]
        fwd = (torch.arange(n, device=bundles.device)[None, :]
               - my_c[:, None]) % n
        plus = ((fwd >= 1) & (fwd <= n // 2))[..., None]
        minus = (fwd > n // 2)[..., None]
        zero = torch.zeros((), dtype=bundles.dtype, device=bundles.device)
        recv = torch.zeros_like(bundles)
        recv[ar, my_c] = bundles[ar, my_c]
        flat = lambda v: v.reshape(v.shape[0], -1)
        for step, v, n_hops in ((1, torch.where(plus, bundles, zero), n // 2),
                                (-1, torch.where(minus, bundles, zero),
                                 (n - 1) // 2)):
            for h in range(1, n_hops + 1):
                acc["bytes"] = (acc["bytes"]
                                + aggregator.window_cost(flat(v)).bytes)
                acc["owire"] = acc["owire"] + wire_framing.frame_bytes(
                    self.wire_fmt, flat(v)).sum(-1, dtype=torch.int32)
                v = self._neighbour(v, a, step)
                recv[ar, (my_c - step * h) % n] = v[ar, my_c]
                v = v.clone()
                v[ar, my_c] = 0
                acc["hops"] += 1
                occ = flat(v).sum(-1, dtype=torch.int32)
                acc["in_flight"] = torch.maximum(acc["in_flight"], occ)
                acc["in_flight_phase"][a] = torch.maximum(
                    acc["in_flight_phase"][a], occ)
        return recv

    def _rotate(self, cnt: torch.Tensor):
        """All dimension-ordered phases over the (S, S) [src, dst] counts
        -> (rotation statistics, (S, S) [dst, src] delivered counts)."""
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
            rerouted=zi,                # no fault detours (item 8)
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


class TenantTorusTransport(TorusTransport):
    """Multi-tenant torus with per-tenant credit partitions."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("the multi-tenant torus transport", 9,
                          "the multi-tenant serve engine")
