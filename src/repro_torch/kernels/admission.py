"""The credited torus's admission replay, healthy and faulted, kernel F.

One window of the two-phase admission of ``transport.torus`` (reference:
``src/repro/transport/torus.py`` ``_admit_global`` and
``_admit_global_faulted``, replayed there by ``lax.scan``; no TPU kernel
corresponds to it).  Rows ``(src, dst)`` are taken source-major, the source
order rotated by the credit bank's epoch.  Phase A resumes the rows parked
in the fabric, phase B offers the fresh rows; each row reads the running
per-link credits that the rows before it left, so the replay is a chain.

:func:`admission` launches the hand-written kernel ``csrc/admission.cu``
on CUDA tensors, healthy (``link_down=None``) or under a dead-link mask,
in one launch per window.  On CPU tensors it runs the plain versions,
:func:`admission_plain` (healthy) and :func:`admission_faulted_plain`:
loops over the rows whose body is tensor operations over the route's
hops.  With an all-false mask the faulted replay is the healthy one on
every state a healthy run reaches (no flip, every row routable, and only
a row parked at hop 0, which a healthy run never makes, is evicted).

The tenant form (reference ``_admit_tenants`` and
``_admit_tenants_faulted``) replays T tenants on one fabric whose bank
holds ``(T+1) * K`` credit slots, each tenant's slice of every link and
every link's shared pool: :func:`admission_tenants` launches the same
source's tenant kernel, one launch per window, and runs
:func:`admission_tenants_plain` or :func:`admission_tenants_faulted_plain`
on CPU tensors.  The single-tenant kernel and its loops are untouched by
it.  :func:`admission_tenants_blocks` returns the kernel's packed output
blocks as they are, for kernel H (``kernels/torus_exchange.py``) to read.

With ``stall_lane=True`` both forms also return ``stalled_by_link``, the
window's deferred events per physical egress link (reference
``_stall_attr``): a deferred row's count is blamed on the first hop of
its healthy route, also under a mask, and a local row adds nothing.  The
kernels write it in the same launch; the plain versions compute it from
the replay's ``stall_hop`` (:func:`stall_table`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import dispatch

MAX_HOPS = 32              # one lane of the replaying warp per hop
MAX_SHARED = 227 * 1024    # bytes of shared memory a block may use


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
    rerouted: torch.Tensor          # int32 events delivered via a detour
    links_done: torch.Tensor        # int32 route length (detours included)
                                    #   of rows delivered this window, else 0
    stalled_by_link: torch.Tensor | None = None   # (K,) int32 deferred
                                    #   events per first egress link of the
                                    #   healthy route (``stall_lane``)


class RouteTables(NamedTuple):
    """The static route tables of a credited torus on one device (link id
    = node * 2 * ndim + direction, -1 padded; local rows all -1)."""

    seq_alt: torch.Tensor    # (2^ndim, n², H2) int32 hop-ordered routes:
                             #   combo bit a set = axis a the long way;
                             #   combo 0 is the default route
    len_alt: torch.Tensor    # (2^ndim, n²) int32
    seg: torch.Tensor        # (ndim, 2, n², Hs) int32 each axis segment,
                             #   short arc [.., 0] and long arc [.., 1]


def _rows(n: int, epoch: torch.Tensor, device) -> torch.Tensor:
    """Processing order: source-major, sources rotated by the epoch."""
    r_all = torch.arange(n * n, device=device)
    return ((r_all // n + epoch) % n) * n + r_all % n


def _unrot(rows: torch.Tensor, xs) -> torch.Tensor:
    """Processing order -> row order."""
    x = torch.stack(xs)
    out = torch.empty_like(x)
    out[rows] = x
    return out


def stall_table(stall_hop, counts, first_hop, n_links: int) -> torch.Tensor:
    """(K,) int32 deferred events per physical egress link: each row with
    ``stall_hop >= 0`` adds its count to the first hop of its pair's
    healthy route (``first_hop``, (n²,), -1 for a local pair); rows beyond
    n² (the tenant replay's T n²) map to pair ``row % n²``."""
    stall_hop, counts = stall_hop.reshape(-1), counts.reshape(-1)
    fl = first_hop.repeat(stall_hop.shape[0] // first_hop.shape[0])
    add = torch.where((stall_hop >= 0) & (fl >= 0), counts, 0)
    return torch.zeros(n_links, dtype=torch.int32,
                       device=counts.device).index_add_(
        0, torch.clamp(fl, min=0).long(), add.to(torch.int32))


def _finish(n, rows, flat, res, offer, run, credits, queue_events,
            first_hop=None):
    """Merge the two phases' per-row lists into an :class:`AdmissionOut`
    (with the stall lane when ``first_hop`` is given)."""
    res_c, pc_a, ph_a, age_res, age_a, trav_a, rer_a, done_a = res
    adm_c, adm_p, stall, hp_b, trav_b, rer_b, done_b = offer
    fresh_park = _unrot(rows, adm_p)
    sq = lambda x: x.reshape(n, n)
    i32 = lambda xs: _unrot(rows, xs).to(torch.int32)
    stall_hop = i32(stall)
    # a freshly parked row enters at age 1
    return AdmissionOut(
        fresh_complete=sq(_unrot(rows, adm_c)),
        fresh_park=sq(fresh_park),
        resumed_complete=sq(_unrot(rows, res_c)),
        resume_age=sq(i32(age_res)),
        stall_hop=sq(stall_hop),
        park_count=sq(torch.where(fresh_park, flat, i32(pc_a))),
        park_hop=sq(torch.where(fresh_park, i32(hp_b), i32(ph_a))),
        park_age=sq(torch.where(fresh_park, 1, i32(age_a)).to(torch.int32)),
        parked_by_link=run[2].clone(),
        links_traversed=sq(i32(trav_a) + i32(trav_b)),
        spent=credits - run[0],
        notify=run[1].clone(),
        queue_events=queue_events.to(torch.int32).reshape(n, n),
        rerouted=sq(i32(rer_a) + i32(rer_b)),
        links_done=sq(i32(done_a) + i32(done_b)),
        stalled_by_link=None if first_hop is None else stall_table(
            stall_hop, flat, first_hop, credits.shape[0]))


def admission_plain(counts, state, tables: RouteTables, *,
                    stall_lane: bool = False) -> AdmissionOut:
    """The healthy replay, plain PyTorch (the reference's
    ``_admit_global``).

    **Phase A** -- every parked row tries to resume from its blocked hop
    ``h``: it crosses hops whose links still hold ``count`` credits and
    stops at the first short one.  Reaching the end completes it;
    advancing and blocking again re-parks it at the new hop (its old
    arrival link's hold is released into the delay line, the new one's
    held); not moving keeps its hold.

    **Phase B** -- a fresh row whose (src, dst) slot is free and whose
    source egress link is not head-of-line blocked walks its route the same
    way: complete, or park at the first short hop ``h >= 1``, or, short at
    hop 0, deferred (``stall_hop = 0``), blocking every later row on that
    egress link this window.

    Each phase is a loop over the rows whose body is tensor operations over
    the hops, the running credits, notifies and holds one (3, K) tensor
    updated in place.  ``stall_lane`` adds ``stalled_by_link``.
    """
    n = counts.shape[0]
    seq = tables.seq_alt[0]                          # the default routes
    H = seq.shape[1]
    device = counts.device
    hop_idx = torch.arange(H, device=device)
    idx_all, valid_all = torch.clamp(seq, min=0).long(), seq >= 0
    flat = counts.reshape(-1).to(torch.int32)
    pc0 = state.parked_count.reshape(-1)
    ph0 = state.parked_hop.reshape(-1)
    pa0 = state.parked_age.reshape(-1)
    rows = _rows(n, state.bank.epoch, device)

    # congestion snapshot: events parked along each row's remaining route
    # at window start (a parked row counts from its blocked hop, past its
    # own held events)
    start_hop = torch.where(pc0 > 0, ph0, 0)[:, None]
    queue_events = torch.where(
        valid_all & (hop_idx >= start_hop),
        state.parked_by_link[idx_all], 0).sum(-1, dtype=torch.int32)

    # per-row operands in processing order
    idx_p, valid_p = idx_all[rows], valid_all[rows]
    first_p, routed_p = idx_all[rows, 0], valid_all[rows, 0]
    c_p, a_p, f_p = pc0[rows], pa0[rows], flat[rows]
    h_p, len_p = ph0[rows].long(), tables.len_alt[0][rows].long()
    run = torch.stack([state.bank.credits,
                       torch.zeros_like(state.bank.credits),
                       state.parked_by_link])
    remaining = run[0]
    zero = torch.zeros((), dtype=torch.int32, device=device)

    res = tuple([] for _ in range(8))
    for i in range(n * n):                           # phase A: resume
        c, h, idx, valid, L = c_p[i], h_p[i], idx_p[i], valid_p[i], len_p[i]
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
        for out, x in zip(res, (
                complete, torch.where(complete, zero, c),
                torch.where(parked_on, h_stop, zero),
                torch.where(complete, a_p[i], zero),
                torch.where(parked_on, a_p[i] + 1, zero),
                trav.sum(dtype=torch.int32), zero,
                torch.where(complete, L, zero))):
            out.append(x)

    blocked = torch.zeros(run.shape[1], dtype=torch.int32, device=device)
    offer = tuple([] for _ in range(7))
    minus_one = torch.full((), -1, dtype=torch.int32, device=device)
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
        h_stop = torch.where(admit_c, L, torch.where(admit_p, h_block, zero))
        trav = valid & (hop_idx < h_stop)
        at_hold = admit_p & (hop_idx == h_stop - 1)
        cc = torch.where(trav, c, zero)
        hold = torch.where(at_hold, c, zero)
        run.index_add_(1, idx, torch.stack([-cc, cc - hold, hold]))
        blocked.index_add_(0, fl, defer.to(torch.int32)[None])
        for out, x in zip(offer, (
                admit_c, admit_p, torch.where(defer, zero, minus_one),
                h_stop, trav.sum(dtype=torch.int32), zero,
                torch.where(admit_c, L, zero))):
            out.append(x)
    return _finish(n, rows, flat, res, offer, run, state.bank.credits,
                   queue_events, seq[:, 0] if stall_lane else None)


def admission_faulted_plain(counts, state, tables: RouteTables,
                            link_down: torch.Tensor, *,
                            stall_lane: bool = False) -> AdmissionOut:
    """The replay under a (K,) bool dead-link mask, plain PyTorch (the
    reference's ``_admit_global_faulted``).  The healthy replay with three
    rules on top:

    * **Reroute**: per row and axis, if the short arc crosses a dead link
      and the long arc is clean the axis walks the long way
      (``seq_alt``); dead both ways makes the row unroutable this window
      (deferred without blocking its egress link).
    * **Eviction**: a parked row whose remaining default route touches a
      dead link, whose held arrival link died, or that sits at hop 0 from
      a failed retry gives up its progress: its hold is released and it
      retries from hop 0 on its detour route in phase A.  A failed retry
      leaves it parked at hop 0 holding nothing.
    * **All-or-nothing detours**: a row on a detour (combo != 0) completes
      or stays put; only rows on the default route park mid-route.

    ``stall_lane`` adds ``stalled_by_link``, blamed on the healthy route.
    """
    n = counts.shape[0]
    device = counts.device
    seq0 = tables.seq_alt[0]                         # default route, H2
    H2 = seq0.shape[1]
    ndim = tables.seg.shape[0]
    hop_idx = torch.arange(H2, device=device)
    flat = counts.reshape(-1).to(torch.int32)
    pc0 = state.parked_count.reshape(-1)
    ph0 = state.parked_hop.reshape(-1)
    pa0 = state.parked_age.reshape(-1)
    r_all = torch.arange(n * n, device=device)
    rows = _rows(n, state.bank.epoch, device)
    down = link_down.to(torch.bool)
    gather = lambda s: down[torch.clamp(s, min=0).long()] & (s >= 0)

    # per-pair reroute decision from the window's mask
    seg_dirty = gather(tables.seg).any(-1)           # (ndim, 2, n²)
    flip = seg_dirty[:, 0] & ~seg_dirty[:, 1]
    routable = ~(seg_dirty[:, 0] & seg_dirty[:, 1]).any(0)
    combo = (flip.long() << torch.arange(ndim, device=device)[:, None]).sum(0)
    seq_eff = tables.seq_alt[combo, r_all]           # (n², H2)
    len_eff = tables.len_alt[combo, r_all]
    detour = combo != 0

    # eviction set: parked rows whose remaining default route died, whose
    # held arrival link died, or that sit at hop 0 from a failed retry
    rem_dirty = (gather(seq0) & (hop_idx >= ph0[:, None])).any(-1)
    held_link = seq0.gather(1, torch.clamp(ph0 - 1, min=0)[:, None].long())
    held_dead = (ph0 >= 1) & down[torch.clamp(held_link[:, 0], min=0).long()]
    ev = (pc0 > 0) & ((ph0 == 0) | rem_dirty | held_dead)

    # congestion snapshot over the routes rows will actually take
    seq_q = torch.where((pc0 > 0)[:, None], seq0, seq_eff)
    start_hop = torch.where((pc0 > 0) & ~ev, ph0, 0)[:, None]
    queue_events = torch.where(
        (seq_q >= 0) & (hop_idx >= start_hop),
        state.parked_by_link[torch.clamp(seq_q, min=0).long()], 0).sum(
            -1, dtype=torch.int32)

    # per-row operands in processing order
    p = lambda x: x[rows]
    idx0_p = torch.clamp(p(seq0), min=0).long()
    valid0_p = p(seq0) >= 0
    idx2_p = torch.clamp(p(seq_eff), min=0).long()
    valid2_p = p(seq_eff) >= 0
    # the old park spot: hop h - 1 of the default route
    oh_p = torch.clamp(p(seq0).gather(
        1, torch.clamp(p(ph0) - 1, min=0)[:, None].long()), min=0).long()
    len0_p, len2_p = p(tables.len_alt[0]).long(), p(len_eff).long()
    c_p, h_p, a_p, f_p = p(pc0), p(ph0).long(), p(pa0), p(flat)
    ev_p, rt_p, det_p = p(ev), p(routable), p(detour)
    run = torch.stack([state.bank.credits,
                       torch.zeros_like(state.bank.credits),
                       state.parked_by_link])
    remaining = run[0]
    zero = torch.zeros((), dtype=torch.int32, device=device)
    zeros1 = torch.zeros((1,), dtype=torch.int32, device=device)

    res = tuple([] for _ in range(8))
    for i in range(n * n):                           # phase A: resume
        c, h, e = c_p[i], h_p[i], ev_p[i]
        active = c > 0
        # branch 1: undisturbed resume on the default route
        idx, L = idx0_p[i], len0_p[i]
        from_h = valid0_p[i] & (hop_idx >= h)
        short = from_h & (remaining[idx] < c)
        h_new = torch.where(short, hop_idx, H2).amin()
        act1 = active & ~e
        complete1 = act1 & (h_new >= L)
        h_stop1 = torch.maximum(torch.where(complete1, L, h_new), h)
        moved1 = act1 & (h_stop1 > h)
        trav1 = from_h & (hop_idx < h_stop1) & act1
        hold1 = moved1 & ~complete1 & (hop_idx == h_stop1 - 1)
        # branch 2: evicted retry from hop 0 on the detour route
        idx2, L2 = idx2_p[i], len2_p[i]
        act2 = active & e & rt_p[i]
        short2 = valid2_p[i] & (remaining[idx2] < c)
        h_block = torch.where(short2, hop_idx, H2).amin()
        complete2 = act2 & (h_block >= L2)
        park2 = act2 & ~det_p[i] & (h_block < L2) & (h_block >= 1)
        h_stop2 = torch.where(complete2, L2,
                              torch.where(park2, h_block, 0))
        trav2 = valid2_p[i] & (hop_idx < h_stop2)
        hold2 = park2 & (hop_idx == h_stop2 - 1)
        # leaving (or being evicted from) the old park spot releases its
        # held arrival credit into the delay line; the two branches never
        # both run, and the release may fall on a detour link: all adds
        rel = torch.where((moved1 | (active & e)) & (h >= 1), c, zero)[None]
        cc1, h1 = torch.where(trav1, c, zero), torch.where(hold1, c, zero)
        cc2, h2 = torch.where(trav2, c, zero), torch.where(hold2, c, zero)
        run.index_add_(1, torch.cat([idx, idx2, oh_p[i]]), torch.stack([
            torch.cat([-cc1, -cc2, zeros1]),
            torch.cat([cc1 - h1, cc2 - h2, rel]),
            torch.cat([h1, h2, -rel])]))
        complete = complete1 | complete2
        keep = active & ~complete
        h_keep = torch.where(e, torch.where(park2, h_block, 0), h_stop1)
        for out, x in zip(res, (
                complete, torch.where(complete, zero, c),
                torch.where(keep, h_keep, zero),
                torch.where(complete, a_p[i], zero),
                torch.where(keep, a_p[i] + 1, zero),
                trav1.sum(dtype=torch.int32) + trav2.sum(dtype=torch.int32),
                torch.where(complete2 & det_p[i], c, zero),
                torch.where(complete1, L, zero)
                + torch.where(complete2, L2, zero))):
            out.append(x)

    blocked = torch.zeros(run.shape[1], dtype=torch.int32, device=device)
    offer = tuple([] for _ in range(7))
    minus_one = torch.full((), -1, dtype=torch.int32, device=device)
    for i in range(n * n):                           # phase B: offer
        c, idx, valid, L = f_p[i], idx2_p[i], valid2_p[i], len2_p[i]
        fl = idx[:1]
        has_first = valid[0] & (c > 0)
        routed = has_first & rt_p[i]
        short = valid & (remaining[idx] < c)
        h_block = torch.where(short, hop_idx, H2).amin()
        ok = routed & (c_p[i] <= 0) & (blocked[fl][0] == 0)
        admit_c = ok & (h_block >= L)
        # parking mid-route only on the default route; a detour is
        # all-or-nothing
        admit_p = ok & ~det_p[i] & (h_block < L) & (h_block >= 1)
        defer = has_first & ~admit_c & ~admit_p
        h_stop = torch.where(admit_c, L, torch.where(admit_p, h_block, zero))
        trav = valid & (hop_idx < h_stop)
        at_hold = admit_p & (hop_idx == h_stop - 1)
        cc = torch.where(trav, c, zero)
        hold = torch.where(at_hold, c, zero)
        run.index_add_(1, idx, torch.stack([-cc, cc - hold, hold]))
        # an unroutable row never reaches its egress FIFO, so it cannot
        # head-of-line block the rows behind it
        blocked.index_add_(0, fl, (defer & rt_p[i]).to(torch.int32)[None])
        for out, x in zip(offer, (
                admit_c, admit_p, torch.where(defer, zero, minus_one),
                h_stop, trav.sum(dtype=torch.int32),
                torch.where(admit_c & det_p[i], c, zero),
                torch.where(admit_c, L, zero))):
            out.append(x)
    return _finish(n, rows, flat, res, offer, run, state.bank.credits,
                   queue_events, seq0[:, 0] if stall_lane else None)


# ---------------------------------------------------------------------------
# The tenant form: T tenants on one fabric, credits partitioned per slot.
# ---------------------------------------------------------------------------

class TenantAdmissionOut(NamedTuple):
    """One window's tenant-axis admission replay; (T, S, S) fields are
    [tenant, src, dst], slot fields ``((T+1)*K,)`` (slot ``t*K + l`` is
    tenant t's slice of link l, ``T*K + l`` link l's shared pool)."""

    fresh_complete: torch.Tensor
    fresh_park: torch.Tensor
    resumed_complete: torch.Tensor
    resume_age: torch.Tensor
    stall_hop: torch.Tensor
    park_count: torch.Tensor
    park_hop: torch.Tensor
    park_age: torch.Tensor
    hold_shared: torch.Tensor       # (T, S, S) post-window shared-pool holds
    parked_by_link: torch.Tensor    # ((T+1)*K,) post-window held units
    links_traversed: torch.Tensor
    spent: torch.Tensor             # ((T+1)*K,)
    notify: torch.Tensor            # ((T+1)*K,)
    queue_events: torch.Tensor      # (T, S, S) parked events queued ahead
    rerouted: torch.Tensor          # (T, S, S) events delivered via detour
    links_done: torch.Tensor        # (T, S, S) delivered-route link counts
    stalled_by_link: torch.Tensor | None = None   # (K,) physical links
                                    #   (``stall_lane``)


def _tenant_rows(n: int, T: int, epoch: torch.Tensor, device):
    """Processing order of the T n² rows: a round robin over the combined
    (tenant, source) index ``t * n + s``, rotated by the epoch."""
    r_all = torch.arange(T * n * n, device=device)
    return ((r_all // n + epoch) % (T * n)) * n + r_all % n


def _finish_tenants(T, n, rows, flat, res, offer, run, credits,
                    queue_events, first_hop=None) -> TenantAdmissionOut:
    """Merge the two phases' per-row lists into a TenantAdmissionOut
    (with the stall lane over the physical links when ``first_hop`` is
    given)."""
    res_c, pc_a, ph_a, age_res, age_a, trav_a, hs_a, rer_a, done_a = res
    adm_c, adm_p, stall, hp_b, trav_b, hs_b, rer_b, done_b = offer
    fresh_park = _unrot(rows, adm_p)
    sq = lambda x: x.reshape(T, n, n)
    i32 = lambda xs: _unrot(rows, xs).to(torch.int32)
    stall_hop = i32(stall)
    return TenantAdmissionOut(
        fresh_complete=sq(_unrot(rows, adm_c)),
        fresh_park=sq(fresh_park),
        resumed_complete=sq(_unrot(rows, res_c)),
        resume_age=sq(i32(age_res)),
        stall_hop=sq(stall_hop),
        park_count=sq(torch.where(fresh_park, flat, i32(pc_a))),
        park_hop=sq(torch.where(fresh_park, i32(hp_b), i32(ph_a))),
        park_age=sq(torch.where(fresh_park, 1, i32(age_a)).to(torch.int32)),
        hold_shared=sq(torch.where(fresh_park, i32(hs_b), i32(hs_a))),
        parked_by_link=run[2].clone(),
        links_traversed=sq(i32(trav_a) + i32(trav_b)),
        spent=credits - run[0],
        notify=run[1].clone(),
        queue_events=queue_events.to(torch.int32).reshape(T, n, n),
        rerouted=sq(i32(rer_a) + i32(rer_b)),
        links_done=sq(i32(done_a) + i32(done_b)),
        stalled_by_link=None if first_hop is None else stall_table(
            stall_hop, flat, first_hop, credits.shape[0] // (T + 1)))


def _split(run, slot_r, slot_s, trav, c, zero):
    """Reserved-first draw of ``c`` at every traversed hop: (take_r,
    take_s), read from the running credits before the row's writes."""
    take_r = torch.where(trav, torch.minimum(c, run[0][slot_r]), zero)
    return take_r, torch.where(trav, c - take_r, zero)


def _tenant_operands(counts, state, T, n):
    flat = counts.reshape(-1).to(torch.int32)
    return (flat, state.parked_count.reshape(-1),
            state.parked_hop.reshape(-1), state.parked_age.reshape(-1),
            state.parked_hold_shared.reshape(-1))


def admission_tenants_plain(counts, state, tables: RouteTables, *,
                            stall_lane: bool = False) -> TenantAdmissionOut:
    """The healthy tenant replay, plain PyTorch (the reference's
    ``_admit_tenants``).

    ``counts`` (T, S, S) rows offered this window; ``state`` a partitioned
    ``FabricState`` ((T, S, S) transit tables with ``parked_hold_shared``,
    a bank and ``parked_by_link`` of ``(T+1)*K`` slots).  The single-tenant
    replay with three twists: a link is available to a row of tenant t
    when its slice plus the shared pool cover the count; spends and holds
    split reserved-first over the two slots (a hold's shared part kept per
    row, ``hold_shared``, and refunded to the slot that funded it); the
    head-of-line block is per (tenant, egress link).  The queue snapshot
    reads the held units of the physical links (all slots of a link).
    ``stall_lane`` adds ``stalled_by_link`` over the physical links.
    """
    T, n = counts.shape[0], counts.shape[1]
    R = n * n
    K = state.bank.credits.shape[0] // (T + 1)
    seq = tables.seq_alt[0]
    H = seq.shape[1]
    device = counts.device
    hop_idx = torch.arange(H, device=device)
    idx_all, valid_all = torch.clamp(seq, min=0).long(), seq >= 0
    flat, pc0, ph0, pa0, hs0 = _tenant_operands(counts, state, T, n)
    rows = _tenant_rows(n, T, state.bank.epoch, device)
    pair_all = torch.arange(T * R, device=device) % R

    pbl_phys = state.parked_by_link.reshape(T + 1, K).sum(0)
    start_hop = torch.where(pc0 > 0, ph0, 0)[:, None]
    queue_events = torch.where(
        valid_all[pair_all] & (hop_idx >= start_hop),
        pbl_phys[idx_all[pair_all]], 0).sum(-1, dtype=torch.int32)

    pair_p, t_p = pair_all[rows], (rows // R)[:, None]
    idx_p, valid_p = idx_all[pair_p], valid_all[pair_p]
    slot_r_p, slot_s_p = t_p * K + idx_p, T * K + idx_p
    c_p, a_p, f_p, hs_p = pc0[rows], pa0[rows], flat[rows], hs0[rows]
    h_p, len_p = ph0[rows].long(), tables.len_alt[0][pair_p].long()
    # the old park spot: hop h - 1 of the route, in both of its slots
    oh_p = idx_p.gather(1, torch.clamp(h_p - 1, min=0)[:, None])
    ohs_p = torch.cat([t_p * K + oh_p, T * K + oh_p], dim=1)
    first_p = idx_p[:, 0]
    routed_p, bl_p = valid_p[:, 0], t_p[:, 0] * K + first_p
    run = torch.stack([state.bank.credits,
                       torch.zeros_like(state.bank.credits),
                       state.parked_by_link])
    zero = torch.zeros((), dtype=torch.int32, device=device)

    res = tuple([] for _ in range(9))
    for i in range(T * R):                           # phase A: resume
        c, h, hs, L = c_p[i], h_p[i], hs_p[i], len_p[i]
        sr, ss = slot_r_p[i], slot_s_p[i]
        active = c > 0
        from_h = valid_p[i] & (hop_idx >= h)
        short = from_h & (run[0][sr] + run[0][ss] < c)
        h_new = torch.where(short, hop_idx, H).amin()
        complete = active & (h_new >= L)
        h_stop = torch.maximum(torch.where(complete, L, h_new), h)
        moved = active & (h_stop > h)
        trav = from_h & (hop_idx < h_stop) & active
        take_r, take_s = _split(run, sr, ss, trav, c, zero)
        at_hold = moved & ~complete & (hop_idx == h_stop - 1)
        hold_r = torch.where(at_hold, take_r, zero)
        hold_s = torch.where(at_hold, take_s, zero)
        # departing the old park spot refunds its hold to the slots that
        # funded it
        rel_s = torch.where(moved & (h >= 1), hs, zero)
        rel_r = torch.where(moved & (h >= 1), c, zero) - rel_s
        rel = torch.stack([rel_r, rel_s])
        run.index_add_(1, torch.cat([sr, ss, ohs_p[i]]), torch.stack([
            torch.cat([-take_r, -take_s, torch.zeros_like(rel)]),
            torch.cat([take_r - hold_r, take_s - hold_s, rel]),
            torch.cat([hold_r, hold_s, -rel])]))
        keep = active & ~complete
        for out, x in zip(res, (
                complete, torch.where(complete, zero, c),
                torch.where(keep, h_stop, zero),
                torch.where(complete, a_p[i], zero),
                torch.where(keep, a_p[i] + 1, zero),
                trav.sum(dtype=torch.int32),
                torch.where(keep, torch.where(moved, hold_s.sum(dtype=torch.int32),
                                                 hs), zero),
                zero, torch.where(complete, L, zero))):
            out.append(x)

    blocked = torch.zeros(T * K, dtype=torch.int32, device=device)
    offer = tuple([] for _ in range(8))
    minus_one = torch.full((), -1, dtype=torch.int32, device=device)
    for i in range(T * R):                           # phase B: offer
        c, L = f_p[i], len_p[i]
        sr, ss, valid = slot_r_p[i], slot_s_p[i], valid_p[i]
        bl = bl_p[i:i + 1]
        routed = routed_p[i] & (c > 0)
        short = valid & (run[0][sr] + run[0][ss] < c)
        h_block = torch.where(short, hop_idx, H).amin()
        ok = routed & (c_p[i] <= 0) & (blocked[bl][0] == 0)
        admit_c = ok & (h_block >= L)
        admit_p = ok & (h_block < L) & (h_block >= 1)
        defer = routed & ~admit_c & ~admit_p
        h_stop = torch.where(admit_c, L, torch.where(admit_p, h_block, zero))
        trav = valid & (hop_idx < h_stop)
        take_r, take_s = _split(run, sr, ss, trav, c, zero)
        at_hold = admit_p & (hop_idx == h_stop - 1)
        hold_r = torch.where(at_hold, take_r, zero)
        hold_s = torch.where(at_hold, take_s, zero)
        run.index_add_(1, torch.cat([sr, ss]), torch.stack([
            torch.cat([-take_r, -take_s]),
            torch.cat([take_r - hold_r, take_s - hold_s]),
            torch.cat([hold_r, hold_s])]))
        blocked.index_add_(0, bl, defer.to(torch.int32)[None])
        for out, x in zip(offer, (
                admit_c, admit_p, torch.where(defer, zero, minus_one),
                h_stop, trav.sum(dtype=torch.int32),
                hold_s.sum(dtype=torch.int32), zero,
                torch.where(admit_c, L, zero))):
            out.append(x)
    return _finish_tenants(T, n, rows, flat, res, offer, run,
                           state.bank.credits, queue_events,
                           seq[:, 0] if stall_lane else None)


def admission_tenants_faulted_plain(counts, state, tables: RouteTables,
                                    link_down: torch.Tensor, *,
                                    stall_lane: bool = False
                                    ) -> TenantAdmissionOut:
    """The tenant replay under a (K,) bool dead-link mask, plain PyTorch
    (the reference's ``_admit_tenants_faulted``): the fault rules of
    :func:`admission_faulted_plain` (per-pair reroute shared by every
    tenant, eviction back to hop 0, all-or-nothing detours) with the
    reserved-first spending and split hold refunds of
    :func:`admission_tenants_plain`; ``stall_lane`` adds
    ``stalled_by_link``, blamed on the healthy route."""
    T, n = counts.shape[0], counts.shape[1]
    R = n * n
    K = state.bank.credits.shape[0] // (T + 1)
    device = counts.device
    seq0 = tables.seq_alt[0]
    H2 = seq0.shape[1]
    ndim = tables.seg.shape[0]
    hop_idx = torch.arange(H2, device=device)
    flat, pc0, ph0, pa0, hs0 = _tenant_operands(counts, state, T, n)
    rows = _tenant_rows(n, T, state.bank.epoch, device)
    pair_all = torch.arange(T * R, device=device) % R
    down = link_down.to(torch.bool)
    gather = lambda s: down[torch.clamp(s, min=0).long()] & (s >= 0)

    # per-pair reroute decision: the mask is physical, shared by tenants
    r_pair = torch.arange(R, device=device)
    seg_dirty = gather(tables.seg).any(-1)           # (ndim, 2, n²)
    flip = seg_dirty[:, 0] & ~seg_dirty[:, 1]
    routable = ~(seg_dirty[:, 0] & seg_dirty[:, 1]).any(0)
    combo = (flip.long() << torch.arange(ndim, device=device)[:, None]).sum(0)
    seq_eff = tables.seq_alt[combo, r_pair]          # (n², H2)
    len_eff = tables.len_alt[combo, r_pair]
    detour = combo != 0

    # eviction set over the (T, n, n) row tables
    seq0_rows = seq0[pair_all]
    rem_dirty = (gather(seq0_rows) & (hop_idx >= ph0[:, None])).any(-1)
    held_link = seq0_rows.gather(1, torch.clamp(ph0 - 1, min=0)[:, None]
                                 .long())[:, 0]
    held_dead = (ph0 >= 1) & down[torch.clamp(held_link, min=0).long()]
    ev = (pc0 > 0) & ((ph0 == 0) | rem_dirty | held_dead)

    # congestion snapshot over the physical links of the actual routes
    pbl_phys = state.parked_by_link.reshape(T + 1, K).sum(0)
    seq_q = torch.where((pc0 > 0)[:, None], seq0_rows, seq_eff[pair_all])
    start_hop = torch.where((pc0 > 0) & ~ev, ph0, 0)[:, None]
    queue_events = torch.where(
        (seq_q >= 0) & (hop_idx >= start_hop),
        pbl_phys[torch.clamp(seq_q, min=0).long()], 0).sum(
            -1, dtype=torch.int32)

    # per-row operands in processing order
    pair_p, t_p = pair_all[rows], (rows // R)[:, None]
    idx0_p = torch.clamp(seq0[pair_p], min=0).long()
    valid0_p = seq0[pair_p] >= 0
    idx2_p = torch.clamp(seq_eff[pair_p], min=0).long()
    valid2_p = seq_eff[pair_p] >= 0
    sr0_p, ss0_p = t_p * K + idx0_p, T * K + idx0_p
    sr2_p, ss2_p = t_p * K + idx2_p, T * K + idx2_p
    c_p, h_p, a_p, f_p = pc0[rows], ph0[rows].long(), pa0[rows], flat[rows]
    hs_p = hs0[rows]
    oh_p = idx0_p.gather(1, torch.clamp(h_p - 1, min=0)[:, None])
    ohs_p = torch.cat([t_p * K + oh_p, T * K + oh_p], dim=1)
    len0_p = tables.len_alt[0][pair_p].long()
    len2_p = len_eff[pair_p].long()
    ev_p, rt_p, det_p = ev[rows], routable[pair_p], detour[pair_p]
    bl_p = t_p[:, 0] * K + idx2_p[:, 0]
    run = torch.stack([state.bank.credits,
                       torch.zeros_like(state.bank.credits),
                       state.parked_by_link])
    zero = torch.zeros((), dtype=torch.int32, device=device)

    res = tuple([] for _ in range(9))
    for i in range(T * R):                           # phase A: resume
        c, h, hs, e = c_p[i], h_p[i], hs_p[i], ev_p[i]
        active = c > 0
        # branch 1: undisturbed resume on the default route
        sr, ss, L = sr0_p[i], ss0_p[i], len0_p[i]
        from_h = valid0_p[i] & (hop_idx >= h)
        short = from_h & (run[0][sr] + run[0][ss] < c)
        h_new = torch.where(short, hop_idx, H2).amin()
        act1 = active & ~e
        complete1 = act1 & (h_new >= L)
        h_stop1 = torch.maximum(torch.where(complete1, L, h_new), h)
        moved1 = act1 & (h_stop1 > h)
        trav1 = from_h & (hop_idx < h_stop1) & act1
        take_r1, take_s1 = _split(run, sr, ss, trav1, c, zero)
        hold1 = moved1 & ~complete1 & (hop_idx == h_stop1 - 1)
        # branch 2: evicted retry from hop 0 on the detour route (the
        # branches never both run, so both read the same credits)
        sr2, ss2, L2 = sr2_p[i], ss2_p[i], len2_p[i]
        act2 = active & e & rt_p[i]
        short2 = valid2_p[i] & (run[0][sr2] + run[0][ss2] < c)
        h_block = torch.where(short2, hop_idx, H2).amin()
        complete2 = act2 & (h_block >= L2)
        park2 = act2 & ~det_p[i] & (h_block < L2) & (h_block >= 1)
        h_stop2 = torch.where(complete2, L2,
                              torch.where(park2, h_block, 0))
        trav2 = valid2_p[i] & (hop_idx < h_stop2)
        take_r2, take_s2 = _split(run, sr2, ss2, trav2, c, zero)
        hold2 = park2 & (hop_idx == h_stop2 - 1)
        # leaving (or being evicted from) the old park spot refunds its
        # hold, split as it was funded; the release may share a link with
        # the detour: all adds
        release = (moved1 | (active & e)) & (h >= 1)
        rel_s = torch.where(release, hs, zero)
        rel = torch.stack([torch.where(release, c, zero) - rel_s, rel_s])
        hr1, hs1 = (torch.where(hold1, take_r1, zero),
                    torch.where(hold1, take_s1, zero))
        hr2, hs2 = (torch.where(hold2, take_r2, zero),
                    torch.where(hold2, take_s2, zero))
        run.index_add_(1, torch.cat([sr, ss, sr2, ss2, ohs_p[i]]),
                       torch.stack([
                           torch.cat([-take_r1, -take_s1, -take_r2,
                                      -take_s2, torch.zeros_like(rel)]),
                           torch.cat([take_r1 - hr1, take_s1 - hs1,
                                      take_r2 - hr2, take_s2 - hs2, rel]),
                           torch.cat([hr1, hs1, hr2, hs2, -rel])]))
        complete = complete1 | complete2
        keep = active & ~complete
        h_keep = torch.where(e, torch.where(park2, h_block, 0), h_stop1)
        hs_keep = torch.where(e, torch.where(park2, hs2.sum(dtype=torch.int32), zero),
            torch.where(moved1, hs1.sum(dtype=torch.int32), hs))
        for out, x in zip(res, (
                complete, torch.where(complete, zero, c),
                torch.where(keep, h_keep, zero),
                torch.where(complete, a_p[i], zero),
                torch.where(keep, a_p[i] + 1, zero),
                trav1.sum(dtype=torch.int32) + trav2.sum(dtype=torch.int32),
                torch.where(keep, hs_keep, zero),
                torch.where(complete2 & det_p[i], c, zero),
                torch.where(complete1, L, zero)
                + torch.where(complete2, L2, zero))):
            out.append(x)

    blocked = torch.zeros(T * K, dtype=torch.int32, device=device)
    offer = tuple([] for _ in range(8))
    minus_one = torch.full((), -1, dtype=torch.int32, device=device)
    for i in range(T * R):                           # phase B: offer
        c, L, valid = f_p[i], len2_p[i], valid2_p[i]
        sr, ss = sr2_p[i], ss2_p[i]
        bl = bl_p[i:i + 1]
        has_first = valid[0] & (c > 0)
        routed = has_first & rt_p[i]
        short = valid & (run[0][sr] + run[0][ss] < c)
        h_block = torch.where(short, hop_idx, H2).amin()
        ok = routed & (c_p[i] <= 0) & (blocked[bl][0] == 0)
        admit_c = ok & (h_block >= L)
        admit_p = ok & ~det_p[i] & (h_block < L) & (h_block >= 1)
        defer = has_first & ~admit_c & ~admit_p
        h_stop = torch.where(admit_c, L, torch.where(admit_p, h_block, zero))
        trav = valid & (hop_idx < h_stop)
        take_r, take_s = _split(run, sr, ss, trav, c, zero)
        at_hold = admit_p & (hop_idx == h_stop - 1)
        hold_r = torch.where(at_hold, take_r, zero)
        hold_s = torch.where(at_hold, take_s, zero)
        run.index_add_(1, torch.cat([sr, ss]), torch.stack([
            torch.cat([-take_r, -take_s]),
            torch.cat([take_r - hold_r, take_s - hold_s]),
            torch.cat([hold_r, hold_s])]))
        # an unroutable row never reaches its egress FIFO: no block
        blocked.index_add_(0, bl, (defer & rt_p[i]).to(torch.int32)[None])
        for out, x in zip(offer, (
                admit_c, admit_p, torch.where(defer, zero, minus_one),
                h_stop, trav.sum(dtype=torch.int32),
                hold_s.sum(dtype=torch.int32),
                torch.where(admit_c & det_p[i], c, zero),
                torch.where(admit_c, L, zero))):
            out.append(x)
    return _finish_tenants(T, n, rows, flat, res, offer, run,
                           state.bank.credits, queue_events,
                           seq0[:, 0] if stall_lane else None)


# rows of the kernel's int32 output block, then its bool block, in order
_I32_FIELDS = ("resume_age", "stall_hop", "park_count", "park_hop",
               "park_age", "links_traversed", "queue_events", "rerouted",
               "links_done")
_BOOL_FIELDS = ("fresh_complete", "fresh_park", "resumed_complete")
_LINK_FIELDS = ("spent", "notify", "parked_by_link")


_TENANT_I32_FIELDS = _I32_FIELDS + ("hold_shared",)


def shared_bytes(n_rows: int, n_links: int, n_tenants: int = 0, *,
                 stall_lane: bool = False) -> int:
    """Shared memory of one launch (``csrc/admission.cu``) for ``n_rows``
    (src, dst) pairs and ``n_links`` physical links.  Single-tenant
    (``n_tenants`` 0): four per-link and four per-row int32 arrays.  The
    tenant form: three per-slot arrays over ``(T+1) * n_links`` slots, the
    per-(tenant, link) block flags and four arrays over the ``T * n_rows``
    rows.  The stall lane adds one per-link array."""
    lane = n_links if stall_lane else 0
    if n_tenants <= 0:
        return 4 * (4 * n_links + 4 * n_rows + lane)
    T = n_tenants
    return 4 * (3 * (T + 1) * n_links + T * n_links + 4 * T * n_rows + lane)


def _check(name, t, shape, dtype, contiguous):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or (
            contiguous and not t.is_contiguous()):
        raise ValueError(f"admission: {name} must be a "
                         f"{'contiguous ' if contiguous else ''}{dtype} "
                         f"tensor of shape {tuple(shape)}, got a "
                         f"{'' if t.is_contiguous() else 'strided '}"
                         f"{t.dtype} {tuple(t.shape)}")


def admission(counts, state, tables: RouteTables,
              link_down: torch.Tensor | None = None, *,
              stall_lane: bool = False) -> AdmissionOut:
    """Kernel F on CUDA tensors, one launch; on CPU tensors the plain
    replay, healthy (:func:`admission_plain`) or under the mask
    (:func:`admission_faulted_plain`).

    ``counts`` (S, S) int32 rows offered this window; ``state`` the
    window's ``FabricState`` (its bank's credits and epoch, the transit
    tables); ``tables`` the transport's :class:`RouteTables`;
    ``link_down`` None or the (K,) bool dead-link mask; ``stall_lane``
    adds ``stalled_by_link`` (in the same launch on the card).  Operands
    of another type or shape are refused on both paths.
    """
    operands = [counts, state.parked_count, state.parked_hop,
                state.parked_age, state.bank.credits, state.bank.epoch,
                state.parked_by_link, *tables]
    if link_down is not None:
        operands.append(link_down)
    cuda = dispatch.on_cuda(*operands)
    n = counts.shape[0]
    R, K = n * n, state.bank.credits.shape[0]
    ndim = tables.seg.shape[0]
    H2, Hs = tables.seq_alt.shape[-1], tables.seg.shape[-1]
    for name, t, shape in (
            ("counts", counts, (n, n)),
            ("parked_count", state.parked_count, (n, n)),
            ("parked_hop", state.parked_hop, (n, n)),
            ("parked_age", state.parked_age, (n, n)),
            ("credits", state.bank.credits, (K,)),
            ("epoch", state.bank.epoch, ()),
            ("parked_by_link", state.parked_by_link, (K,)),
            ("seq_alt", tables.seq_alt, (1 << ndim, R, H2)),
            ("len_alt", tables.len_alt, (1 << ndim, R)),
            ("seg", tables.seg, (ndim, 2, R, Hs))):
        _check(name, t, shape, torch.int32, cuda)
    if link_down is not None:
        _check("link_down", link_down, (K,), torch.bool, cuda)
    if not 1 <= ndim <= 3 or K != n * 2 * ndim or not 1 <= H2 <= MAX_HOPS:
        raise ValueError(
            f"admission: {n} shards, {ndim} axes, {K} links, routes of "
            f"{H2} hops; the replay takes 1..3 axes, 2 * ndim links a "
            f"shard and at most {MAX_HOPS} hops")
    if not cuda:
        if link_down is None:
            return admission_plain(counts, state, tables,
                                   stall_lane=stall_lane)
        return admission_faulted_plain(counts, state, tables, link_down,
                                       stall_lane=stall_lane)
    smem = shared_bytes(R, K, stall_lane=stall_lane)
    if smem > MAX_SHARED:
        raise ValueError(f"admission: {n} shards need {smem} bytes of "
                         f"shared memory, the kernel has {MAX_SHARED}")
    out_i32 = torch.empty((len(_I32_FIELDS), n, n), dtype=torch.int32,
                          device=counts.device)
    out_bool = torch.empty((len(_BOOL_FIELDS), n, n), dtype=torch.bool,
                           device=counts.device)
    out_links = torch.empty((len(_LINK_FIELDS), K), dtype=torch.int32,
                            device=counts.device)
    out_stall = (torch.empty((K,), dtype=torch.int32, device=counts.device)
                 if stall_lane else None)
    dispatch.launch(
        "admission", "repro_admission", counts.data_ptr(),
        state.parked_count.data_ptr(), state.parked_hop.data_ptr(),
        state.parked_age.data_ptr(), state.bank.credits.data_ptr(),
        state.parked_by_link.data_ptr(), state.bank.epoch.data_ptr(),
        tables.seq_alt.data_ptr(), tables.len_alt.data_ptr(),
        tables.seg.data_ptr(),
        None if link_down is None else link_down.data_ptr(),
        out_i32.data_ptr(), out_bool.data_ptr(), out_links.data_ptr(),
        None if out_stall is None else out_stall.data_ptr(), n, ndim, H2, Hs)
    fields = dict(zip(_I32_FIELDS, out_i32))
    fields.update(zip(_BOOL_FIELDS, out_bool))
    fields.update(zip(_LINK_FIELDS, out_links))
    return AdmissionOut(**fields, stalled_by_link=out_stall)


class TenantAdmissionBlocks(NamedTuple):
    """Kernel F's tenant form as its packed output blocks (the fields of
    :class:`TenantAdmissionOut` are their rows)."""

    i32: torch.Tensor               # (10, T, S, S) _TENANT_I32_FIELDS
    bools: torch.Tensor             # (3, T, S, S) _BOOL_FIELDS
    links: torch.Tensor             # (3, (T+1)*K) _LINK_FIELDS
    stall: torch.Tensor | None      # (K,) or None (``stall_lane``)


def tenant_fields(blocks: TenantAdmissionBlocks) -> TenantAdmissionOut:
    """The blocks' rows as a :class:`TenantAdmissionOut` (views)."""
    fields = dict(zip(_TENANT_I32_FIELDS, blocks.i32))
    fields.update(zip(_BOOL_FIELDS, blocks.bools))
    fields.update(zip(_LINK_FIELDS, blocks.links))
    return TenantAdmissionOut(**fields, stalled_by_link=blocks.stall)


def _tenant_checks(counts, state, tables: RouteTables, link_down):
    """Refuse tenant-replay operands of another type or shape -> whether
    they lie on CUDA."""
    operands = [counts, state.parked_count, state.parked_hop,
                state.parked_age, state.parked_hold_shared,
                state.bank.credits, state.bank.epoch, state.parked_by_link,
                *tables]
    if link_down is not None:
        operands.append(link_down)
    cuda = dispatch.on_cuda(*operands)
    if counts.dim() != 3:
        raise ValueError(f"admission_tenants: counts must be (T, S, S), "
                         f"got {tuple(counts.shape)}")
    T, n = counts.shape[0], counts.shape[1]
    R = n * n
    ndim = tables.seg.shape[0]
    K = n * 2 * ndim
    H2, Hs = tables.seq_alt.shape[-1], tables.seg.shape[-1]
    for name, t, shape in (
            ("counts", counts, (T, n, n)),
            ("parked_count", state.parked_count, (T, n, n)),
            ("parked_hop", state.parked_hop, (T, n, n)),
            ("parked_age", state.parked_age, (T, n, n)),
            ("parked_hold_shared", state.parked_hold_shared, (T, n, n)),
            ("credits", state.bank.credits, ((T + 1) * K,)),
            ("epoch", state.bank.epoch, ()),
            ("parked_by_link", state.parked_by_link, ((T + 1) * K,)),
            ("seq_alt", tables.seq_alt, (1 << ndim, R, H2)),
            ("len_alt", tables.len_alt, (1 << ndim, R)),
            ("seg", tables.seg, (ndim, 2, R, Hs))):
        _check(name, t, shape, torch.int32, cuda)
    if link_down is not None:
        _check("link_down", link_down, (K,), torch.bool, cuda)
    if not 1 <= ndim <= 3 or T < 1 or not 1 <= H2 <= MAX_HOPS:
        raise ValueError(
            f"admission_tenants: {T} tenants, {ndim} axes, routes of {H2} "
            f"hops; the replay takes >= 1 tenant, 1..3 axes and at most "
            f"{MAX_HOPS} hops")
    return cuda


def admission_tenants(counts, state, tables: RouteTables,
                      link_down: torch.Tensor | None = None, *,
                      stall_lane: bool = False) -> TenantAdmissionOut:
    """Kernel F's tenant form on CUDA tensors, one launch; on CPU tensors
    the plain replay, healthy (:func:`admission_tenants_plain`) or under
    the mask (:func:`admission_tenants_faulted_plain`).

    ``counts`` (T, S, S) int32; ``state`` a partitioned ``FabricState``
    ((T, S, S) transit tables with ``parked_hold_shared``, ``(T+1)*K``
    bank slots and ``parked_by_link``); ``tables`` the transport's
    :class:`RouteTables`; ``link_down`` None or the (K,) bool mask of the
    physical links; ``stall_lane`` adds ``stalled_by_link`` over the K
    physical links (in the same launch on the card).  Operands of another
    type or shape are refused on both paths.
    """
    if _tenant_checks(counts, state, tables, link_down):
        return tenant_fields(_launch_tenants(counts, state, tables,
                                             link_down, stall_lane))
    if link_down is None:
        return admission_tenants_plain(counts, state, tables,
                                       stall_lane=stall_lane)
    return admission_tenants_faulted_plain(counts, state, tables, link_down,
                                           stall_lane=stall_lane)


def admission_tenants_blocks(counts, state, tables: RouteTables,
                             link_down: torch.Tensor | None = None, *,
                             stall_lane: bool = False
                             ) -> TenantAdmissionBlocks:
    """Kernel F's tenant form as its packed output blocks, which kernel H
    (``kernels.torus_exchange.tenant_exchange``) reads as they are; CUDA
    tensors only (operands as :func:`admission_tenants`)."""
    if not _tenant_checks(counts, state, tables, link_down):
        raise ValueError("admission_tenants_blocks takes CUDA tensors; on "
                         "the CPU call admission_tenants")
    return _launch_tenants(counts, state, tables, link_down, stall_lane)


def _launch_tenants(counts, state, tables, link_down,
                    stall_lane) -> TenantAdmissionBlocks:
    T, n = counts.shape[0], counts.shape[1]
    R = n * n
    ndim = tables.seg.shape[0]
    K = n * 2 * ndim
    H2, Hs = tables.seq_alt.shape[-1], tables.seg.shape[-1]
    smem = shared_bytes(R, K, T, stall_lane=stall_lane)
    if smem > MAX_SHARED:
        raise ValueError(f"admission_tenants: {n} shards and {T} tenants "
                         f"need {smem} bytes of shared memory, the kernel "
                         f"has {MAX_SHARED}")
    out_i32 = torch.empty((len(_TENANT_I32_FIELDS), T, n, n),
                          dtype=torch.int32, device=counts.device)
    out_bool = torch.empty((len(_BOOL_FIELDS), T, n, n), dtype=torch.bool,
                           device=counts.device)
    out_links = torch.empty((len(_LINK_FIELDS), (T + 1) * K),
                            dtype=torch.int32, device=counts.device)
    out_stall = (torch.empty((K,), dtype=torch.int32, device=counts.device)
                 if stall_lane else None)
    dispatch.launch(
        "admission", "repro_admission_tenants", counts.data_ptr(),
        state.parked_count.data_ptr(), state.parked_hop.data_ptr(),
        state.parked_age.data_ptr(), state.parked_hold_shared.data_ptr(),
        state.bank.credits.data_ptr(), state.parked_by_link.data_ptr(),
        state.bank.epoch.data_ptr(), tables.seq_alt.data_ptr(),
        tables.len_alt.data_ptr(), tables.seg.data_ptr(),
        None if link_down is None else link_down.data_ptr(),
        out_i32.data_ptr(), out_bool.data_ptr(), out_links.data_ptr(),
        None if out_stall is None else out_stall.data_ptr(), n, T, ndim, H2,
        Hs)
    return TenantAdmissionBlocks(out_i32, out_bool, out_links, out_stall)
