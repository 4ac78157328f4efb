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


def _finish(n, rows, flat, res, offer, run, credits, queue_events):
    """Merge the two phases' per-row lists into an :class:`AdmissionOut`."""
    res_c, pc_a, ph_a, age_res, age_a, trav_a, rer_a, done_a = res
    adm_c, adm_p, stall, hp_b, trav_b, rer_b, done_b = offer
    fresh_park = _unrot(rows, adm_p)
    sq = lambda x: x.reshape(n, n)
    i32 = lambda xs: _unrot(rows, xs).to(torch.int32)
    # a freshly parked row enters at age 1
    return AdmissionOut(
        fresh_complete=sq(_unrot(rows, adm_c)),
        fresh_park=sq(fresh_park),
        resumed_complete=sq(_unrot(rows, res_c)),
        resume_age=sq(i32(age_res)),
        stall_hop=sq(i32(stall)),
        park_count=sq(torch.where(fresh_park, flat, i32(pc_a))),
        park_hop=sq(torch.where(fresh_park, i32(hp_b), i32(ph_a))),
        park_age=sq(torch.where(fresh_park, 1, i32(age_a)).to(torch.int32)),
        parked_by_link=run[2].clone(),
        links_traversed=sq(i32(trav_a) + i32(trav_b)),
        spent=credits - run[0],
        notify=run[1].clone(),
        queue_events=queue_events.to(torch.int32).reshape(n, n),
        rerouted=sq(i32(rer_a) + i32(rer_b)),
        links_done=sq(i32(done_a) + i32(done_b)))


def admission_plain(counts, state, tables: RouteTables) -> AdmissionOut:
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
    updated in place.
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
                   queue_events)


def admission_faulted_plain(counts, state, tables: RouteTables,
                            link_down: torch.Tensor) -> AdmissionOut:
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
                   queue_events)


# rows of the kernel's int32 output block, then its bool block, in order
_I32_FIELDS = ("resume_age", "stall_hop", "park_count", "park_hop",
               "park_age", "links_traversed", "queue_events", "rerouted",
               "links_done")
_BOOL_FIELDS = ("fresh_complete", "fresh_park", "resumed_complete")
_LINK_FIELDS = ("spent", "notify", "parked_by_link")


def shared_bytes(n_rows: int, n_links: int) -> int:
    """Shared memory of one launch: four per-link and four per-row int32
    arrays (``csrc/admission.cu``)."""
    return 4 * (4 * n_links + 4 * n_rows)


def _check(name, t, shape, dtype, contiguous):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or (
            contiguous and not t.is_contiguous()):
        raise ValueError(f"admission: {name} must be a "
                         f"{'contiguous ' if contiguous else ''}{dtype} "
                         f"tensor of shape {tuple(shape)}, got a "
                         f"{'' if t.is_contiguous() else 'strided '}"
                         f"{t.dtype} {tuple(t.shape)}")


def admission(counts, state, tables: RouteTables,
              link_down: torch.Tensor | None = None) -> AdmissionOut:
    """Kernel F on CUDA tensors, one launch; on CPU tensors the plain
    replay, healthy (:func:`admission_plain`) or under the mask
    (:func:`admission_faulted_plain`).

    ``counts`` (S, S) int32 rows offered this window; ``state`` the
    window's ``FabricState`` (its bank's credits and epoch, the transit
    tables); ``tables`` the transport's :class:`RouteTables`;
    ``link_down`` None or the (K,) bool dead-link mask.  Operands of
    another type or shape are refused on both paths.
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
            return admission_plain(counts, state, tables)
        return admission_faulted_plain(counts, state, tables, link_down)
    if shared_bytes(R, K) > MAX_SHARED:
        raise ValueError(f"admission: {n} shards need "
                         f"{shared_bytes(R, K)} bytes of shared memory, "
                         f"the kernel has {MAX_SHARED}")
    out_i32 = torch.empty((len(_I32_FIELDS), n, n), dtype=torch.int32,
                          device=counts.device)
    out_bool = torch.empty((len(_BOOL_FIELDS), n, n), dtype=torch.bool,
                           device=counts.device)
    out_links = torch.empty((len(_LINK_FIELDS), K), dtype=torch.int32,
                            device=counts.device)
    dispatch.launch(
        "admission", "repro_admission", counts.data_ptr(),
        state.parked_count.data_ptr(), state.parked_hop.data_ptr(),
        state.parked_age.data_ptr(), state.bank.credits.data_ptr(),
        state.parked_by_link.data_ptr(), state.bank.epoch.data_ptr(),
        tables.seq_alt.data_ptr(), tables.len_alt.data_ptr(),
        tables.seg.data_ptr(),
        None if link_down is None else link_down.data_ptr(),
        out_i32.data_ptr(), out_bool.data_ptr(), out_links.data_ptr(),
        n, ndim, H2, Hs)
    fields = dict(zip(_I32_FIELDS, out_i32))
    fields.update(zip(_BOOL_FIELDS, out_bool))
    fields.update(zip(_LINK_FIELDS, out_links))
    return AdmissionOut(**fields)
