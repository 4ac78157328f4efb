"""The credited torus's admission replay, healthy, plain PyTorch (frozen
from the port's ``kernels/admission.py``: ``admission_plain`` and
``admission_tenants_plain``, which kernel F and its tenant form match bit
for bit).

Rows ``(src, dst)`` are taken source-major (the tenant form: a round robin
over ``(tenant, source)``), the order rotated by the credit bank's epoch.
Phase A resumes the rows parked in the fabric, phase B offers the fresh
rows; each row reads the running per-link credits that the rows before it
left, so the replay is a chain.  The tenant bank holds ``(T+1) * K``
slots, each tenant's slice of every link and every link's shared pool.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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


class RouteTables(NamedTuple):
    """The static route tables of a credited torus on one device (link id
    = node * 2 * ndim + direction, -1 padded; local rows all -1)."""

    seq: torch.Tensor        # (n², H) int32 hop-ordered default routes
    length: torch.Tensor     # (n²,) int32 their hops


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
    res_c, pc_a, ph_a, age_res, age_a, trav_a = res
    adm_c, adm_p, stall, hp_b, trav_b = offer
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
        queue_events=queue_events.to(torch.int32).reshape(n, n))


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
    seq = tables.seq
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
    h_p, len_p = ph0[rows].long(), tables.length[rows].long()
    run = torch.stack([state.bank.credits,
                       torch.zeros_like(state.bank.credits),
                       state.parked_by_link])
    remaining = run[0]
    zero = torch.zeros((), dtype=torch.int32, device=device)

    res = tuple([] for _ in range(6))
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
                trav.sum(dtype=torch.int32))):
            out.append(x)

    blocked = torch.zeros(run.shape[1], dtype=torch.int32, device=device)
    offer = tuple([] for _ in range(5))
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
                h_stop, trav.sum(dtype=torch.int32))):
            out.append(x)
    return _finish(n, rows, flat, res, offer, run, state.bank.credits,
                   queue_events)


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


def _tenant_rows(n: int, T: int, epoch: torch.Tensor, device):
    """Processing order of the T n² rows: a round robin over the combined
    (tenant, source) index ``t * n + s``, rotated by the epoch."""
    r_all = torch.arange(T * n * n, device=device)
    return ((r_all // n + epoch) % (T * n)) * n + r_all % n


def _finish_tenants(T, n, rows, flat, res, offer, run, credits,
                    queue_events) -> TenantAdmissionOut:
    """Merge the two phases' per-row lists into a TenantAdmissionOut."""
    res_c, pc_a, ph_a, age_res, age_a, trav_a, hs_a = res
    adm_c, adm_p, stall, hp_b, trav_b, hs_b = offer
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
        queue_events=queue_events.to(torch.int32).reshape(T, n, n))


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


def admission_tenants_plain(counts, state,
                            tables: RouteTables) -> TenantAdmissionOut:
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
    """
    T, n = counts.shape[0], counts.shape[1]
    R = n * n
    K = state.bank.credits.shape[0] // (T + 1)
    seq = tables.seq
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
    h_p, len_p = ph0[rows].long(), tables.length[pair_p].long()
    # the old park spot: hop h - 1 of the route, in both of its slots
    oh_p = idx_p.gather(1, torch.clamp(h_p - 1, min=0)[:, None])
    ohs_p = torch.cat([t_p * K + oh_p, T * K + oh_p], dim=1)
    first_p = idx_p[:, 0]
    routed_p, bl_p = valid_p[:, 0], t_p[:, 0] * K + first_p
    run = torch.stack([state.bank.credits,
                       torch.zeros_like(state.bank.credits),
                       state.parked_by_link])
    zero = torch.zeros((), dtype=torch.int32, device=device)

    res = tuple([] for _ in range(7))
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
                                                 hs), zero))):
            out.append(x)

    blocked = torch.zeros(T * K, dtype=torch.int32, device=device)
    offer = tuple([] for _ in range(6))
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
                hold_s.sum(dtype=torch.int32))):
            out.append(x)
    return _finish_tenants(T, n, rows, flat, res, offer, run,
                           state.bank.credits, queue_events)


def _on_host(fn, counts, state, tables):
    """Run a replay on the CPU (a loop of small tensor operations is
    faster there) and return its result on the operands' device."""
    dev = counts.device
    cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x
    host_state = type(state)(*(
        type(f)(*map(cpu, f)) if isinstance(f, tuple) else cpu(f)
        for f in state))
    out = fn(counts.cpu(), host_state, type(tables)(*map(cpu, tables)))
    return type(out)(*(None if x is None else x.to(dev) for x in out))


def admission(counts, state, tables: RouteTables) -> AdmissionOut:
    """The healthy replay, on the CPU."""
    return _on_host(admission_plain, counts, state, tables)


def admission_tenants(counts, state,
                      tables: RouteTables) -> TenantAdmissionOut:
    """The healthy tenant replay, on the CPU."""
    return _on_host(admission_tenants_plain, counts, state, tables)
