"""The credited torus's admission replay: kernel F and its plain version.

One window of the two-phase admission of ``transport.torus`` (reference:
``src/repro/transport/torus.py`` ``_admit_global``,
``_admit_global_faulted`` and the tenant forms ``_admit_tenants`` and
``_admit_tenants_faulted``, replayed there by ``lax.scan``; no TPU kernel
corresponds to it).  Phase A resumes the rows parked in the fabric, phase B
offers the fresh rows; each row reads the running per-link credits that
the rows before it left, so the replay is a chain.

:func:`admission` launches the hand-written kernel ``csrc/admission.cu``
on CUDA tensors, healthy (``link_down=None``) or under a dead-link mask,
in one launch per window.  The tenant form replays T tenants on one fabric
whose bank holds ``(T+1) * K`` credit slots, each tenant's slice of every
link and every link's shared pool: :func:`admission_tenants` launches the
same source's tenant kernel, one launch per window, and
:func:`admission_tenants_blocks` returns its packed output blocks as they
are, for kernel H (``kernels/torus_exchange.py``) to read.

On CPU tensors both wrappers run the one plain replay,
:func:`admission_tenants_plain`, healthy or under the mask.  The
single-tenant fabric is its one tenant with reserve 0: :func:`admission`
lifts the operands to that form (K empty slice slots before the K pool
slots, every hold shared) and maps the result back; with nothing reserved
the tenant replay decides every row as the single-tenant reference does.

With ``stall_lane=True`` both forms also return ``stalled_by_link``, the
window's deferred events per physical egress link (reference
``_stall_attr``): a deferred row's count is blamed on the first hop of
its healthy route, also under a mask, and a local row adds nothing.  The
kernels write it in the same launch; the plain replay computes it from
its ``stall_hop`` (:func:`stall_table`).
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


def _tenant_rows(n: int, T: int, epoch: torch.Tensor, device):
    """Processing order of the T n² rows: a round robin over the combined
    (tenant, source) index ``t * n + s``, rotated by the epoch."""
    r_all = torch.arange(T * n * n, device=device)
    return ((r_all // n + epoch) % (T * n)) * n + r_all % n


def admission_tenants_plain(counts, state, tables: RouteTables,
                            link_down: torch.Tensor | None = None, *,
                            stall_lane: bool = False) -> TenantAdmissionOut:
    """The plain replay in PyTorch, on any device (the reference's
    ``_admit_tenants``, under a (K,) bool dead-link mask
    ``_admit_tenants_faulted``).

    ``counts`` (T, S, S) rows offered this window; ``state`` a partitioned
    ``FabricState`` ((T, S, S) transit tables with ``parked_hold_shared``,
    a bank and ``parked_by_link`` of ``(T+1)*K`` slots).  Rows go in a
    round robin over (tenant, source), rotated by the bank's epoch.

    **Phase A** -- every parked row tries to resume from its blocked hop
    ``h``: it crosses hops whose links still cover its count and stops at
    the first short one.  Reaching the end completes it; advancing and
    blocking again re-parks it at the new hop (its old arrival link's hold
    is released into the delay line, the new one held); not moving keeps
    its hold.

    **Phase B** -- a fresh row whose slot is free and whose egress link is
    not head-of-line blocked for its tenant walks its route the same way:
    complete, or park at the first short hop ``h >= 1``, or, short at hop
    0, deferred (``stall_hop = 0``), blocking every later row of its tenant
    on that egress link this window.

    A link covers a row of tenant t when its slice plus the shared pool
    do; spends and holds split reserved-first over the two slots, a hold's
    shared part kept per row (``hold_shared``) and refunded to the slot
    that funded it.  The queue snapshot reads the held units of the
    physical links (all slots of a link).

    Under a mask, three rules on top: per pair and axis, a short arc that
    crosses a dead link walks the long way when that is clean
    (``seq_alt``), and dead both ways leaves the row unroutable this
    window (deferred without blocking its egress link); a parked row whose
    remaining default route touches a dead link, whose held arrival link
    died, or that sits at hop 0 from a failed retry is evicted: its hold
    is released and it retries from hop 0 on its detour route, a failed
    retry leaving it parked at hop 0 holding nothing; a row on a detour
    completes or stays put, only rows on the default route park mid-route.

    Each phase is a loop over the rows with work (phase A: the parked rows;
    phase B: the fresh rows with a route) in processing order, whose body
    is tensor operations over the route's hops; the running credits,
    notifies and holds are one (3, slots) tensor updated in place.  Which
    rows have work, and which are evicted, unroutable or on a detour, is
    read to the host once a window.  ``stall_lane`` adds
    ``stalled_by_link`` over the physical links.
    """
    T, n = counts.shape[0], counts.shape[1]
    R, TR = n * n, counts.numel()
    K = state.bank.credits.shape[0] // (T + 1)
    device = counts.device
    seq0, len0 = tables.seq_alt[0], tables.len_alt[0]   # the default routes
    H = seq0.shape[1]
    hop_idx = torch.arange(H, device=device)
    flat = counts.reshape(-1).to(torch.int32)
    pc0, ph0, pa0, hs0 = (x.reshape(-1) for x in (
        state.parked_count, state.parked_hop, state.parked_age,
        state.parked_hold_shared))
    pair = torch.arange(TR, device=device) % R
    seq0_rows = seq0[pair]
    parked = pc0 > 0
    if link_down is None:
        seq_eff, len_eff = seq0, len0
        routable = torch.ones(R, dtype=torch.bool, device=device)
        detour = ~routable
        evicted = torch.zeros_like(parked)
    else:
        down = link_down.to(torch.bool)
        dead = lambda s: down[torch.clamp(s, min=0).long()] & (s >= 0)
        # per-pair reroute decision: the mask is physical, shared by tenants
        seg_dirty = dead(tables.seg).any(-1)          # (ndim, 2, n²)
        flip = seg_dirty[:, 0] & ~seg_dirty[:, 1]
        routable = ~(seg_dirty[:, 0] & seg_dirty[:, 1]).any(0)
        axes = torch.arange(tables.seg.shape[0], device=device)[:, None]
        combo = (flip.long() << axes).sum(0)
        r_pair = torch.arange(R, device=device)
        seq_eff = tables.seq_alt[combo, r_pair]       # (n², H2)
        len_eff = tables.len_alt[combo, r_pair]
        detour = combo != 0
        rem_dirty = (dead(seq0_rows) & (hop_idx >= ph0[:, None])).any(-1)
        held_link = seq0_rows.gather(
            1, torch.clamp(ph0 - 1, min=0)[:, None].long())[:, 0]
        held_dead = (ph0 >= 1) & down[torch.clamp(held_link, min=0).long()]
        evicted = parked & ((ph0 == 0) | rem_dirty | held_dead)

    # congestion snapshot: events held on the physical links along each
    # row's route at window start (a parked row on its default route from
    # its blocked hop, past its own held events; an evicted one from hop 0)
    pbl_phys = state.parked_by_link.reshape(T + 1, K).sum(0)
    seq_q = torch.where(parked[:, None], seq0_rows, seq_eff[pair])
    start_hop = torch.where(parked & ~evicted, ph0, 0)[:, None]
    queue_events = torch.where(
        (seq_q >= 0) & (hop_idx >= start_hop),
        pbl_phys[torch.clamp(seq_q, min=0).long()], 0).sum(
            -1, dtype=torch.int32)

    # per-row operands in processing order; a hop's two slots are the
    # row's tenant slice and the link's pool
    rows = _tenant_rows(n, T, state.bank.epoch, device)
    pair_p, t_p = pair[rows], (rows // R)[:, None, None]
    offset = torch.cat([t_p * K, torch.full_like(t_p, T * K)], 1)
    slots = lambda s: s[:, None, :] + offset
    seq0_p, seqe_p = seq0[pair_p], seq_eff[pair_p]
    slots0 = slots(torch.clamp(seq0_p, min=0).long())        # (TR, 2, H2)
    slotse = slots(torch.clamp(seqe_p, min=0).long())
    c_p, h_p, a_p, f_p = pc0[rows], ph0[rows].long(), pa0[rows], flat[rows]
    hs_p = hs0[rows]
    # the hops a row may cross: on the default route from its blocked hop,
    # on the route it takes this window from hop 0
    hops0 = (seq0_p >= 0) & (hop_idx >= h_p[:, None])
    hopse = seqe_p >= 0
    len0_p, lene_p = len0[pair_p].long(), len_eff[pair_p].long()
    # the old park spot: hop h - 1 of the default route, in both its slots
    old_p = slots0.gather(2, torch.clamp(h_p - 1, min=0)[:, None, None]
                          .expand(-1, 2, 1))[..., 0]
    # head-of-line blocks are per (tenant, egress link)
    blk_p = t_p[:, 0, 0] * K + torch.clamp(seqe_p[:, 0], min=0).long()
    ev_p, rt_p, det_p = evicted[rows], routable[pair_p], detour[pair_p]
    fresh_p = hopse[:, 0] & (f_p > 0)
    active, ev, rt, det, rel, fresh = torch.stack(
        [c_p > 0, ev_p, rt_p, det_p, h_p >= 1, fresh_p]).tolist()

    run = torch.stack([state.bank.credits,
                       torch.zeros_like(state.bank.credits),
                       state.parked_by_link])
    zero = torch.zeros((), dtype=torch.int32, device=device)

    def walk(slots, hops, c, L, h=0, may_park=True, act=None):
        """``c`` events along the route's ``hops`` (a mask) from hop ``h``:
        cross while a hop's slice and pool cover ``c``, paying
        reserved-first into the delay line; complete at the end, or park
        past ``h`` (``may_park``) holding the last link crossed; ``act``
        False moves nothing -> (complete, park, stop hop, links crossed,
        the hold's shared part)."""
        have = run[0][slots]                          # (2, H2) slice, pool
        short = hops & (have.sum(0) < c)
        h_block = torch.where(short, hop_idx, H).amin()
        complete = h_block >= L
        park = (~complete & (h_block > h) if may_park
                else torch.zeros_like(complete))
        if act is not None:
            complete, park = complete & act, park & act
        h_stop = torch.where(complete, L, torch.where(park, h_block, h))
        trav = hops & (hop_idx < h_stop)
        take_r = torch.where(trav, torch.minimum(c, have[0]), zero)
        take = torch.stack([take_r, torch.where(trav, c - take_r, zero)])
        hold = torch.where(park & (hop_idx == h_stop - 1), take, zero)
        run.index_add_(1, slots.reshape(-1), torch.stack(
            [-take, take - hold, hold]).reshape(3, -1))
        return (complete, park, h_stop, trav.sum(dtype=torch.int32),
                hold[1].sum(dtype=torch.int32))

    res_a = {}
    for i in range(TR):                              # phase A: resume
        if not active[i]:
            continue
        c, hs, moved = c_p[i], hs_p[i], None
        if not ev[i]:
            # from the blocked hop on the default route; not moving keeps
            # the hold
            done, park, stop, crossed, held = walk(
                slots0[i], hops0[i], c, len0_p[i], h_p[i])
            res_a[i] = (done, stop, crossed, torch.where(park, held, hs))
            moved = done | park
        elif rt[i]:
            # evicted: a retry from hop 0 on the detour route (unroutable,
            # it stays parked at hop 0 holding nothing)
            done, _, stop, crossed, held = walk(
                slotse[i], hopse[i], c, lene_p[i], may_park=not det[i])
            res_a[i] = (done, stop, crossed, held)
        if rel[i]:
            # leaving (or being evicted from) the old park spot refunds
            # its hold to the slots that funded it
            refund = torch.stack([c - hs, hs])
            if moved is not None:
                refund = torch.where(moved, refund, zero)
            run.index_add_(1, old_p[i], torch.stack(
                [torch.zeros_like(refund), refund, -refund]))

    blocked = torch.zeros(T * K, dtype=torch.int32, device=device)
    one = torch.ones((1,), dtype=torch.int32, device=device)
    res_b = {}
    for i in range(TR):                              # phase B: offer
        if not fresh[i]:
            continue
        bl = blk_p[i:i + 1]
        if active[i] or not rt[i]:
            # deferred behind the row parked in its slot, or unroutable;
            # an unroutable row never reaches its egress FIFO, so it cannot
            # head-of-line block the rows behind it
            if rt[i]:
                blocked.index_add_(0, bl, one)
            continue
        done, park, stop, crossed, hs_new = walk(
            slotse[i], hopse[i], f_p[i], lene_p[i], may_park=not det[i],
            act=blocked[bl][0] == 0)
        blocked.index_add_(0, bl, (~done & ~park).to(torch.int32)[None])
        res_b[i] = (done, park, stop, crossed, hs_new)

    def column(res, k, dtype):
        """Field ``k`` of the rows with results, 0 / False elsewhere."""
        out = torch.zeros(TR, dtype=dtype, device=device)
        if res:
            out[list(res)] = torch.stack([r[k] for r in res.values()]).to(
                dtype)
        return out

    i32, b8 = torch.int32, torch.bool
    done_a, stop_a, trav_a, hs_a = (column(res_a, k, d) for k, d in
                                    enumerate((b8, i32, i32, i32)))
    done_b, park_b, stop_b, trav_b, hs_b = (column(res_b, k, d) for k, d in
                                            enumerate((b8, b8, i32, i32, i32)))
    keep = (c_p > 0) & ~done_a
    # a freshly parked row enters at age 1
    fields = dict(
        fresh_complete=done_b, fresh_park=park_b, resumed_complete=done_a,
        resume_age=torch.where(done_a, a_p, 0),
        stall_hop=torch.where(fresh_p & ~done_b & ~park_b, 0, -1),
        park_count=torch.where(park_b, f_p, torch.where(done_a, 0, c_p)),
        park_hop=torch.where(park_b, stop_b, torch.where(keep, stop_a, 0)),
        park_age=torch.where(park_b, 1, torch.where(keep, a_p + 1, 0)),
        hold_shared=torch.where(park_b, hs_b, torch.where(keep, hs_a, 0)),
        links_traversed=trav_a + trav_b,
        rerouted=(torch.where(done_a & ev_p & det_p, c_p, 0)
                  + torch.where(done_b & det_p, f_p, 0)),
        links_done=(torch.where(done_a, torch.where(ev_p, lene_p, len0_p), 0)
                    + torch.where(done_b, lene_p, 0)))
    order = torch.empty_like(rows)                   # processing -> row
    order[rows] = torch.arange(TR, device=device)
    fields = {k: v[order].reshape(T, n, n).to(b8 if v.dtype == b8 else i32)
              for k, v in fields.items()}
    return TenantAdmissionOut(
        **fields,
        parked_by_link=run[2].clone(),
        spent=state.bank.credits - run[0],
        notify=run[1].clone(),
        queue_events=queue_events.reshape(T, n, n),
        stalled_by_link=stall_table(fields["stall_hop"], flat, seq0[:, 0], K)
        if stall_lane else None)


def _one_tenant(counts, state):
    """Single-tenant operands as the tenant replay's one tenant with
    reserve 0: (1, S, S) tables, K empty slice slots before the K pool
    slots, every hold shared (a row parked at hop 0 holds nothing)."""
    lift = lambda x: torch.cat([torch.zeros_like(x), x])
    pc, ph = state.parked_count, state.parked_hop
    return counts[None], state._replace(
        bank=state.bank._replace(credits=lift(state.bank.credits)),
        parked_count=pc[None], parked_hop=ph[None],
        parked_age=state.parked_age[None],
        parked_by_link=lift(state.parked_by_link),
        parked_hold_shared=torch.where(ph > 0, pc, 0)[None])


def _single_tenant(out: TenantAdmissionOut, K: int) -> AdmissionOut:
    """The one tenant's result as an :class:`AdmissionOut`: its (S, S)
    tables and the pool slots (the K slice slots stay empty)."""
    return AdmissionOut(**{
        name: x if name == "stalled_by_link" else
        x[K:] if name in _LINK_FIELDS else x[0]
        for name, x in out._asdict().items() if name != "hold_shared"})


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
    replay (:func:`admission_tenants_plain`) of the fabric as one tenant
    with reserve 0, healthy or under the mask.

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
        return _single_tenant(admission_tenants_plain(
            *_one_tenant(counts, state), tables, link_down,
            stall_lane=stall_lane), K)
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
    the plain replay (:func:`admission_tenants_plain`), healthy or under
    the mask.

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
    return admission_tenants_plain(counts, state, tables, link_down,
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
