"""Delivery of received events through a sparse synapse store, in event
order (no reference counterpart: the reference delivers through a dense
weight matrix, ``src/repro/snn/simulator.py:_apply_events``).

:func:`synapse_deliver` launches the hand-written kernel
``csrc/synapse_deliver.cu`` on CUDA tensors and runs
:func:`synapse_deliver_plain` on CPU tensors.  Both compute, bit for bit:

* for each destination shard ``s``, the received events ``words[s, src,
  k]`` are taken in order, row-major over (source shard ``src``, bucket
  slot ``k``), live ones only (``k < counts[s, src]``);
* an event's source is ``src * per + address(w)`` (the source address
  layout of ``snn/network.py``); an address at or past ``per`` carries no
  synapse.  Its ring slot is ``(t + max(slack, 0)) % ring_len``, ``slack``
  the signed 15-bit distance from ``t`` to its timestamp, and an event
  with ``slack < 0`` is a deadline miss of ``s`` (counted as the dense
  delivery counts them);
* each synapse (target ``x``, weight) of the source's list on ``s`` adds
  its weight, as one f32 add, into ``ring_inh`` if the source is
  inhibitory, else ``ring_exc``, at ``[slot, s, x]``.  Each (target, slot)
  sees its adds in the event order above.  No atomics decide the order of
  the float adds, so the rings are a fixed function of the inputs;
* the synapses delivered are added into ``store.count`` (one int64
  element, on the device; the kernel adds to it in its own launch).

The rings are updated in place; returns the (S,) int32 deadline misses.
A list may repeat a target when the store says so
(``snn.network.MultapseStore``); the repeats of one event add in their
list's order, one after another.  Without multapses the adds of one
event never meet, and the kernel's plain instance runs.  The window's
step ``t`` is a Python int or, for a caller that keeps its step count on
the card (the simulator, whose window loop is replayed as a CUDA graph),
an int32 tensor whose first element the kernel reads through its pointer.

:func:`stdp_deliver` delivers the plastic lists (``snn.network.
PlasticLists``) after the static ones, updating each synapse before its
add (``snn.stdp``): for each destination shard, the live events in the
same order, missed ones left out; an event's list updated by
``snn.stdp.rule`` and then added, each synapse the weight it has after
that event; then its source's K+ and t_last.  Kernel (plan, update, the
walk; counted as ``stdp_deliver``) on CUDA tensors,
:func:`stdp_deliver_plain` on CPU tensors, bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.kernels import _build, dispatch
from repro_torch.snn import stdp

MAX_RING = 64             # ring slots the kernel stages (kMaxRows / 2)
MAX_PLAN_SLOTS = 4096     # event slots a shard the plastic plan takes


def _operands(ring_exc, ring_inh, words, counts, store, inh_src, per: int):
    S, n_src, C = words.shape
    L = ring_exc.shape[0]
    want = [("words", words, (S, n_src, C), torch.int32),
            ("ring_exc", ring_exc, (L, S, per), torch.float32),
            ("ring_inh", ring_inh, (L, S, per), torch.float32),
            ("row_ptr", store.row_ptr, (S, n_src * per + 1), torch.int64),
            ("targets", store.targets, tuple(store.targets.shape),
             torch.int32),
            ("weights", store.weights, tuple(store.targets.shape),
             torch.float32),
            ("count", store.count, (1,), torch.int64),
            ("inh_src", inh_src, (n_src * per,), torch.bool)]
    for name, t, shape, dtype in want:
        if t.dtype != dtype or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"synapse_deliver: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (S, n_src):
        raise ValueError(f"synapse_deliver: counts must be an int32 tensor "
                         f"of shape {(S, n_src)}, got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if per > ev.ADDR_MASK + 1:
        raise ValueError(f"synapse_deliver: {per} neurons a shard exceed "
                         f"the {ev.ADDR_BITS}-bit address field")
    return S, n_src, C, L


def _ordered_add(flat: torch.Tensor, elem: torch.Tensor, w: torch.Tensor):
    """Add ``w`` into ``flat`` at ``elem`` in place, the adds into one
    element in the order given: the k-th add of an element in round k,
    one ``index_put_(..., accumulate=True)`` with unique indices each."""
    if elem.numel() == 0:
        return
    srt, order = torch.sort(elem, stable=True)
    first = torch.searchsorted(srt, srt)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(elem.numel(), device=elem.device) - first
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        flat.index_put_((elem[sel],), w[sel], accumulate=True)


def _event_lists(row_ptr, has, g, shard):
    """The entries of the lists of one event slot's sources ``g`` (S,)
    where ``has``: (shard of each entry, entry index), shard-major."""
    g = torch.where(has, g, 0)
    start = row_ptr[shard, g]
    n = torch.where(has, row_ptr[shard, g + 1] - start, 0)
    m = int(n.sum())
    sh = torch.repeat_interleave(shard, n)
    first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    j = torch.repeat_interleave(start, n) + torch.arange(
        m, device=row_ptr.device) - first
    return sh, j


def synapse_deliver_plain(ring_exc, ring_inh, words, counts, t: int, store,
                          inh_src, per: int):
    """Plain PyTorch delivery: one event slot at a time, in order, each
    vectorised over the destination shards, its adds in list order
    (:func:`_ordered_add`: one f32 add an element at a time)."""
    words = words.contiguous()
    S, n_src, C, L = _operands(ring_exc, ring_inh, words, counts, store,
                               inh_src, per)
    t = dispatch.step_on_host(t)
    dev = words.device
    slot_ix = torch.arange(C, dtype=torch.int32, device=dev)
    live = (slot_ix < counts[..., None]).reshape(S, -1)
    words = words.reshape(S, -1)
    addr = ev.address(words)
    slack = ev.ts_slack(ev.timestamp(words), t & ev.TS_MASK)
    miss = (live & (slack < 0)).sum(1, dtype=torch.int32)
    ring_slot = ((t + torch.clamp(slack, min=0)) % L).long()
    has = live & (addr < per)
    src = (torch.arange(n_src, device=dev).repeat_interleave(C)[None]
           * per + addr).long()                       # (S, n_src * C)
    shard = torch.arange(S, device=dev)
    total = 0
    for p in torch.nonzero(has.any(0)).flatten().tolist():
        sh, j = _event_lists(store.row_ptr, has[:, p], src[:, p], shard)
        if j.numel() == 0:
            continue
        _add_rows(ring_exc, ring_inh, sh, ring_slot[sh, p],
                  store.targets[j].long(), store.weights[j],
                  inh_src[src[sh, p]], per)
        total += j.numel()
    store.count.add_(total)
    return miss


def _add_rows(ring_exc, ring_inh, sh, q, x, w, inh, per: int):
    """The adds of one event slot into the (L, S, per) rings, in order."""
    S = ring_exc.shape[1]
    for ring, sel in ((ring_exc, ~inh), (ring_inh, inh)):
        flat = ring.view(-1)
        _ordered_add(flat, (q[sel] * S + sh[sel]) * per + x[sel], w[sel])


def synapse_deliver(ring_exc, ring_inh, words, counts, t, store,
                    inh_src, per: int):
    """Deliver ``words`` (S, S_src, C) int32 received events with their
    ``counts`` (S, S_src) into the rings (ring_len, S, per) f32 through
    ``store`` (``snn.network.SynapseStore``) at step ``t`` (an int, or an
    int32 tensor on the card) -> (S,) int32 deadline misses.  Kernel on
    CUDA tensors, :func:`synapse_deliver_plain` on CPU tensors (the module
    docstring's semantics)."""
    t_at = t if isinstance(t, torch.Tensor) else None
    if t_at is not None and (t_at.dtype != torch.int32 or t_at.numel() < 1):
        raise ValueError(f"synapse_deliver: a step tensor must be int32 "
                         f"with an element, got {t_at.dtype} "
                         f"{tuple(t_at.shape)}")
    operands = (ring_exc, ring_inh, words, counts, store.row_ptr,
                store.targets, store.weights, store.count, inh_src,
                *(() if t_at is None else (t_at,)))
    if not dispatch.on_cuda(*operands):
        return synapse_deliver_plain(ring_exc, ring_inh, words, counts, t,
                                     store, inh_src, per)
    words = words.contiguous()
    S, n_src, C, L = _operands(ring_exc, ring_inh, words, counts, store,
                               inh_src, per)
    if L > MAX_RING or (t_at is None and t < 0):
        raise ValueError(f"synapse_deliver: the kernel takes rings of at "
                         f"most {MAX_RING} slots and t >= 0, got {L} and "
                         f"{t}")
    miss = torch.empty((S,), dtype=torch.int32, device=words.device)
    if S:
        dispatch.launch("synapse_deliver", "repro_synapse_deliver",
                        words.data_ptr(), counts.data_ptr(),
                        store.row_ptr.data_ptr(), store.targets.data_ptr(),
                        store.weights.data_ptr(), inh_src.data_ptr(),
                        ring_exc.data_ptr(), ring_inh.data_ptr(),
                        miss.data_ptr(), store.count.data_ptr(), S, n_src, C,
                        per, L, 0 if t_at is not None else int(t),
                        None if t_at is None else t_at.data_ptr(),
                        *counts.stride(), int(store.multapses))
    return miss


def stdp_deliver_plain(ring_exc, ring_inh, words, counts, t, lists, state,
                       inh_src, per: int, params, tables) -> None:
    """Plain PyTorch plastic delivery (the module docstring): one event
    slot at a time, in order, vectorised over the destination shards;
    ``state`` (``snn.stdp.PlasticState``) updated in place."""
    words = words.contiguous()
    S, n_src, C = words.shape
    L = ring_exc.shape[0]
    t = dispatch.step_on_host(t)
    dev = words.device
    plus, minus = tables
    slot_ix = torch.arange(C, dtype=torch.int32, device=dev)
    live = (slot_ix < counts[..., None]).reshape(S, -1)
    words = words.reshape(S, -1)
    addr = ev.address(words)
    slack = ev.ts_slack(ev.timestamp(words), t & ev.TS_MASK)
    has = live & (addr < per) & (slack >= 0)
    ring_slot = ((t + torch.clamp(slack, min=0)) % L).long()
    t_spike = (t + slack - params.delay_steps).to(torch.int32)
    src = (torch.arange(n_src, device=dev).repeat_interleave(C)[None]
           * per + addr).long()
    shard = torch.arange(S, device=dev)
    arch = state.archive
    steps = arch.step.reshape(S * per, -1)
    kminus = arch.kminus.reshape(S * per, -1)
    n_post = arch.count.reshape(-1)
    for p in torch.nonzero(has.any(0)).flatten().tolist():
        g0 = torch.where(has[:, p], src[:, p], 0)
        on = has[:, p] & (lists.row_ptr[shard, g0 + 1]
                          > lists.row_ptr[shard, g0])
        if not bool(on.any()):
            continue
        sh, j = _event_lists(lists.row_ptr, on, src[:, p], shard)
        g = src[sh, p]
        x = lists.targets[j].long()
        nid = sh * per + x
        w, c = stdp.rule(state.weights[j], t_spike[sh, p],
                         state.kplus[sh, g], state.t_last[sh, g],
                         steps[nid], kminus[nid], n_post[nid], params,
                         plus, minus)
        state.weights[j] = w
        _add_rows(ring_exc, ring_inh, sh, ring_slot[sh, p], x, w,
                  inh_src[g], per)
        state.counts.index_add_(0, sh, c)
        gs, ss = src[on, p], shard[on]
        kp, tl = state.kplus[ss, gs], state.t_last[ss, gs]
        tsp = t_spike[on, p]
        state.kplus[ss, gs] = kp * plus[torch.clamp(
            tsp.long() - tl.long(), 0, plus.numel() - 1)] + 1.0
        state.t_last[ss, gs] = tsp


def stdp_deliver(ring_exc, ring_inh, words, counts, t, lists, state,
                 inh_src, per: int, params, tables) -> None:
    """Deliver ``words`` (S, S_src, C) with their ``counts`` through the
    plastic ``lists`` (``snn.network.PlasticLists``) into the rings,
    updating ``state`` (``snn.stdp.PlasticState``) in place, at step
    ``t`` (an int, or an int32 tensor on the card); ``params`` an
    ``snn.stdp.StdpParams``, ``tables`` its (plus, minus) decay tables on
    the rings' device.  Misses are counted by the static delivery.
    Kernel on CUDA tensors, :func:`stdp_deliver_plain` on CPU tensors."""
    t_at = t if isinstance(t, torch.Tensor) else None
    arch = state.archive
    operands = (ring_exc, ring_inh, words, counts, lists.row_ptr,
                lists.targets, state.weights, state.kplus, state.t_last,
                *arch, state.counts, inh_src, *tables,
                *(() if t_at is None else (t_at,)))
    if not dispatch.on_cuda(*operands):
        return stdp_deliver_plain(ring_exc, ring_inh, words, counts, t,
                                  lists, state, inh_src, per, params, tables)
    words = words.contiguous()
    S, n_src, C = words.shape
    L = ring_exc.shape[0]
    n_ids = n_src * per
    H = arch.step.shape[-1]
    want = [("row_ptr", lists.row_ptr, (S, n_ids + 1), torch.int64),
            ("targets", lists.targets, tuple(lists.targets.shape),
             torch.int32),
            ("weights", state.weights, tuple(lists.targets.shape),
             torch.float32),
            ("kplus", state.kplus, (S, n_ids), torch.float32),
            ("t_last", state.t_last, (S, n_ids), torch.int32),
            ("archive.step", arch.step, (S, per, H), torch.int32),
            ("archive.kminus", arch.kminus, (S, per, H), torch.float32),
            ("archive.count", arch.count, (S, per), torch.int32),
            ("counts", state.counts, (S, len(stdp.COUNTERS)), torch.int64),
            ("ring_exc", ring_exc, (L, S, per), torch.float32),
            ("ring_inh", ring_inh, (L, S, per), torch.float32),
            ("inh_src", inh_src, (n_ids,), torch.bool)]
    for name, x, shape, dtype in want:
        if x.dtype != dtype or tuple(x.shape) != shape or \
                not x.is_contiguous():
            raise ValueError(f"stdp_deliver: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (S, n_src):
        raise ValueError(f"stdp_deliver: counts must be int32 {(S, n_src)}"
                         f", got {counts.dtype} {tuple(counts.shape)}")
    n_slots = n_src * C
    if L > MAX_RING or n_slots > MAX_PLAN_SLOTS or (t_at is None and t < 0):
        raise ValueError(f"stdp_deliver: the kernel takes rings of at most "
                         f"{MAX_RING} slots, {MAX_PLAN_SLOTS} event slots a "
                         f"shard and t >= 0, got {L}, {n_slots} and {t}")
    plus, minus = tables
    lam, lam_alpha = params.f32()
    dev = words.device
    ws = torch.empty((_build.library().repro_stdp_workspace(S, n_slots),),
                     dtype=torch.uint8, device=dev)
    longest = lists.longest
    vals = torch.empty((S, max(n_slots * longest, 1)), dtype=torch.float32,
                       device=dev)
    miss = torch.empty((S,), dtype=torch.int32, device=dev)
    dispatch.launch("stdp_deliver", "repro_stdp_deliver",
                    words.data_ptr(), counts.data_ptr(),
                    lists.row_ptr.data_ptr(), lists.targets.data_ptr(),
                    state.weights.data_ptr(), inh_src.data_ptr(),
                    state.kplus.data_ptr(), state.t_last.data_ptr(),
                    arch.step.data_ptr(), arch.kminus.data_ptr(),
                    arch.count.data_ptr(), plus.data_ptr(), minus.data_ptr(),
                    state.counts.data_ptr(), ring_exc.data_ptr(),
                    ring_inh.data_ptr(), miss.data_ptr(), ws.data_ptr(),
                    vals.data_ptr(), vals.shape[1], S, n_src, C, per, L,
                    0 if t_at is not None else int(t),
                    None if t_at is None else t_at.data_ptr(),
                    *counts.stride(), params.delay_steps, H, plus.numel(),
                    lam, lam_alpha, float(params.mu))
