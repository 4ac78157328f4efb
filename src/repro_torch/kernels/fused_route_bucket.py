"""Fused route+aggregate flush window (port of
``src/repro/kernels/fused_route_bucket.py``).

The window stage of every path is :func:`flush_window`: route, rank,
place, encode and residue of all shards' windows in one launch of the
hand-written kernel ``csrc/flush_window.cu`` on CUDA tensors, and
:func:`flush_window_plain`, the same function in the kernel's
formulation (one-hot ranks, overflow bases, no sort), on CPU tensors:

1. **route**   -- the destination per event, or ``dest_lut[addr]``
                  (addresses clamped to the table); validity from the
                  valid bit and the destination range;
2. **rank**    -- each valid event's rank among its destination's events
                  in window order, and the per-destination counts;
3. **place**   -- rank k < C takes slot k of its destination's row, with
                  its meta or ``guid_lut[addr]``; slots past the count are
                  zero.  Given a ``wire_fmt``, every slot is also written
                  as a 64-bit wire word (``wire.encode_planar`` of the
                  row's words and meta), the payload the transport ships;
4. **residue** -- events of rank >= C are compacted, destination-major,
                  into a fixed-size buffer that is offered again next
                  window, and when asked each one's destination beside
                  it (the source address layout routes by a per-event
                  destination, which the word does not carry).

The reference's sort-based chain stays beside it as
:func:`fused_aggregate` / :func:`fused_route_aggregate`: a stable
``torch.sort`` by destination plus gathers (the reference's multi-operand
``lax.sort``), the run edges, the per-row placement kernel
``csrc/placement.cu`` (``placement_plain`` on CPU tensors) and a second
sort for the residue.  Neither the simulator nor the exchange runs it
(``aggregator.aggregate(impl="fused")`` does); ``chip_smoke.py`` times
:func:`flush_window` against it on the card.

Every function takes one window ``(n,)`` or a batch of windows ``(B, n)``
(the simulator passes its S shards as the batch, so each is one launch
per window for all shards).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import events as ev
from repro_torch.core.aggregator import Buckets
from repro_torch.core.routing import lookup
from repro_torch.kernels import dispatch
from repro_torch.wire import codec

MAX_BATCH = 65535          # the kernel's windows are grid.y


class FusedWindow(NamedTuple):
    """Result of one fused route+aggregate window (leading batch axes
    follow the input).

    buckets:      ``aggregator.Buckets`` (data/guids/counts/overflow)
    residue:      (..., residue_len) int32 deferred events, INVALID-padded
    deferred:     (...) int32 events carried to the next window
    dropped:      (...) int32 overflow events that did not fit the residue
    offered:      (...) int32 valid routed events offered this window
    residue_meta: (..., residue_len) int32 the deferred events' meta, or
                  None unless ``with_residue_meta``
    payload:      (..., D, 2C) int32 ``encode_planar(buckets.data,
                  buckets.guids, wire_fmt)``, or None unless ``wire_fmt``
    residue_dest: (..., residue_len) int32 the deferred events'
                  destinations, 0-padded, or None unless
                  ``with_residue_dest``
    """

    buckets: Buckets
    residue: torch.Tensor
    deferred: torch.Tensor
    dropped: torch.Tensor
    offered: torch.Tensor
    residue_meta: torch.Tensor | None = None
    payload: torch.Tensor | None = None
    residue_dest: torch.Tensor | None = None


# ---------------------------------------------------------------------------
# The flush window -- kernel A's stage in one launch, and its plain version.
# ---------------------------------------------------------------------------

def _window_operands(words, dest, dest_lut, meta, guid_lut, n_dest: int,
                     with_residue_meta: bool):
    """Checks shared by :func:`flush_window` and its plain version ->
    (single, words, dest, dest_lut, meta, guid_lut): int32, per-event
    operands (B, n) (a single (n,) window gets B = 1, ``single`` True),
    tables (1 or B, n_table)."""
    if (dest is None) == (dest_lut is None):
        raise ValueError("flush_window: give exactly one of dest and "
                         "dest_lut")
    if (meta is None) == (guid_lut is None):
        raise ValueError("flush_window: give exactly one of meta and "
                         "guid_lut")
    if with_residue_meta and guid_lut is not None:
        raise ValueError("with_residue_meta needs per-event meta (the "
                         "explicit-guids path), not a routed guid LUT")
    if n_dest < 1:
        raise ValueError(f"flush_window: n_dest {n_dest} < 1")
    single = words.dim() == 1
    per_event = [None if t is None else t.to(torch.int32)
                 for t in (words, dest, meta)]
    if single:
        per_event = [None if t is None else t[None] for t in per_event]
    words, dest, meta = per_event
    for name, t in (("dest", dest), ("meta", meta)):
        if t is not None and t.shape != words.shape:
            raise ValueError(f"flush_window: {name} {tuple(t.shape)} does "
                             f"not match words {tuple(words.shape)}")
    tables = []
    for name, t in (("dest_lut", dest_lut), ("guid_lut", guid_lut)):
        if t is not None:
            t = t.to(torch.int32)
            t = t[None] if t.dim() == 1 else t
            if t.dim() != 2 or t.shape[0] not in (1, words.shape[0]) \
                    or t.shape[1] == 0:
                raise ValueError(f"flush_window: {name} must be (n_table,) "
                                 f"or (B, n_table), got {tuple(t.shape)}")
        tables.append(t)
    return single, words, dest, tables[0], meta, tables[1]


def _one_window(fw: FusedWindow) -> FusedWindow:
    return FusedWindow(*(None if f is None else (
        Buckets(*(x[0] for x in f)) if isinstance(f, Buckets) else f[0])
        for f in fw))


def _table_lookup(table, words):
    """``table[b, min(address(w), n_table - 1)]`` for every event."""
    idx = torch.clamp(ev.address(words), max=table.shape[-1] - 1).long()
    return torch.gather(table.expand(words.shape[0], -1), 1, idx)


def flush_window_plain(words, n_dest: int, capacity: int, *, dest=None,
                       dest_lut=None, meta=None, guid_lut=None,
                       residue_len: int = 0, with_residue_meta: bool = False,
                       wire_fmt: codec.WireWordFormat | None = None,
                       with_residue_dest: bool = False) -> FusedWindow:
    """Plain PyTorch flush window, in the kernel's formulation.

    words: (B, n) or (n,) int32 event words.  The destination of each event
    is ``dest`` (per event) or ``dest_lut[min(address, n_lut - 1)]``; its
    meta is ``meta`` (per event) or ``guid_lut[min(address, n_guid - 1)]``.
    Tables are (n_table,) or one row per window.  The rank of an event
    among its destination's is the exclusive cumsum of the (D, n) one-hot;
    rank k < C takes slot k, rank k >= C residue position ``ovf_base[d] +
    k - C`` (``ovf_base``: the exclusive cumsum of the destinations'
    overflow).  Returns what :func:`fused_aggregate` /
    :func:`fused_route_aggregate` return, bit for bit.
    """
    single, words, dest, dest_lut, meta, guid_lut = _window_operands(
        words, dest, dest_lut, meta, guid_lut, n_dest, with_residue_meta)
    b, n = words.shape
    dev = words.device
    C = capacity
    if dest_lut is not None:
        dest = _table_lookup(dest_lut, words)
    if guid_lut is not None:
        meta = _table_lookup(guid_lut, words)
    valid = ev.is_valid(words) & (dest >= 0) & (dest < n_dest)
    d_ids = torch.arange(n_dest, dtype=torch.int32, device=dev)
    onehot = ((dest[:, None, :] == d_ids[:, None]) & valid[:, None, :]).to(
        torch.int32)                                         # (B, D, n)
    counts = onehot.sum(-1, dtype=torch.int32)
    d_of = torch.where(valid, dest, 0).long()
    rank = torch.gather(torch.cumsum(onehot, -1, dtype=torch.int32) - onehot,
                        1, d_of[:, None, :])[:, 0]           # (B, n)
    accepted = torch.clamp(counts, max=C)
    offered = counts.sum(-1, dtype=torch.int32)
    overflow = offered - accepted.sum(-1, dtype=torch.int32)

    def scatter(values, index, width):      # column ``width`` takes the rest
        out = torch.zeros((b, width + 1), dtype=torch.int32, device=dev)
        return out.scatter_(1, index, values)[:, :width]

    slot = torch.where(valid & (rank < C), d_of * C + rank, n_dest * C)
    data, gmeta = (scatter(v, slot, n_dest * C).reshape(b, n_dest, C)
                   for v in (words, meta))
    payload = None
    if wire_fmt is not None:
        payload = torch.cat(codec.encode_plain(data, gmeta, wire_fmt), dim=-1)

    r = min(residue_len, n)
    excess = counts - accepted
    ovf_base = torch.cumsum(excess, -1, dtype=torch.int32) - excess
    pos = torch.gather(ovf_base, 1, d_of) + rank - C
    pos = torch.where(valid & (rank >= C) & (pos < r), pos, r).long()
    pad = torch.zeros((b, residue_len - r), dtype=torch.int32, device=dev)
    residue = torch.cat([scatter(words, pos, r), pad], dim=-1)
    res_meta = res_dest = None
    if with_residue_meta:
        res_meta = torch.cat([scatter(meta, pos, r), pad], dim=-1)
    if with_residue_dest:
        res_dest = torch.cat([scatter(d_of.to(torch.int32), pos, r), pad],
                             dim=-1)
    deferred = torch.clamp(overflow, max=r)
    fw = FusedWindow(Buckets(data, gmeta, accepted, overflow), residue,
                     deferred, overflow - deferred, offered, res_meta,
                     payload, res_dest)
    return _one_window(fw) if single else fw


def flush_window(words, n_dest: int, capacity: int, *, dest=None,
                 dest_lut=None, meta=None, guid_lut=None,
                 residue_len: int = 0, with_residue_meta: bool = False,
                 wire_fmt: codec.WireWordFormat | None = None,
                 with_residue_dest: bool = False) -> FusedWindow:
    """The flush window of every window of the batch: one launch of
    ``csrc/flush_window.cu`` on CUDA tensors, :func:`flush_window_plain`
    (same arguments and results) on CPU tensors."""
    operands = [t for t in (words, dest, dest_lut, meta, guid_lut)
                if t is not None]
    if not dispatch.on_cuda(*operands):
        return flush_window_plain(
            words, n_dest, capacity, dest=dest, dest_lut=dest_lut, meta=meta,
            guid_lut=guid_lut, residue_len=residue_len,
            with_residue_meta=with_residue_meta, wire_fmt=wire_fmt,
            with_residue_dest=with_residue_dest)
    single, words, dest, dest_lut, meta, guid_lut = _window_operands(
        words, dest, dest_lut, meta, guid_lut, n_dest, with_residue_meta)
    words, dest, dest_lut, meta, guid_lut = (
        None if t is None else t.contiguous()
        for t in (words, dest, dest_lut, meta, guid_lut))
    b, n = words.shape
    from repro_torch.kernels import _build
    # staged per event: key, word (, meta)
    longest = _build.max_window(n_dest, 2 if meta is None else 3)
    if n_dest > _build.MAX_DEST or b > MAX_BATCH or n > longest or \
            n_dest * capacity >= 2**31:
        raise ValueError(f"flush_window: {b} windows of {n} events to "
                         f"{n_dest} destinations of {capacity} slots; the "
                         f"kernel takes at most {MAX_BATCH} windows of "
                         f"{longest} events, {_build.MAX_DEST} destinations "
                         f"and 2^31 slots a window")
    dev = words.device
    new = lambda *shape: torch.empty(shape, dtype=torch.int32, device=dev)
    data, gmeta = new(b, n_dest, capacity), new(b, n_dest, capacity)
    counts, scalars = new(b, n_dest), new(4, b)
    residue = new(b, residue_len)
    res_meta = new(b, residue_len) if with_residue_meta else None
    res_dest = new(b, residue_len) if with_residue_dest else None
    payload = new(b, n_dest, 2 * capacity) if wire_fmt is not None else None
    fmt = wire_fmt if wire_fmt is not None else codec.DEFAULT_WORD
    ptr = lambda t: None if t is None else t.data_ptr()
    table = lambda t: (0, 0) if t is None else (
        t.shape[1], 0 if t.shape[0] == 1 else t.shape[1])
    if b:
        dispatch.launch("flush_window", "repro_flush_window", ptr(words),
                        ptr(dest), ptr(dest_lut), ptr(meta), ptr(guid_lut),
                        ptr(data), ptr(gmeta), ptr(payload), ptr(counts),
                        ptr(residue), ptr(res_meta), ptr(res_dest),
                        ptr(scalars), b, n,
                        n_dest, capacity, residue_len, *table(dest_lut),
                        *table(guid_lut), *fmt.validate()[:3])
    offered, overflow, deferred, dropped = scalars
    fw = FusedWindow(Buckets(data, gmeta, counts, overflow), residue,
                     deferred, dropped, offered, res_meta, payload, res_dest)
    return _one_window(fw) if single else fw


# ---------------------------------------------------------------------------
# The reference's sort-based chain: the per-row placement kernel (no
# simulator or exchange path runs it since the flush window) and its plain
# version.
# ---------------------------------------------------------------------------

def placement_plain(first, counts, swords_pad, aux, capacity: int, *,
                    routed: bool, wire_fmt: codec.WireWordFormat | None
                    = None):
    """Plain PyTorch placement.

    first, counts: (B, D) int32 start and length of each destination's run
    in the sorted window; swords_pad: (B, n + C) sorted words (the C pad
    absorbs reads past the end); aux: (B, n + C) sorted meta, or the
    (B, n_lut) GUID table when ``routed``.  -> data, meta (B, D, C) int32,
    and with ``wire_fmt`` also their wire payload (B, D, 2C) int32.
    """
    b, d = first.shape
    slot = torch.arange(capacity, dtype=torch.int32, device=first.device)
    live = slot < torch.clamp(counts, max=capacity)[..., None]
    idx = (first[..., None] + slot).reshape(b, d * capacity).long()
    zero = torch.zeros((), dtype=torch.int32, device=first.device)
    data = torch.where(live, torch.gather(swords_pad, 1, idx).reshape(
        b, d, capacity), zero)
    if routed:
        addr = torch.clamp(ev.address(data), max=aux.shape[-1] - 1)
        g = torch.gather(aux, 1, addr.reshape(b, -1).long())
    else:
        g = torch.gather(aux, 1, idx)
    meta = torch.where(live, g.reshape(b, d, capacity), zero)
    if wire_fmt is None:
        return data, meta
    return data, meta, torch.cat(codec.encode_plain(data, meta, wire_fmt),
                                 dim=-1)


def placement(first, counts, swords_pad, aux, capacity: int, *,
              routed: bool, wire_fmt: codec.WireWordFormat | None = None):
    """Bucket placement: kernel A on CUDA tensors, the plain version on CPU
    tensors (same arguments and results as :func:`placement_plain`); with
    ``wire_fmt`` the kernel encodes the placed rows in the same launch."""
    if not dispatch.on_cuda(first, counts, swords_pad, aux):
        return placement_plain(first, counts, swords_pad, aux, capacity,
                               routed=routed, wire_fmt=wire_fmt)
    b, d = first.shape
    n_pad = swords_pad.shape[-1]
    for name, t in (("first", first), ("counts", counts),
                    ("swords_pad", swords_pad), ("aux", aux)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.dim() != 2 \
                or t.shape[0] != b:
            raise ValueError(f"placement: {name} must be a contiguous "
                             f"(B={b}, ...) int32 tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if counts.shape != first.shape or n_pad < capacity or (
            not routed and aux.shape[-1] != n_pad) or aux.shape[-1] == 0:
        raise ValueError(
            f"placement: shapes do not fit: first {tuple(first.shape)}, "
            f"counts {tuple(counts.shape)}, words {tuple(swords_pad.shape)}, "
            f"aux {tuple(aux.shape)}, capacity {capacity}")
    data = torch.empty((b, d, capacity), dtype=torch.int32,
                       device=first.device)
    meta = torch.empty_like(data)
    payload = None
    if wire_fmt is not None:
        payload = torch.empty((b, d, 2 * capacity), dtype=torch.int32,
                              device=first.device)
    fmt = wire_fmt if wire_fmt is not None else codec.DEFAULT_WORD
    if data.numel():
        dispatch.launch("placement", "repro_placement", first.data_ptr(),
                        counts.data_ptr(), swords_pad.data_ptr(),
                        aux.data_ptr(), data.data_ptr(), meta.data_ptr(),
                        None if payload is None else payload.data_ptr(),
                        b, d, capacity, n_pad, aux.shape[-1], int(routed),
                        *fmt.validate()[:3])
    return (data, meta) if payload is None else (data, meta, payload)


# ---------------------------------------------------------------------------
# The fused op.
# ---------------------------------------------------------------------------

def sort_by_destination(words, dest, n_dest: int, *others):
    """Stable sort of each window by destination (invalid events last)
    -> (sorted key, sorted words, *sorted others)."""
    valid = ev.is_valid(words) & (dest >= 0) & (dest < n_dest)
    key = torch.where(valid, dest.to(torch.int32),
                      torch.full_like(dest, n_dest, dtype=torch.int32))
    skey, order = torch.sort(key, dim=-1, stable=True)
    return (skey, torch.gather(words, -1, order),
            *(torch.gather(o, -1, order) for o in others))


def placement_operands(skey, swords, aux, n_dest: int, capacity: int, *,
                       routed: bool):
    """(first, counts, swords_pad, aux_pad) of :func:`placement` for
    destination-sorted windows (B, n)."""
    b = skey.shape[0]
    dests = torch.arange(n_dest + 1, dtype=torch.int32, device=skey.device)
    edges = torch.searchsorted(skey, dests.expand(b, -1).contiguous(),
                               out_int32=True)
    first = edges[:, :-1].contiguous()
    counts = (edges[:, 1:] - edges[:, :-1]).contiguous()
    pad = torch.zeros((b, capacity), dtype=torch.int32, device=skey.device)
    swords_pad = torch.cat([swords, pad], dim=-1)
    if not routed:
        aux = torch.cat([aux, pad], dim=-1)
    return first, counts, swords_pad, aux.contiguous()


def _finish(skey, swords, aux, n_dest: int, capacity: int, residue_len: int,
            *, routed: bool, with_residue_meta: bool = False,
            wire_fmt: codec.WireWordFormat | None = None) -> FusedWindow:
    if with_residue_meta and routed:
        raise ValueError("with_residue_meta needs per-event meta (the "
                         "explicit-guids path), not a routed guid LUT")
    b, n = swords.shape
    dev = swords.device
    first, counts, swords_pad, aux_pad = placement_operands(
        skey, swords, aux, n_dest, capacity, routed=routed)
    data, gui, *payload = placement(first, counts, swords_pad, aux_pad,
                                    capacity, routed=routed,
                                    wire_fmt=wire_fmt)
    payload = payload[0] if payload else None
    accepted = torch.clamp(counts, max=capacity)
    offered = counts.sum(-1, dtype=torch.int32)
    overflow = offered - accepted.sum(-1, dtype=torch.int32)
    buckets = Buckets(data, gui, accepted, overflow)

    res_meta = None
    if not residue_len:
        empty = torch.zeros((b, 0), dtype=torch.int32, device=dev)
        return FusedWindow(buckets, empty, torch.zeros_like(overflow),
                           overflow, offered,
                           empty if with_residue_meta else None, payload)
    # overflow events: sorted position >= first-of-destination + capacity
    first_of = torch.gather(first, -1,
                            torch.clamp(skey, max=n_dest - 1).long())
    pos = torch.arange(n, dtype=torch.int32, device=dev) - first_of
    ovf = (skey < n_dest) & (pos >= capacity)
    r = min(residue_len, n)
    deferred = torch.clamp(overflow, max=r)
    live_r = torch.arange(r, device=dev) < deferred[:, None]
    order = torch.sort((~ovf).to(torch.uint8), dim=-1,
                       stable=True).indices[:, :r]
    pad = torch.zeros((b, residue_len - r), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    res = torch.cat([torch.where(live_r, torch.gather(swords, -1, order),
                                 zero), pad], dim=-1)
    if with_residue_meta:
        res_meta = torch.cat([torch.where(
            live_r, torch.gather(aux, -1, order), zero), pad], dim=-1)
    return FusedWindow(buckets, res, deferred, overflow - deferred, offered,
                       res_meta, payload)


def _batched(fn, words, *rest):
    """Run ``fn`` on (B, n) windows; a single (n,) window gets B = 1."""
    if words.dim() == 2:
        return fn(words, *rest)
    return _one_window(fn(words[None], *(t[None] for t in rest)))


def fused_aggregate(words, dest, guids, n_dest: int, capacity: int, *,
                    residue_len: int = 0, with_residue_meta: bool = False,
                    wire_fmt: codec.WireWordFormat | None = None
                    ) -> FusedWindow:
    """Sort-based aggregation with explicit per-event destinations and meta.

    Window order within each destination, capacity clip, invalid events
    (valid bit clear or dest out of range) ignored.  ``guids`` is an int32
    meta value riding with each event; ``with_residue_meta`` also carries
    it for the deferred events; ``wire_fmt`` adds the buckets' wire
    payload.
    """
    def run(w, d, g):
        skey, swords, sguids = sort_by_destination(
            w, d, n_dest, g.to(torch.int32))
        return _finish(skey, swords, sguids, n_dest, capacity, residue_len,
                       routed=False, with_residue_meta=with_residue_meta,
                       wire_fmt=wire_fmt)
    return _batched(run, words, dest, guids)


def fused_route_aggregate(words, dest_lut, guid_lut, n_dest: int,
                          capacity: int, *, residue_len: int = 0,
                          wire_fmt: codec.WireWordFormat | None = None
                          ) -> FusedWindow:
    """Routing-LUT gather + capacity-bounded binning in one pass; the GUID
    gather runs inside placement over accepted events only.  Tables follow
    the clamped-index semantics of ``RoutingTables.route``.  ``wire_fmt``
    adds the buckets' wire payload."""
    def run(w, dl, gl):
        addr = torch.clamp(ev.address(w), max=dl.shape[-1] - 1)
        skey, swords = sort_by_destination(w, lookup(dl, addr), n_dest)
        return _finish(skey, swords, gl.to(torch.int32).contiguous(),
                       n_dest, capacity, residue_len, routed=True,
                       wire_fmt=wire_fmt)
    return _batched(run, words, dest_lut, guid_lut)
