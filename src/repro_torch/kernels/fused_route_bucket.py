"""Fused route+aggregate flush window (port of
``src/repro/kernels/fused_route_bucket.py``).

1. **route**   -- ``dest = dest_lut[addr]``, validity from the valid bit
                  and the destination range;
2. **rank**    -- one stable sort by destination groups each destination's
                  events contiguously in window order (``torch.sort(...,
                  stable=True)`` plus gathers, as the reference's
                  multi-operand ``lax.sort``);
3. **place**   -- each destination's bucket row is a slice of the sorted
                  window, zeroed past its count: the hand-written kernel
                  ``csrc/placement.cu`` on CUDA tensors, ``placement_plain``
                  on CPU tensors.  The routed variant looks the GUID up
                  inside the kernel for accepted events only.  Given a
                  ``wire_fmt``, the same launch also writes each row as
                  64-bit wire words (``wire.encode_planar`` of the row's
                  words and meta), the payload the transport ships;
4. **residue** -- events beyond a bucket's capacity are compacted into a
                  fixed-size buffer that is offered again next window.

Every function takes one window ``(n,)`` or a batch of windows ``(B, n)``
(the simulator passes its S shards as the batch, so placement is one
launch per window for all shards).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import events as ev
from repro_torch.core.aggregator import Buckets
from repro_torch.core.routing import lookup
from repro_torch.kernels import dispatch
from repro_torch.wire import codec


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
    """

    buckets: Buckets
    residue: torch.Tensor
    deferred: torch.Tensor
    dropped: torch.Tensor
    offered: torch.Tensor
    residue_meta: torch.Tensor | None = None
    payload: torch.Tensor | None = None


# ---------------------------------------------------------------------------
# Stage 3: placement -- kernel A and its plain version.
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
    out = fn(words[None], *(t[None] for t in rest))
    return FusedWindow(*(None if f is None else (
        Buckets(*(x[0] for x in f)) if isinstance(f, Buckets) else f[0])
        for f in out))


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
