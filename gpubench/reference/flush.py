"""The flush window, plain PyTorch (frozen from the port's
``kernels/fused_route_bucket.py``: ``flush_window_plain``, which the port's
kernel A matches bit for bit): route, rank, place, encode and residue of
every shard's window, one-hot ranks and overflow bases, no sort.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import events as ev
from .aggregator import Buckets
from . import codec

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
                       wire_fmt: codec.WireWordFormat | None = None
                       ) -> FusedWindow:
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
    res_meta = None
    if with_residue_meta:
        res_meta = torch.cat([scatter(meta, pos, r), pad], dim=-1)
    deferred = torch.clamp(overflow, max=r)
    fw = FusedWindow(Buckets(data, gmeta, accepted, overflow), residue,
                     deferred, overflow - deferred, offered, res_meta,
                     payload)
    return _one_window(fw) if single else fw
