"""Lookup-table routing (port of ``src/repro/core/routing.py``).

The source table maps a pulse address to a network destination and a
GUID; the destination table maps a GUID to a multicast mask over the local
HICANN links.  Tables are tensors of one shard, ``(n_addr,)``, or stacked
over shards, ``(S, n_addr)``; a stacked table is looked up row by row with
``(S, n)`` words.  Multicast masks are u32 bit patterns held as ``int32``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.kernels import dispatch

DEST_BITS = 16          # Extoll: 16-bit destination address in the header
MAX_DESTS = 1 << DEST_BITS
NO_ROUTE = -1


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a 1-D table, a row-wise gather for a stacked one."""
    if table.dim() == 1:
        return table[idx]
    return torch.gather(table, -1, idx.long())


@dataclasses.dataclass
class RoutingTables:
    """Routing state of one shard, or of all shards stacked.

    dest_of_addr:  (..., n_addr) int32 destination per pulse address,
                   ``NO_ROUTE`` for unconnected sources
    guid_of_addr:  (..., n_addr) int32 GUID sent with the event
    mcast_of_guid: (..., n_guid) int32 (u32 bits) multicast mask per GUID
    """

    dest_of_addr: torch.Tensor
    guid_of_addr: torch.Tensor
    mcast_of_guid: torch.Tensor

    def route(self, event_words: torch.Tensor):
        """Source-side lookup -> (dest, guid, routed); invalid or unrouted
        events get ``dest == NO_ROUTE``.  Addresses past the table clamp to
        its last entry."""
        addr, _, valid = ev.unpack(event_words)
        idx = torch.clamp(addr, max=self.dest_of_addr.shape[-1] - 1)
        dest = lookup(self.dest_of_addr, idx)
        guid = lookup(self.guid_of_addr, idx)
        routed = valid & (dest != NO_ROUTE)
        return torch.where(routed, dest, torch.full_like(dest, NO_ROUTE)), \
            guid, routed

    def multicast(self, guids: torch.Tensor) -> torch.Tensor:
        """Destination-side lookup: GUID -> multicast mask (negative -> 0)."""
        idx = torch.clamp(guids, 0, self.mcast_of_guid.shape[-1] - 1)
        mask = lookup(self.mcast_of_guid, idx)
        return torch.where(guids >= 0, mask, torch.zeros_like(mask))


@dataclasses.dataclass(frozen=True)
class Projection:
    """Population-level connection used to build routing tables."""

    src_addr_lo: int
    src_addr_hi: int
    dest_node: int
    dest_links: Sequence[int]


def build_tables(n_addr: int, projections: Sequence[Projection], *,
                 n_guid: int | None = None, device=None) -> RoutingTables:
    """Build one shard's tables from projections (on the host, then moved
    to ``device``).

    Each distinct (dest_node, dest_links) pair gets one GUID; later
    projections overwrite earlier ones on address overlap.
    """
    dest = np.full((n_addr,), -1, np.int32)
    guid = np.zeros((n_addr,), np.int32)
    guid_map: dict[tuple[int, tuple[int, ...]], int] = {}
    masks: list[int] = []
    for p in projections:
        links = tuple(sorted(set(p.dest_links)))
        key = (p.dest_node, links)
        if key not in guid_map:
            guid_map[key] = len(masks)
            masks.append(sum(1 << l for l in links))
        g = guid_map[key]
        dest[p.src_addr_lo: p.src_addr_hi] = p.dest_node
        guid[p.src_addr_lo: p.src_addr_hi] = g
    n_guid = n_guid or max(len(masks), 1)
    mcast = np.zeros((n_guid,), np.uint32)
    mcast[: len(masks)] = np.asarray(masks, np.uint32)
    device = dispatch.resolve_device(device)
    return RoutingTables(*(torch.from_numpy(a).to(device)
                           for a in (dest, guid, mcast.view(np.int32))))


def expand_multicast(event_words: torch.Tensor, masks: torch.Tensor,
                     n_links: int) -> torch.Tensor:
    """Replay events onto local links per multicast mask -> (n_links, n)
    words: link i receives the event iff bit i of its mask is set."""
    links = torch.arange(n_links, dtype=torch.int32, device=masks.device)
    bits = (masks[None, :] >> links[:, None]) & 1
    return torch.where(bits.bool(), event_words[None, :],
                       torch.zeros_like(event_words)[None, :])
