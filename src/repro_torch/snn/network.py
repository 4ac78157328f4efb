"""Multi-wafer partitioning of a spiking network (port of
``src/repro/snn/network.py``; numpy only, paper Fig. 1 topology).

Neurons are assigned contiguously to shards ("wafer-FPGA groups"); the
host-side builder derives, per source neuron, the list of destination
shards whose neurons it synapses onto — each spike becomes one Extoll event
*per destination shard* (the paper's unicast-to-FPGA + local GUID multicast
scheme: inter-wafer fan-out is realized by sending one event per target
FPGA, intra-FPGA fan-out by the destination's multicast mask).

Also computes the routing tables (``repro_torch.core.routing``) and the
traffic matrix of the torus link-load model.

Two layouts of the 14-bit event address (``core/events.py``):

* the *replica* layout of a dense :class:`Partition` (the reference's):
  ``addr = local_id * max_fan + k`` for replica k, routed through each
  shard's destination table.  It needs ``per_shard * max_fan`` addresses;
* the *source* layout of a :class:`SparsePartition`: the address is the
  source's local id alone, and each replica travels with its destination
  ``fanout[source, k]`` beside the word.  It needs ``per_shard``
  addresses, so the full-scale microcircuit over 8 shards (9,647 a shard,
  fan-out 8) fits where the replica layout (77,176) does not.

A partition whose layout does not fit the field raises when it is built
(:func:`check_address_layout`); ``events.pack`` would mask the address
and alias sources without a word.

A sparse store may hold multapses (several synapses of one source onto
one target, each its own entry, in the order they were drawn), and a
network with plastic synapses keeps them apart from the static ones
(:func:`build_indegree_partition`, NEST's HPC benchmark: fixed in-degree,
plastic E->E): :class:`PlasticLists` hold their targets, and their
weights are simulation state (``snn/simulator.py``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import events as ev, routing as rt


@dataclasses.dataclass
class Partition:
    """Host-side partition plan for S shards over N neurons."""

    n_shards: int
    n_neurons: int
    per_shard: int                 # neurons per shard (padded equal split)
    fanout: np.ndarray             # (N, max_fanout) destination shards, -1 pad
    weights: np.ndarray            # (N, N) dense synaptic matrix [pA]
    is_inh: np.ndarray             # (N,) inhibitory-source flag
    delays_steps: np.ndarray       # (N,) axonal delay in dt steps per source

    def __post_init__(self):
        check_address_layout("replica", self.per_shard, self.fanout.shape[1])

    def local_slice(self, shard: int) -> slice:
        return slice(shard * self.per_shard, (shard + 1) * self.per_shard)


def check_address_layout(layout: str, per_shard: int, max_fan: int = 1):
    """Raise ``ValueError`` naming the sizes when the ``layout``'s
    addresses (``"replica"``: ``per_shard * max_fan``; ``"source"``:
    ``per_shard``) do not fit the event word's address field."""
    need = per_shard * max_fan if layout == "replica" else per_shard
    if need > ev.ADDR_MASK + 1:
        how = (f"{per_shard} neurons a shard x fan-out {max_fan}"
               if layout == "replica" else f"{per_shard} neurons a shard")
        raise ValueError(
            f"the {layout} address layout needs {need} addresses "
            f"({how}), more than the {ev.ADDR_BITS}-bit address field's "
            f"{ev.ADDR_MASK + 1}: use more shards"
            + (" or the sparse partition's source layout"
               if layout == "replica" else ""))


def build_partition(weights: np.ndarray, is_inh: np.ndarray, n_shards: int,
                    delay_exc_steps: int = 15, delay_inh_steps: int = 8) -> Partition:
    """Dense partition in the replica layout; raises (``Partition``, on
    any construction) when ``per_shard x max_fan`` exceeds the 14-bit
    address field."""
    n = weights.shape[0]
    per = -(-n // n_shards)                   # ceil split
    n_pad = per * n_shards
    if n_pad != n:
        wpad = np.zeros((n_pad, n_pad), weights.dtype)
        wpad[:n, :n] = weights
        weights = wpad
        is_inh = np.pad(is_inh, (0, n_pad - n))
    # fanout: shards having any nonzero weight from source j, ascending
    # (the reference loops over sources with np.unique; this is the same
    # table in one pass over the matrix)
    hit = (weights != 0.0).reshape(n_shards, per, n_pad).any(axis=1)
    n_fan = hit.sum(axis=0)
    max_fan = max(int(n_fan.max()), 1)
    order = np.argsort(~hit, axis=0, kind="stable").T[:, :max_fan]
    fanout = np.where(np.arange(max_fan)[None, :] < n_fan[:, None], order,
                      -1).astype(np.int32)
    delays = np.where(is_inh, delay_inh_steps, delay_exc_steps).astype(np.int32)
    return Partition(
        n_shards=n_shards, n_neurons=n_pad, per_shard=per,
        fanout=fanout, weights=weights.astype(np.float32),
        is_inh=is_inh.astype(bool), delays_steps=delays,
    )


def shard_arrays(p: Partition):
    """Per-shard device arrays, stacked over a leading shard dim:

    w_local   (S, per, N)        rows owned by each shard
    fan_local (S, per, F)        destination shards per local source neuron
    delay_local (S, per)
    """
    S, per, n = p.n_shards, p.per_shard, p.n_neurons
    w_local = p.weights.reshape(S, per, n)
    fan_local = p.fanout.reshape(S, per, -1)
    delay_local = p.delays_steps.reshape(S, per)
    return w_local, fan_local, delay_local


def traffic_matrix(p: Partition, rates_hz: np.ndarray, event_bytes: int = 4):
    """(S, S) expected bytes/s between shards for given per-neuron rates."""
    S = p.n_shards
    m = np.zeros((S, S))
    shard_of = np.arange(p.n_neurons) // p.per_shard
    for j in range(min(len(rates_hz), p.n_neurons)):
        s = shard_of[j]
        for d in p.fanout[j]:
            if d >= 0 and d != s:
                m[s, d] += rates_hz[j] * event_bytes
    return m


def routing_tables_for_shard(p: Partition, shard: int, n_links: int = 8, *,
                             device=None):
    """Paper-faithful tables: one projection per (local source, dest shard).

    A source with fan-out to k shards emits k events; the replica index is
    folded into the event address (addr = local_id * max_fan + replica,
    fitting the 14-bit address field — the paper's 12-bit pulse address +
    link id).  The destination multicast mask replays the event on local
    'HICANN link' (src global id mod n_links), standing in for the wafer's
    8 links.
    """
    per = p.per_shard
    max_fan = p.fanout.shape[1]
    projs = []
    for a in range(per):
        g = shard * per + a
        for k, d in enumerate(p.fanout[g]):
            if d >= 0:
                addr = a * max_fan + k
                projs.append(rt.Projection(addr, addr + 1, int(d), [g % n_links]))
    return rt.build_tables(per * max_fan,
                           projs or [rt.Projection(0, 0, 0, [0])],
                           n_guid=max(len(projs), 1), device=device)


class SynapseStore(NamedTuple):
    """The synapses of a :class:`SparsePartition` on the device, one list
    per (destination shard ``s``, global source ``g``): entries
    ``row_ptr[s, g]`` to ``row_ptr[s, g + 1]`` of ``targets`` / ``weights``,
    ascending by target, at most one per (source, target) (a
    :class:`MultapseStore` may repeat one).  ``count`` is the one-element
    counter of synaptic adds that delivery increments."""

    row_ptr: torch.Tensor     # (S, N + 1) int64 offsets into the lists
    targets: torch.Tensor     # (n_synapses,) int32 target id on shard s
    weights: torch.Tensor     # (n_synapses,) f32 [pA]
    count: torch.Tensor       # (1,) int64 synaptic adds delivered
    multapses = False         # may a list repeat a target?


class MultapseStore(SynapseStore):
    """A :class:`SynapseStore` whose lists may repeat a target
    (multapses): each synapse its own entry, the repeats in the order
    they were drawn."""

    __slots__ = ()
    multapses = True


class PlasticLists(NamedTuple):
    """The plastic synapses of a :class:`SparsePartition`, laid out as a
    :class:`SynapseStore`'s lists (by destination shard and source,
    ascending by target, multapses in draw order) without weights: entry
    ``j``'s weight is element ``j`` of the simulation's plastic weights."""

    row_ptr: torch.Tensor     # (S, N + 1) int64
    targets: torch.Tensor     # (n_plastic,) int32 target id on shard s
    longest: int = 0          # the longest list's length


class StdpStore(NamedTuple):
    """What delivery reads in a network with plastic synapses: the static
    store and the plastic lists."""

    static: SynapseStore
    plastic: PlasticLists


@dataclasses.dataclass
class SparsePartition:
    """Partition plan in the source layout with a sparse synapse store
    (built on the store's device by :func:`build_sparse_partition`)."""

    n_shards: int
    n_neurons: int                 # padded: per_shard * n_shards
    per_shard: int
    n_synapses: int
    fanout: torch.Tensor           # (N, max_fan) int32 destination shards,
                                   #   ascending, -1 pad
    store: SynapseStore
    is_inh: np.ndarray             # (N,) inhibitory-source flag
    delays_steps: np.ndarray       # (N,) axonal delay in dt steps
    plastic: PlasticLists | None = None
    plastic_weights: torch.Tensor | None = None   # (n_plastic,) f32 initial


def build_sparse_partition(src: torch.Tensor, tgt: torch.Tensor,
                           weight: torch.Tensor, is_inh: np.ndarray,
                           n_shards: int, delay_exc_steps: int = 15,
                           delay_inh_steps: int = 8) -> SparsePartition:
    """Sparse partition from COO synapses (``src``, ``tgt`` global neuron
    ids, ``weight`` [pA], at most one per pair), built on their device:
    one sort of a (destination shard, source, target) key orders every
    list by target; the fan-out is the destination shards with a list.
    Raises when ``per_shard`` exceeds the 14-bit address field."""
    n = len(is_inh)
    per = -(-n // n_shards)
    n_pad = per * n_shards
    check_address_layout("source", per)
    dev = src.device
    tgt = tgt.long()
    dst = torch.div(tgt, per, rounding_mode="floor")
    key = (dst * n_pad + src.long()) * per + (tgt - dst * per)
    del dst, tgt
    key, order = torch.sort(key)
    weights = weight.to(torch.float32)[order]
    del order
    row = torch.div(key, per, rounding_mode="floor")      # s * n_pad + g
    targets = (key - row * per).to(torch.int32)
    del key
    lens = torch.bincount(row, minlength=n_shards * n_pad)
    del row
    ends = torch.cumsum(lens, 0)
    flat_ptr = torch.cat([ends.new_zeros(1), ends])
    del ends
    # (S, n_pad + 1): [s, g] the start of (s, g)'s list, [s, n_pad] the end
    # of shard s's lists
    row_ptr = flat_ptr[torch.arange(n_shards, device=dev)[:, None] * n_pad
                       + torch.arange(n_pad + 1, device=dev)]
    hit = lens.reshape(n_shards, n_pad) > 0                   # (S, src)
    n_fan = hit.sum(0)
    max_fan = max(int(n_fan.max()), 1)
    order = torch.argsort((~hit).to(torch.uint8), dim=0,
                          stable=True).T[:, :max_fan]
    fan = torch.arange(max_fan, device=dev)
    fanout = torch.where(fan < n_fan[:, None], order, -1).to(torch.int32)
    inh = np.pad(np.asarray(is_inh, bool), (0, n_pad - n))
    delays = np.where(inh, delay_inh_steps, delay_exc_steps).astype(np.int32)
    store = SynapseStore(row_ptr, targets, weights,
                         torch.zeros(1, dtype=torch.int64, device=dev))
    return SparsePartition(
        n_shards=n_shards, n_neurons=n_pad, per_shard=per,
        n_synapses=int(targets.numel()), fanout=fanout.contiguous(),
        store=store, is_inh=inh, delays_steps=delays)


def _shard_lists(g: torch.Tensor, x: torch.Tensor, per: int, n_pad: int):
    """One destination shard's lists from its synapses' sources ``g`` and
    local targets ``x`` (in draw order): a stable sort of (source,
    target) -> (the order, targets int32, list lengths (n_pad,), whether
    a pair repeats)."""
    wide = n_pad * per >= 1 << 31
    key = g.to(torch.int64 if wide else torch.int32) * per + x
    key, order = torch.sort(key, stable=True)
    repeats = bool((key[1:] == key[:-1]).any()) if key.numel() > 1 \
        else False
    src = torch.div(key, per, rounding_mode="floor")
    targets = (key - src * per).to(torch.int32)
    lens = torch.bincount(src.long(), minlength=n_pad)
    return order, targets, lens, repeats


def build_indegree_partition(sources: torch.Tensor, is_inh: np.ndarray,
                             n_shards: int, w_exc: float, w_inh: float,
                             delay_steps: int) -> SparsePartition:
    """Sparse partition of a fixed in-degree network, built on the
    device one destination shard at a time (no sort of the whole
    network): ``sources`` (N, K) int32 lists target i's K sources in the
    order they were drawn (multapses allowed); a synapse from an
    excitatory source weighs ``w_exc``, from an inhibitory one ``w_inh``
    [pA]; every delay is ``delay_steps``.  The excitatory -> excitatory
    synapses are plastic (:class:`PlasticLists`, their initial weights
    ``w_exc``) and the store holds the rest (a :class:`MultapseStore`
    when one of its lists repeats a target).
    Raises when ``per_shard`` exceeds the 14-bit address field."""
    n, k = sources.shape
    per = -(-n // n_shards)
    n_pad = per * n_shards
    check_address_layout("source", per)
    dev = sources.device
    inh = np.pad(np.asarray(is_inh, bool), (0, n_pad - n))
    inh_t = torch.from_numpy(inh).to(dev)
    n_p = n_s = 0                    # a first pass counts, to size the lists
    for s in range(n_shards):
        rows = sources[s * per:min((s + 1) * per, n)]
        x = torch.arange(rows.shape[0], device=dev).repeat_interleave(k)
        m = int((~inh_t[rows.reshape(-1).long()] & ~inh_t[s * per + x]).sum())
        n_p += m
        n_s += x.numel() - m
        del x
    targets_p = torch.empty((n_p,), dtype=torch.int32, device=dev)
    targets_s = torch.empty((n_s,), dtype=torch.int32, device=dev)
    weights_s = torch.empty((n_s,), dtype=torch.float32, device=dev)
    lens_p = torch.zeros((n_shards, n_pad), dtype=torch.int64, device=dev)
    lens_s = torch.zeros((n_shards, n_pad), dtype=torch.int64, device=dev)
    at_p = at_s = 0
    multapses = False
    for s in range(n_shards):
        rows = sources[s * per:min((s + 1) * per, n)]
        x = torch.arange(rows.shape[0], device=dev).repeat_interleave(k)
        g = rows.reshape(-1).long()
        plastic = ~inh_t[g] & ~inh_t[s * per + x]
        _, t_p, lens, _ = _shard_lists(g[plastic], x[plastic], per, n_pad)
        targets_p[at_p:at_p + t_p.numel()] = t_p
        lens_p[s] = lens
        at_p += t_p.numel()
        del t_p
        keep = ~plastic
        gs = g[keep]
        order, t_s, lens, rep = _shard_lists(gs, x[keep], per, n_pad)
        del x, keep
        targets_s[at_s:at_s + t_s.numel()] = t_s
        weights_s[at_s:at_s + t_s.numel()] = torch.where(
            inh_t[gs[order]], w_inh, w_exc).to(torch.float32)
        lens_s[s] = lens
        at_s += t_s.numel()
        multapses |= rep
        del order, t_s, gs, g, plastic

    def row_ptr(lens):
        ends = torch.cumsum(lens.reshape(-1), 0)
        flat = torch.cat([ends.new_zeros(1), ends])
        return flat[torch.arange(n_shards, device=dev)[:, None] * n_pad
                    + torch.arange(n_pad + 1, device=dev)].contiguous()

    hit = (lens_p + lens_s) > 0                             # (S, src)
    n_fan = hit.sum(0)
    max_fan = max(int(n_fan.max()), 1)
    order = torch.argsort((~hit).to(torch.uint8), dim=0,
                          stable=True).T[:, :max_fan]
    fan = torch.arange(max_fan, device=dev)
    fanout = torch.where(fan < n_fan[:, None], order, -1).to(torch.int32)
    store = (MultapseStore if multapses else SynapseStore)(
        row_ptr(lens_s), targets_s, weights_s,
        torch.zeros(1, dtype=torch.int64, device=dev))
    plastic = PlasticLists(row_ptr(lens_p), targets_p, int(lens_p.max()))
    return SparsePartition(
        n_shards=n_shards, n_neurons=n_pad, per_shard=per,
        n_synapses=n_s, fanout=fanout.contiguous(), store=store,
        is_inh=inh, delays_steps=np.full(n_pad, delay_steps, np.int32),
        plastic=plastic,
        plastic_weights=torch.full((n_p,), w_exc, dtype=torch.float32,
                                   device=dev))

