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
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import routing as rt


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

    def local_slice(self, shard: int) -> slice:
        return slice(shard * self.per_shard, (shard + 1) * self.per_shard)


def build_partition(weights: np.ndarray, is_inh: np.ndarray, n_shards: int,
                    delay_exc_steps: int = 15, delay_inh_steps: int = 8) -> Partition:
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
