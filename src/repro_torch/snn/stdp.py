"""Spike-timing-dependent plasticity of the sparse store's plastic lists:
NEST's ``stdp_pl_synapse_hom`` (Morrison, Aertsen & Diesmann 2007, Neural
Comput. 19(6):1437-1467), the HPC benchmark's E->E rule, with the whole
delay dendritic.

The state (:class:`PlasticState`, part of the simulator's carry): the
plastic weights, each source's presynaptic trace K+ and last spike per
destination shard (a spike the fabric dropped, or delivered past its
deadline, never reaches that shard), each neuron's post-spike archive
(``snn.lif.PostArchive``, written by the alpha LIF window) and per shard
the counters :data:`COUNTERS`.

A delivered event of source g with spike step t_spike updates each
plastic synapse of g's list before its add, as NEST's ``send`` does
(:func:`rule`); then K+ = K+ e^{-(t_spike - t_last) dt / tau_plus} + 1
and t_last = t_spike.  Every decay is an entry of one f32 table
(``snn.lif.decay_table``) indexed by the step difference, clamped to
[0, len); a source's first event on a shard facilitates nothing (its K+
is 0).  The kernel (``csrc/synapse_deliver.cu``) and the plain version
(``kernels/synapse_deliver.py``) compute the same f32 operations in the
same order, w^mu as the double ``pow`` rounded to f32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.snn import lif

COUNTERS = ("updates", "facilitations", "clipped", "history_short",
            "entries_read")
"""Per shard: plastic updates (a synapse and an event), facilitation
terms, depressions clipped at 0, updates whose archive walk reached past
the oldest kept entry, archive entries the walks read."""


class StdpParams(NamedTuple):
    """``stdp_pl_synapse_hom``'s constants (NEST's HPC benchmark's:
    ``snn.hpc_benchmark.STDP``); delays in dt steps, times in ms."""

    lam: float
    alpha: float
    mu: float
    tau_plus: float
    tau_minus: float
    delay_steps: int               # the dendritic delay d
    history: int                   # archive entries a neuron (H)

    def f32(self) -> tuple[float, float]:
        """(lambda, lambda * alpha) rounded to f32, as the rule uses
        them."""
        return (float(np.float32(self.lam)),
                float(np.float32(self.lam * self.alpha)))


class PlasticState(NamedTuple):
    weights: torch.Tensor          # (n_plastic,) f32 [pA]
    kplus: torch.Tensor            # (S, N) f32 trace of source g on shard s
    t_last: torch.Tensor           # (S, N) int32 its last spike, -1 none
    archive: lif.PostArchive       # (S, per, H) entries, (S, per) counts
    counts: torch.Tensor           # (S, len(COUNTERS)) int64


def init_plastic(weights: torch.Tensor, n_shards: int, per: int,
                 params: StdpParams) -> PlasticState:
    """A fresh state over the initial ``weights`` (copied)."""
    dev = weights.device
    n = n_shards * per
    return PlasticState(
        weights.clone(),
        torch.zeros((n_shards, n), dtype=torch.float32, device=dev),
        torch.full((n_shards, n), -1, dtype=torch.int32, device=dev),
        lif.init_archive((n_shards, per), params.history, device=dev),
        torch.zeros((n_shards, len(COUNTERS)), dtype=torch.int64,
                    device=dev))


def clone(state: PlasticState) -> PlasticState:
    return PlasticState(state.weights.clone(), state.kplus.clone(),
                        state.t_last.clone(),
                        lif.PostArchive(*(x.clone() for x in state.archive)),
                        state.counts.clone())


def rule(w, t_spike, kplus, t_last, steps, kminus, n, params: StdpParams,
         plus: torch.Tensor, minus: torch.Tensor):
    """One event's update of a batch of synapses, plain PyTorch: ``w``
    (m,) f32, the event's ``t_spike`` and its source's ``kplus`` /
    ``t_last`` before it, (m,) each; the target's archive rows ``steps``
    / ``kminus`` (m, H) and spike count ``n`` (m,).  -> (w', each
    synapse's counters (m, len(COUNTERS)) int64).

    The archive is walked newest first until an entry at or before
    min(t1, t2 - 1), t1 = t_last - d (t2 for a first event), t2 = t_spike
    - d, or past the oldest kept entry (history_short when entries were
    overwritten); the entries in (t1, t2] facilitate, oldest first, and
    the newest before t2 depresses."""
    d, H = params.delay_steps, steps.shape[-1]
    lam, lam_alpha = params.f32()
    L = plus.numel()
    dev = w.device
    n = n.long()
    t2 = t_spike.long() - d
    tl = t_last.long()
    t1 = torch.where(tl < 0, t2, tl - d)
    lim = torch.minimum(t1, t2 - 1)
    oldest = torch.clamp(n - H, min=0)
    rows = torch.arange(w.numel(), device=dev)
    i = n - 1
    dep = torch.full_like(n, -1)
    stopped = torch.zeros_like(n, dtype=torch.bool)
    reads = torch.zeros_like(n)
    walk = i >= oldest
    while bool(walk.any()):
        st = steps[rows, torch.remainder(i, H)].long()
        reads += walk
        dep = torch.where(walk & (dep < 0) & (st < t2), i, dep)
        stop = walk & (st <= lim)
        stopped |= stop
        i = torch.where(walk & ~stop, i - 1, i)
        walk = walk & ~stop & (i >= oldest)
    short = ~stopped & (n > H)
    k = i + 1
    fac = torch.zeros_like(n)
    go = k < n
    while bool(go.any()):
        st = steps[rows, torch.remainder(k, H)].long()
        go = go & (st <= t2)
        use = go & (st > t1)
        kt = kplus * plus[torch.clamp(st + d - tl, 0, L - 1)]
        pw = torch.pow(w.double(), params.mu).float()
        w = torch.where(use, w + lam * pw * kt, w)
        fac += use
        k = k + 1
        go = go & (k < n)
    has = dep >= 0
    at = torch.remainder(dep, H)
    km = kminus[rows, at] * minus[torch.clamp(
        t2 - steps[rows, at].long(), 0, L - 1)]
    wn = w - lam_alpha * w * km
    clip = has & (wn < 0)
    w = torch.where(has, torch.where(wn < 0, torch.zeros_like(wn), wn), w)
    return w, torch.stack([torch.ones_like(n), fac, clip.long(),
                           short.long(), reads], dim=-1)
