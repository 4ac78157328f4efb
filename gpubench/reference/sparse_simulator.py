"""The windowed multi-shard simulation over a sparse synapse store, plain
PyTorch: ``simulator.Window`` in the *source* address layout.

It takes only the benchmark's raw inputs (the COO synapses: source and
target ids and weights, the inhibitory-source flags, the configuration)
and works out again, in its own formulation, what the program builds:

* the partition: contiguous equal shards, for each (destination shard,
  source) the list of its synapses there, ascending by target, and the
  fan-out (the destination shards with a list, ascending);
* the source layout: a spike's event word carries its local id; each of
  its ``max_fan`` replicas travels with its destination beside the word;
  rows a credited fabric refused re-enter with their row's destination,
  and the flush's residue keeps its destinations
  (:func:`flush_with_dest`: ``flush.flush_window_plain`` and the residue's
  destinations from the per-destination overflow);
* delivery: for each destination shard the live received events in order,
  row-major over (source shard, slot); each synapse of an event one f32
  add into its ring.  All the window's synapses are listed in that order
  at once; a ring element's k-th add goes into round k, and the rounds
  run one ``index_put_(..., accumulate=True)`` each, whose indices are
  unique, so each element sees its adds one at a time in event order.
  The receiver's source is ``source shard * per + address``.

``precision``: ``"f32"`` (the weights as drawn) or ``"bf16"`` (the
control: the weights rounded to bfloat16 before the adds).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import aggregator, codec, events as ev, flush, lif
from . import simulator as base

PRECISIONS = ("f32", "bf16")


class SourcePendingWindow(NamedTuple):
    data: torch.Tensor          # (S, S, C) int32 events [src, dst, slot]
    meta: torch.Tensor          # (S, S, C) int32 injection steps
    counts: torch.Tensor        # (S, S) int32
    residue: torch.Tensor       # (S, residue) int32 deferred events
    residue_meta: torch.Tensor  # (S, residue) int32
    payload: torch.Tensor       # (S, S, 2C) int32 wire lanes (lo | hi)
    residue_dest: torch.Tensor  # (S, residue) int32 their destinations


class SparseNetwork(NamedTuple):
    per_shard: int
    max_fan: int
    row_ptr: torch.Tensor     # (S, N_pad + 1) int64: [s, g] .. [s, g + 1]
    targets: torch.Tensor     # (n,) int32 target id on its shard
    weights: torch.Tensor     # (n,) f32
    inh_src: torch.Tensor     # (N_pad,) bool
    delays: torch.Tensor      # (S, per) int32 axonal delay in dt steps
    fanout: torch.Tensor      # (S, per, max_fan) int32, -1 pad


def partition(src: torch.Tensor, tgt: torch.Tensor, weight: torch.Tensor,
              is_inh: torch.Tensor, n_shards: int, delay_exc_steps: int = 15,
              delay_inh_steps: int = 8) -> SparseNetwork:
    """The lists by two stable sorts (by target, then by (destination
    shard, source)), their bounds by ``searchsorted``."""
    n = is_inh.shape[0]
    per = -(-n // n_shards)
    n_pad = per * n_shards
    dev = src.device
    order = torch.argsort(tgt, stable=True)
    t_sorted = tgt[order].long()
    key = torch.div(t_sorted, per, rounding_mode="floor") * n_pad \
        + src[order].long()
    second = torch.argsort(key, stable=True)
    order = order[second]
    key = key[second]
    del second
    targets = (tgt[order].long() % per).to(torch.int32)
    weights = weight[order].to(torch.float32)
    del order, t_sorted
    bounds = torch.arange(n_shards * n_pad + 1, device=dev)
    flat = torch.searchsorted(key, bounds)
    del key
    row_ptr = torch.stack([flat[s * n_pad:(s + 1) * n_pad + 1]
                           for s in range(n_shards)])
    hit = (row_ptr[:, 1:] - row_ptr[:, :-1]) > 0            # (S, src)
    n_fan = hit.sum(0)
    max_fan = max(int(n_fan.max()), 1)
    fan_order = torch.argsort((~hit).to(torch.uint8), dim=0,
                              stable=True).T[:, :max_fan]
    fan = torch.arange(max_fan, device=dev)
    fanout = torch.where(fan < n_fan[:, None], fan_order, -1).to(torch.int32)
    inh = torch.zeros((n_pad,), dtype=torch.bool, device=dev)
    inh[:n] = is_inh
    delays = torch.where(inh, delay_inh_steps, delay_exc_steps).to(
        torch.int32)
    return SparseNetwork(per, max_fan, row_ptr.contiguous(), targets,
                         weights, inh, delays.reshape(n_shards, per),
                         fanout.reshape(n_shards, per, max_fan))


def flush_with_dest(words, dest, meta, n_dest: int, capacity: int,
                    residue_len: int):
    """``flush.flush_window_plain`` with per-event destinations, and the
    residue's destinations: the residue is destination-major, so position
    j belongs to the first destination whose cumulated overflow exceeds
    j.  -> (FusedWindow, residue_dest (B, residue_len))."""
    fw = flush.flush_window_plain(words, n_dest, capacity, dest=dest,
                                  meta=meta, residue_len=residue_len,
                                  with_residue_meta=True,
                                  wire_fmt=codec.DEFAULT_WORD)
    valid = ev.is_valid(words) & (dest >= 0) & (dest < n_dest)
    per_dest = torch.stack([(valid & (dest == d)).sum(-1)
                            for d in range(n_dest)], dim=-1)
    excess = torch.clamp(per_dest - capacity, min=0)
    ends = torch.cumsum(excess, -1).contiguous()
    j = torch.arange(residue_len, device=words.device).expand(
        words.shape[0], -1).contiguous()
    owner = torch.searchsorted(ends, j, right=True).to(torch.int32)
    res_dest = torch.where(j < fw.deferred[:, None], owner, 0)
    return fw, res_dest


class SparseWindow(base.Window):
    """The pipelined window of ``cfg`` over ``net`` (a
    :class:`SparseNetwork`), in ``precision``."""

    def __init__(self, cfg: dict, net: SparseNetwork, params,
                 precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        super().__init__(cfg, net, params, "f32")
        self.precision = precision
        self.weights = (net.weights if precision == "f32" else
                        net.weights.to(torch.bfloat16).to(torch.float32))
        S, C = self.S, self.C
        self.row_dest = torch.arange(S, dtype=torch.int32,
                                     device=self.device)[None, :, None] \
            .expand(S, S, C).reshape(S, -1)

    def init(self, v0: torch.Tensor) -> base.Carry:
        c = super().init(v0)
        z = torch.zeros((self.S, self.cfg["residue"]), dtype=torch.int32,
                        device=self.device)
        return c._replace(pending=SourcePendingWindow(*c.pending, z))

    def _apply_events(self, ring_exc, ring_inh, words, counts, t: int):
        """Every synapse of the window's live events, listed in event
        order; an element of the rings (type, slot, shard, target) takes
        its k-th add in round k, and each round is one ``index_put_(...,
        accumulate=True)`` with unique indices, so every element sees its
        adds one at a time, in event order."""
        S, L, net = self.S, self.L, self.net
        per = net.per_shard
        live = (self.slots < counts[..., None]).reshape(S, -1)
        words = words.reshape(S, -1)
        slack = ev.ts_slack(ev.timestamp(words), t & ev.TS_MASK)
        miss = (live & (slack < 0)).sum(1, dtype=torch.int32)
        slot = (t + torch.clamp(slack, min=0)) % L
        addr = ev.address(words)
        ok = live & (addr < per)
        src_shard = torch.arange(words.shape[1], device=self.device) \
            // self.C
        g = torch.where(ok, src_shard[None] * per + addr, 0).long()
        shards = torch.arange(S, device=self.device)[:, None]
        lo = net.row_ptr[shards, g]
        cnt = torch.where(ok, net.row_ptr[shards, g + 1] - lo, 0)
        # event order of a shard: (source shard, slot) row-major; the
        # shards' lists side by side
        cnt, lo = cnt.reshape(-1), lo.reshape(-1)
        m = int(cnt.sum())
        if m == 0:
            return miss
        event = torch.repeat_interleave(torch.arange(cnt.numel(),
                                                     device=self.device), cnt)
        k = torch.arange(m, device=self.device) - torch.repeat_interleave(
            torch.cumsum(cnt, 0) - cnt, cnt)
        idx = lo[event] + k
        shard = event // words.shape[1]
        inh = net.inh_src[g.reshape(-1)[event]].long()
        elem = ((inh * L + slot.reshape(-1)[event]) * S + shard) * per \
            + net.targets[idx].long()
        w = self.weights[idx]
        elem_sorted, order = torch.sort(elem, stable=True)
        first = torch.searchsorted(elem_sorted, elem_sorted)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(m, device=self.device) - first
        both = torch.stack([ring_exc, ring_inh]).reshape(-1)
        for r in range(int(rank.max()) + 1):
            sel = rank == r
            both.index_put_((elem[sel],), w[sel], accumulate=True)
        both = both.reshape((2,) + tuple(ring_exc.shape))
        ring_exc.copy_(both[0])
        ring_inh.copy_(both[1])
        return miss

    def _spikes_to_events(self, spikes, t0: int):
        S, net, e_max = self.S, self.net, self.cfg["e_max"]
        F = net.max_fan
        _, w, per = spikes.shape
        flat = spikes.reshape(S, w * per)
        order = torch.sort((~flat).to(torch.uint8), dim=-1,
                           stable=True).indices[:, :e_max]
        sel = torch.gather(flat, 1, order)
        sel_step = (order // per).to(torch.int32)
        sel_id = order % per
        fired = flat.sum(-1, dtype=torch.int32)
        lost = torch.clamp(fired - e_max, min=0)
        ts = (t0 + sel_step + torch.gather(net.delays, 1, sel_id)) & ev.TS_MASK
        words = ev.pack(sel_id.repeat_interleave(F, -1),
                        ts.repeat_interleave(F, -1),
                        valid=sel.repeat_interleave(F, -1))
        dest = torch.gather(net.fanout, 1, sel_id[..., None].expand(
            -1, -1, F)).reshape(S, -1)
        inject = (t0 + sel_step).repeat_interleave(F, -1)
        return words, inject, lost, fired, dest

    def step(self, carry: base.Carry, t: int, drive: torch.Tensor):
        state, pend, lstate = carry
        S, C = self.S, self.C
        out = self.backend.exchange(lstate, pend.payload, pend.counts,
                                    enforce_credits=True)
        recv, rmeta = codec.decode_planar(out.recv_payload)
        lat = self._latency(t, rmeta, out.recv_counts, out.queue_us.T)
        miss = self._apply_events(state.ring_exc, state.ring_inh, recv,
                                  out.recv_counts, t)
        neuron, spikes = lif.window(state.neuron, self.params,
                                    state.ring_exc, state.ring_inh, t, drive)
        words, inject, lost, fired, dest = self._spikes_to_events(spikes, t)
        if self.can_defer:
            held = (~out.sent_mask[..., None]) & (
                self.slots < pend.counts[..., None])
            words = torch.cat([torch.where(held, pend.data, 0).reshape(S, -1),
                               pend.residue, words], dim=-1)
            inject = torch.cat([torch.where(held, pend.meta, 0).reshape(
                S, -1), pend.residue_meta, inject], dim=-1)
            dest = torch.cat([self.row_dest, pend.residue_dest, dest], dim=-1)
        else:
            words = torch.cat([pend.residue, words], dim=-1)
            inject = torch.cat([pend.residue_meta, inject], dim=-1)
            dest = torch.cat([pend.residue_dest, dest], dim=-1)
        fw, res_dest = flush_with_dest(words, dest, inject, S, C,
                                       self.cfg["residue"])
        b = fw.buckets
        cost = aggregator.window_cost(b.counts.masked_fill(self.own, 0))
        stats = base.WindowStats(
            spikes=fired, events_sent=b.counts.sum(-1, dtype=torch.int32),
            overflow=lost + fw.dropped, wire_bytes=cost.bytes,
            deadline_miss=miss, offered=fw.offered, deferred=fw.deferred,
            link=out.stats, latency=lat)
        state = base.ShardState(neuron, state.ring_exc, state.ring_inh,
                                state.t + self.cfg["window"])
        pend = SourcePendingWindow(b.data, b.guids, b.counts, fw.residue,
                                   fw.residue_meta, fw.payload, res_dest)
        return base.Carry(state, pend, out.state), stats
