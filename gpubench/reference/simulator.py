"""The windowed multi-shard simulation, plain PyTorch (frozen from the
port's ``snn/simulator.py``: ``make_pipeline_fns`` without fault injection
or the flight recorder, every kernel replaced by its plain version).

It takes only the benchmark's raw inputs (the dense (N, N) weight matrix,
the inhibitory-source flags, the configuration) and works the partition,
the delivery layout and the routing table out again.  ``Window.segment``
follows one segment of windows from a given carry, so it can start from
its own initial state or from a state the program under test reached.

``precision`` selects the arithmetic of delivery, the one matrix product
of a window: ``"f32"`` (IEEE float32, TF32 off, what the configuration
states) or ``"tf32"`` (the control: the same product on the tensor cores'
TF32 inputs).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import aggregator, codec, events as ev, flush, latency, lif
from .alltoall import AllToAllTransport
from .torus import Torus3DTransport
from .transport_base import FabricState, LinkStats

PRECISIONS = ("f32", "tf32")


class ShardState(NamedTuple):
    neuron: lif.LIFState      # (S, per) per field
    ring_exc: torch.Tensor    # (ring_len, S, per)
    ring_inh: torch.Tensor    # (ring_len, S, per)
    t: torch.Tensor           # (S,) int32 global step


class PendingWindow(NamedTuple):
    data: torch.Tensor          # (S, S, C) int32 events [src, dst, slot]
    meta: torch.Tensor          # (S, S, C) int32 injection steps
    counts: torch.Tensor        # (S, S) int32
    residue: torch.Tensor       # (S, residue) int32 deferred events
    residue_meta: torch.Tensor  # (S, residue) int32
    payload: torch.Tensor       # (S, S, 2C) int32 wire lanes (lo | hi)


class WindowStats(NamedTuple):
    spikes: torch.Tensor
    events_sent: torch.Tensor
    overflow: torch.Tensor
    wire_bytes: torch.Tensor
    deadline_miss: torch.Tensor
    offered: torch.Tensor
    deferred: torch.Tensor
    link: LinkStats
    latency: latency.LatencySummary


class Carry(NamedTuple):
    state: ShardState
    pending: PendingWindow
    link: FabricState


class Network(NamedTuple):
    """The partition the reference derives from the raw inputs."""

    per_shard: int
    max_fan: int
    weights_t: torch.Tensor   # (S, N_pad, per): [s, src, i] = W[s*per+i, src]
    inh_src: torch.Tensor     # (N_pad,) bool
    delays: torch.Tensor      # (S, per) int32 axonal delay in dt steps
    dest_of_addr: torch.Tensor  # (S, per * max_fan) int32 destination shard


def partition(weights: torch.Tensor, is_inh: torch.Tensor, n_shards: int,
              delay_exc_steps: int = 15, delay_inh_steps: int = 8
              ) -> Network:
    """Contiguous equal shards (the last padded), one event per
    (spiking source, destination shard with a synapse of it), the replica
    index folded into the address: ``addr = local_id * max_fan + k``."""
    n = weights.shape[0]
    per = -(-n // n_shards)
    n_pad = per * n_shards
    w = torch.zeros((n_pad, n_pad), dtype=torch.float32,
                    device=weights.device)
    w[:n, :n] = weights
    inh = torch.zeros((n_pad,), dtype=torch.bool, device=weights.device)
    inh[:n] = is_inh
    hit = (w != 0).reshape(n_shards, per, n_pad).any(1)      # (S, src)
    n_fan = hit.sum(0)
    max_fan = max(int(n_fan.max()), 1)
    order = torch.argsort((~hit).to(torch.uint8), dim=0,
                          stable=True).T[:, :max_fan]
    fan = torch.arange(max_fan, device=w.device)
    fanout = torch.where(fan < n_fan[:, None], order, -1).to(torch.int32)
    delays = torch.where(inh, delay_inh_steps, delay_exc_steps).to(
        torch.int32)
    weights_t = w.reshape(n_shards, per, n_pad).transpose(1, 2).contiguous()
    del w
    return Network(per, max_fan, weights_t, inh,
                   delays.reshape(n_shards, per),
                   fanout.reshape(n_shards, per * max_fan))


def create_transport(cfg: dict, n_shards: int):
    """The fabric of ``cfg`` (the simulator's transport fields)."""
    fmt = cfg["wire_format"]
    if cfg["transport"] == "alltoall":
        return AllToAllTransport(n_shards, wire_format=fmt)
    if cfg["transport"] == "torus3d":
        return Torus3DTransport(
            n_shards, nx=cfg["torus_nx"], ny=cfg["torus_ny"],
            nz=cfg["torus_nz"], link_credits=cfg["link_credits"],
            notify_latency=cfg["notify_latency"],
            max_row_events=cfg["capacity"], wire_format=fmt)
    raise ValueError(f"unknown transport {cfg['transport']!r}")


class Window:
    """The pipelined window of ``cfg`` (a dict with the simulator's
    fields: ``n_shards``, ``window``, ``ring_len``, ``e_max``,
    ``capacity``, ``residue``, the transport fields and ``step_us``) over
    ``net``."""

    def __init__(self, cfg: dict, net: Network, params: lif.LIFParams,
                 precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.cfg, self.net, self.params = cfg, net, params
        self.precision = precision
        S, C = cfg["n_shards"], cfg["capacity"]
        dev = net.delays.device
        self.S, self.C, self.L = S, C, cfg["ring_len"]
        self.backend = create_transport(cfg, S)
        self.can_defer = (cfg["transport"] == "torus3d"
                          and cfg["link_credits"] > 0)
        self.hops = self.backend.route_hops(device=dev)
        self.own = torch.eye(S, dtype=torch.bool, device=dev)
        self.slots = torch.arange(C, dtype=torch.int32, device=dev)
        self.ring_slots = torch.arange(self.L, dtype=torch.int32, device=dev)
        self.fan = torch.arange(net.max_fan, dtype=torch.int32, device=dev)
        self.src_base = (torch.arange(S, dtype=torch.int32, device=dev)[:, None]
                         * net.per_shard)
        self.shard_ix = torch.arange(S, device=dev)[:, None]
        self.device = dev

    def init(self, v0: torch.Tensor) -> Carry:
        """Potentials ``v0`` (S, per), empty rings, buckets and fabric."""
        S, C, dev = self.S, self.C, self.device
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
        ring = torch.zeros((self.L, S, self.net.per_shard),
                           dtype=torch.float32, device=dev)
        state = ShardState(lif.init_state(v0.clone()), ring, ring.clone(),
                           z(S))
        pend = PendingWindow(z(S, S, C), z(S, S, C), z(S, S),
                             z(S, self.cfg["residue"]),
                             z(S, self.cfg["residue"]), z(S, S, 2 * C))
        return Carry(state, pend, self.backend.init_state(2 * C, device=dev))

    def _latency(self, t: int, recv_meta, counts, queue_us):
        live = self.slots < counts[..., None]
        wait_us = (t - recv_meta).to(torch.float32) * self.cfg["step_us"]
        hop_us = latency.hop_latency_us(self.backend.wire_fmt, counts,
                                        self.hops) + queue_us
        lat = torch.clamp(wait_us, min=0.0) + hop_us[..., None]
        return latency.summarize_latency(lat, live, batch_dims=1)

    def _apply_events(self, ring_exc, ring_inh, words, counts, t: int):
        """Scatter the weighted input of received events (S, S_src, C) into
        the delay rings (in place) -> (S,) deadline misses."""
        S, L, net = self.S, self.L, self.net
        live = self.slots < counts[..., None]
        src = self.src_base + ev.address(words) // net.max_fan
        slack = ev.ts_slack(ev.timestamp(words), t & ev.TS_MASK)
        miss = (live & (slack < 0)).sum((1, 2), dtype=torch.int32)
        slot = (t + torch.clamp(slack, min=0)) % L
        flat_live = live.reshape(S, -1)
        flat_src = torch.where(flat_live, src.reshape(S, -1), 0).long()
        rows = net.weights_t[self.shard_ix, flat_src]        # (S, E, per)
        inh = net.inh_src[flat_src] & flat_live
        onehot = (slot.reshape(S, -1)[..., None] == self.ring_slots).to(
            torch.float32)
        lhs = torch.cat([onehot * (flat_live & ~inh)[..., None],
                         onehot * inh[..., None]], dim=-1)   # (S, E, 2L)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.precision == "tf32"
        try:
            acc = torch.bmm(lhs.transpose(1, 2), rows)       # (S, 2L, per)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        ring_exc += acc[:, :L].transpose(0, 1)
        ring_inh += acc[:, L:].transpose(0, 1)
        return miss

    def _spikes_to_events(self, spikes, t0: int):
        S, net, e_max = self.S, self.net, self.cfg["e_max"]
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
        addr = (sel_id.to(torch.int32)[..., None] * net.max_fan
                + self.fan).reshape(S, -1)
        words = ev.pack(addr, ts.repeat_interleave(net.max_fan, -1),
                        valid=sel.repeat_interleave(net.max_fan, -1))
        inject = (t0 + sel_step).repeat_interleave(net.max_fan, -1)
        return words, inject, lost, fired

    def step(self, carry: Carry, t: int, drive: torch.Tensor):
        """One window at global step ``t`` -> (carry, WindowStats); the
        carry's rings are updated in place."""
        state, pend, lstate = carry
        S, C = self.S, self.C
        out = self.backend.exchange(lstate, pend.payload, pend.counts,
                                    enforce_credits=True)
        recv, rmeta = codec.decode_planar(out.recv_payload)
        lat = self._latency(t, rmeta, out.recv_counts, out.queue_us.T)
        miss = self._apply_events(state.ring_exc, state.ring_inh, recv,
                                  out.recv_counts, t)
        neuron, spikes = lif.window(state.neuron, self.params,
                                    state.ring_exc, state.ring_inh, t,
                                    drive)
        words, inject, lost, fired = self._spikes_to_events(spikes, t)
        if self.can_defer:
            held = (~out.sent_mask[..., None]) & (
                self.slots < pend.counts[..., None])
            words = torch.cat([torch.where(held, pend.data, 0).reshape(S, -1),
                               pend.residue, words], dim=-1)
            inject = torch.cat([torch.where(held, pend.meta, 0).reshape(
                S, -1), pend.residue_meta, inject], dim=-1)
        else:
            words = torch.cat([pend.residue, words], dim=-1)
            inject = torch.cat([pend.residue_meta, inject], dim=-1)
        fw = flush.flush_window_plain(
            words, S, C, dest_lut=self.net.dest_of_addr, meta=inject,
            residue_len=self.cfg["residue"], with_residue_meta=True,
            wire_fmt=codec.DEFAULT_WORD)
        b = fw.buckets
        cost = aggregator.window_cost(b.counts.masked_fill(self.own, 0))
        stats = WindowStats(
            spikes=fired, events_sent=b.counts.sum(-1, dtype=torch.int32),
            overflow=lost + fw.dropped, wire_bytes=cost.bytes,
            deadline_miss=miss, offered=fw.offered, deferred=fw.deferred,
            link=out.stats, latency=lat)
        state = ShardState(neuron, state.ring_exc, state.ring_inh,
                           state.t + self.cfg["window"])
        pend = PendingWindow(b.data, b.guids, b.counts, fw.residue,
                             fw.residue_meta, fw.payload)
        return Carry(state, pend, out.state), stats

    def segment(self, carry: Carry, drive: torch.Tensor):
        """``drive.shape[0]`` windows from ``carry`` (copied, never
        modified) -> (carry, [WindowStats per window])."""
        state = carry.state
        state = state._replace(ring_exc=state.ring_exc.clone(),
                               ring_inh=state.ring_inh.clone())
        carry = carry._replace(state=state)
        t = int(state.t[0])
        rows = []
        for k in range(drive.shape[0]):
            carry, stats = self.step(carry, t, drive[k])
            rows.append(stats)
            t += self.cfg["window"]
        return carry, rows
