"""The multi-tenant serving window, plain PyTorch (frozen from the port's
``serve/spike_engine.py``: ``_window``, ``_attribute`` and
``_drain_walk``, with the tenant fabric of ``serve/tenancy.py``).

The engine's threads, staging and ledger are the program's plumbing; what
a served window computes is here: the backlog-first merge of fresh
arrivals into bucket rows (overflow beyond a row's capacity shed), the
wire encode, the credit-partitioned tenant torus exchange with its
admission replay, the deferred rows kept as the next backlog, the decode
and the receiver-side latency digest per (shard, tenant).

``precision`` is that of the latency arithmetic: ``"f32"`` as the
configuration states, or ``"bf16"`` (the control).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import codec, flow_control as fc, latency
from .torus import TenantTorusTransport

PRECISIONS = ("f32", "bf16")


class WindowServeStats(NamedTuple):
    offered: torch.Tensor
    sent: torch.Tensor
    deferred: torch.Tensor
    parked: torch.Tensor
    unparked: torch.Tensor
    delivered: torch.Tensor
    shed: torch.Tensor
    latency: latency.LatencySummary


class Carry(NamedTuple):
    state: object               # the fabric's FabricState
    words: torch.Tensor         # (S, T, S, C) backlog rows
    meta: torch.Tensor          # (S, T, S, C) their injection windows
    counts: torch.Tensor        # (S, T, S)


class Engine:
    """Serving windows of ``n_shards`` shards on the torus ``dims`` with
    tenants of credit ``reserves`` out of ``link_credits`` a link."""

    def __init__(self, n_shards: int, dims, reserves, *, capacity: int,
                 link_credits: int, notify_latency: int, window_us: float,
                 wire_format: str = "extoll", precision: str = "f32",
                 device=None):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.device = torch.device("cpu" if device is None else device)
        self.precision = precision
        self.S, self.T, self.C = n_shards, len(reserves), capacity
        self.window_us = float(window_us)
        self.fabric = TenantTorusTransport(
            n_shards, tuple(dims),
            partition=fc.make_partition(link_credits, list(reserves)),
            notify_latency=notify_latency, max_row_events=capacity,
            wire_format=wire_format)
        self.hops_rx = self.fabric.route_hops(
            device=self.device).T[:, None, :]               # (dst, 1, src)
        self.pos = torch.arange(capacity, device=self.device)

    def init(self) -> Carry:
        S, T, C = self.S, self.T, self.C
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                       device=self.device)
        return Carry(self.fabric.init_state(2 * C, device=self.device),
                     z(S, T, S, C), z(S, T, S, C), z(S, T, S))

    def _attribute(self, out, win_abs: int):
        S, T = self.S, self.T
        dt = torch.bfloat16 if self.precision == "bf16" else torch.float32
        _, r_meta = codec.decode_planar(out.recv_payload)
        live = self.pos < out.recv_counts[..., None]
        wait = (win_abs - r_meta).to(dt) * self.window_us
        row_us = (latency.hop_latency_us(self.fabric.wire_fmt,
                                         out.recv_counts, self.hops_rx).to(dt)
                  + out.queue_us.permute(2, 0, 1).to(dt))
        lat = wait + row_us[..., None]
        summary = latency.summarize_latency(
            lat.reshape(S, T, -1), live.reshape(S, T, -1).to(torch.int32),
            batch_dims=2)
        return summary, out.recv_counts.sum(-1, dtype=torch.int32)

    def window(self, carry: Carry, fw_w, fc_w, win_abs: int):
        """One flush window of arrivals ``fw_w`` (S, T, S, C) words and
        ``fc_w`` (S, T, S) counts -> (carry, WindowServeStats)."""
        state, bw, bm, bc = carry
        C, pos = self.C, self.pos
        b = bc[..., None]
        sel_b = pos < b
        fw_g = torch.gather(fw_w, -1, torch.clamp(pos - b, 0, C - 1))
        take_f = ~sel_b & (pos - b < fc_w[..., None])
        words = torch.where(sel_b, bw, torch.where(take_f, fw_g, 0))
        stamp = torch.full((), win_abs, dtype=torch.int32, device=self.device)
        meta = torch.where(sel_b, bm, torch.where(take_f, stamp, 0))
        cnt = torch.clamp(bc + fc_w, max=C)
        shed = bc + fc_w - cnt
        payload = codec.encode_planar(words.contiguous(), meta.contiguous())
        out = self.fabric.exchange(state, payload, cnt)
        keep = ~out.sent_mask
        carry = Carry(out.state, torch.where(keep[..., None], words, 0),
                      torch.where(keep[..., None], meta, 0),
                      torch.where(keep, cnt, 0))
        summary, delivered = self._attribute(out, win_abs)
        st = out.stats
        return carry, WindowServeStats(
            offered=st.offered_events, sent=st.sent_events,
            deferred=st.deferred_events, parked=st.parked_events,
            unparked=st.unparked_events, delivered=delivered,
            shed=shed.sum(-1, dtype=torch.int32), latency=summary)

    def drain_walk(self, carry: Carry, win0: int):
        """The final walk: one uncredited flush of the backlog, then the
        transit-buffer drain -> (state, (summary, delivered) of each)."""
        state, bw, bm, bc = carry
        payload = codec.encode_planar(bw.contiguous(), bm.contiguous())
        out1 = self.fabric.exchange(state, payload, bc,
                                    enforce_credits=False)
        s1, d1 = self._attribute(out1, win0)
        out2 = self.fabric.drain_fabric(out1.state)
        s2, d2 = self._attribute(out2, win0)
        return out2.state, ((s1, d1), (s2, d2))
