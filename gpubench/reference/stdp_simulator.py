"""NEST's HPC benchmark network over the sparse window, plain PyTorch:
``sparse_simulator.SparseWindow`` with NEST's ``iaf_psc_alpha`` neurons,
multapses and plastic E->E synapses (``stdp_pl_synapse_hom``, Morrison,
Aertsen & Diesmann 2007).

It takes only the benchmark's raw inputs (the (N, K) table of each
target's sources in draw order, the inhibitory flags, the weights, the
configuration) and works out again, in its own formulation, what the
program builds:

* the partition, one destination shard at a time: a shard's synapses
  listed target-major in draw order, split into plastic (E->E) and static
  ones, each part ordered by one stable argsort of its sources (so a
  list ascends by target, multapses in draw order), bounded by
  ``searchsorted``; the fan-out the shards with a list of either part;
* the neuron (:func:`alpha_window`): per step, in f32 and this order, when
  not refractory u = v - e_l becomes p33 u + p31 dI_e + p32 I_e + p31
  dI_i + p32 I_i and v = e_l + u; I = p21 dI + p22 I, dI = p11 dI +
  (e / tau_syn) input per type; threshold, reset, refractory countdown;
  each spike appended to the neuron's archive of its last H spikes (step,
  K- = the newest entry's K- decayed to it, plus 1);
* delivery: the static synapses as the sparse window adds them, then the
  plastic ones.  A plastic event (live, not missed, with a plastic list
  on the shard) updates each synapse of its list before that synapse's
  add, as NEST's ``send`` does: facilitation by each post spike t_k of
  the target in (t_last - d, t_spike - d], oldest first, w += lambda
  w^mu K+ e^{-(t_k + d - t_last) dt / tau_plus}; depression by the newest
  post spike strictly before t_spike - d, w = max(0, w - lambda alpha w
  K-_k e^{-(t_spike - d - t_k) dt / tau_minus}); then K+ = K+
  e^{-(t_spike - t_last) dt / tau_plus} + 1 and t_last = t_spike, per
  (shard, source).  Here a source's events are taken in rounds (its k-th
  event of the window in round k, every list's synapses at once), which
  keeps each synapse's updates in event order, and the adds (the weight
  after that event) then go into the rings in event order, the k-th add
  of a ring element in the k-th ``index_put_``.  The archive is walked
  newest first down to an entry at or before min(t1, t2 - 1) (t1 = t2
  for a source's first event); a walk past the oldest kept entry of a
  neuron whose entries were overwritten counts ``history_short``.  Every
  decay is an entry of one f32 table of e^{-k dt / tau}, computed in
  float64 and rounded, indexed by the step difference clamped to its
  length; w^mu is the float64 ``pow`` rounded to f32.

``precision``: ``"f32"``; ``"static"`` (the control: plasticity off, the
plastic synapses adding their initial weights); or ``"bf16"`` (every
synaptic add's weight rounded to bfloat16, the plastic state kept in
f32).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import aggregator, codec, events as ev
from . import simulator as base
from . import sparse_simulator as sparse

PRECISIONS = ("f32", "static", "bf16")
DECAY_STEPS = 1 << 15
COUNTERS = ("updates", "facilitations", "clipped", "history_short",
            "entries_read")


class AlphaParams(NamedTuple):
    tau_m: float
    tau_syn: float
    c_m: float
    e_l: float
    v_th: float
    v_reset: float
    t_ref: float
    dt: float


class StdpParams(NamedTuple):
    lam: float
    alpha: float
    mu: float
    tau_plus: float
    tau_minus: float
    delay_steps: int
    history: int


class AlphaState(NamedTuple):
    v: torch.Tensor
    di_exc: torch.Tensor
    i_exc: torch.Tensor
    di_inh: torch.Tensor
    i_inh: torch.Tensor
    refrac: torch.Tensor


class PostArchive(NamedTuple):
    step: torch.Tensor          # (S, per, H) int32
    kminus: torch.Tensor        # (S, per, H) f32
    count: torch.Tensor         # (S, per) int32


class PlasticState(NamedTuple):
    weights: torch.Tensor       # (n_plastic,) f32
    kplus: torch.Tensor         # (S, N_pad) f32
    t_last: torch.Tensor        # (S, N_pad) int32, -1 none
    archive: PostArchive
    counts: torch.Tensor        # (S, 5) int64


class Carry(NamedTuple):
    state: base.ShardState
    pending: sparse.SourcePendingWindow
    link: base.FabricState
    plastic: PlasticState


class StdpNetwork(NamedTuple):
    per_shard: int
    max_fan: int
    row_ptr: torch.Tensor       # (S, N_pad + 1) static lists
    targets: torch.Tensor
    weights: torch.Tensor
    inh_src: torch.Tensor       # (N_pad,) bool
    delays: torch.Tensor        # (S, per) int32
    fanout: torch.Tensor        # (S, per, max_fan) int32
    p_row_ptr: torch.Tensor     # (S, N_pad + 1) plastic lists
    p_targets: torch.Tensor
    p_weights: torch.Tensor     # (n_plastic,) initial


def _f32(x: float) -> float:
    return float(np.float32(x))


def decay(dt: float, tau: float, device) -> torch.Tensor:
    return torch.exp(torch.arange(DECAY_STEPS, dtype=torch.float64)
                     * (-dt / tau)).to(torch.float32).to(device)


def alpha_constants(p: AlphaParams):
    h, a, b = p.dt, 1.0 / p.tau_syn, 1.0 / p.tau_m
    c = a - b
    ea, eb = math.exp(-a * h), math.exp(-b * h)
    p32 = (eb - ea) / (c * p.c_m)
    p31 = ((eb - ea) / (c * c) - h * ea / c) / p.c_m
    return (_f32(ea), _f32(h * ea), _f32(p31), _f32(p32), _f32(eb),
            _f32(math.e / p.tau_syn), int(round(p.t_ref / p.dt)))


def partition(sources: torch.Tensor, is_inh: torch.Tensor, n_shards: int,
              w_exc: float, w_inh: float, delay_steps: int) -> StdpNetwork:
    """The partition of the module docstring, on ``sources``' device."""
    n, k = sources.shape
    per = -(-n // n_shards)
    n_pad = per * n_shards
    dev = sources.device
    inh = torch.zeros((n_pad,), dtype=torch.bool, device=dev)
    inh[:n] = is_inh
    parts = {True: ([], [], []), False: ([], [], [])}
    for s in range(n_shards):
        block = sources[s * per:min((s + 1) * per, n)]
        g = block.reshape(-1).long()
        x = torch.arange(block.shape[0], device=dev).repeat_interleave(k)
        plastic = ~inh[g] & ~inh[s * per + x]
        for kind in (True, False):
            sel = plastic == kind
            gs, xs = g[sel], x[sel]
            order = torch.argsort(gs, stable=True)
            gs, xs = gs[order], xs[order]
            bounds = torch.searchsorted(gs, torch.arange(
                n_pad + 1, device=dev))
            tg, bd, w = parts[kind]
            tg.append(xs.to(torch.int32))
            bd.append(bounds)
            if not kind:
                w.append(torch.where(inh[gs], _f32(w_inh), _f32(w_exc)).to(
                    torch.float32))
            del order, gs, xs, sel
        del g, x, plastic

    def lists(kind):
        tg, bd, w = parts[kind]
        base_at = torch.cumsum(torch.tensor([0] + [t.numel() for t in tg[:-1]],
                                            device=dev), 0)
        row_ptr = torch.stack([b + o for b, o in zip(bd, base_at)])
        return row_ptr.contiguous(), torch.cat(tg), (torch.cat(w) if w
                                                     else None)
    p_row, p_tg, _ = lists(True)
    s_row, s_tg, s_w = lists(False)
    hit = ((s_row[:, 1:] - s_row[:, :-1]) + (p_row[:, 1:] - p_row[:, :-1])
           ) > 0
    n_fan = hit.sum(0)
    max_fan = max(int(n_fan.max()), 1)
    fan_order = torch.argsort((~hit).to(torch.uint8), dim=0,
                              stable=True).T[:, :max_fan]
    fan = torch.arange(max_fan, device=dev)
    fanout = torch.where(fan < n_fan[:, None], fan_order, -1).to(torch.int32)
    delays = torch.full((n_shards, per), delay_steps, dtype=torch.int32,
                        device=dev)
    return StdpNetwork(per, max_fan, s_row, s_tg, s_w, inh, delays,
                       fanout.reshape(n_shards, per, max_fan), p_row, p_tg,
                       torch.full((p_tg.numel(),), _f32(w_exc),
                                  dtype=torch.float32, device=dev))


def alpha_step(st: AlphaState, c, p: AlphaParams, exc, inh):
    p11, p21, p31, p32, p33, psc, ref_steps = c
    active = st.refrac <= 0
    u = st.v - p.e_l
    u = p33 * u + p31 * st.di_exc + p32 * st.i_exc + p31 * st.di_inh \
        + p32 * st.i_inh
    v = torch.where(active, p.e_l + u, st.v)
    i_exc = p21 * st.di_exc + p11 * st.i_exc
    di_exc = p11 * st.di_exc + psc * exc
    i_inh = p21 * st.di_inh + p11 * st.i_inh
    di_inh = p11 * st.di_inh + psc * inh
    spikes = active & (v >= p.v_th)
    v = torch.where(spikes, torch.full_like(v, p.v_reset), v)
    refrac = torch.where(spikes, torch.full_like(st.refrac, ref_steps),
                         torch.clamp(st.refrac - 1, min=0))
    return AlphaState(v, di_exc, i_exc, di_inh, i_inh, refrac), spikes


def archive_spikes(ar: PostArchive, spikes, t: int, minus) -> PostArchive:
    """A copy of ``ar`` with the step ``t``'s spikes appended."""
    H = ar.step.shape[-1]
    n = ar.count.long()
    top = torch.remainder(n - 1, H)[..., None]
    prev_step = torch.gather(ar.step, -1, top)[..., 0].long()
    prev_km = torch.gather(ar.kminus, -1, top)[..., 0]
    km = torch.where(n > 0, prev_km * minus[torch.clamp(
        t - prev_step, 0, minus.numel() - 1)] + 1.0, torch.ones_like(prev_km))
    slot = torch.remainder(n, H)
    write = torch.nn.functional.one_hot(slot, H).bool() & spikes[..., None]
    step = torch.where(write, torch.full_like(ar.step, t), ar.step)
    kminus = torch.where(write, km[..., None], ar.kminus)
    return PostArchive(step, kminus, ar.count + spikes.to(torch.int32))


def alpha_window(st, c, p, ring_exc, ring_inh, t0: int, drive, ar, minus):
    L = ring_exc.shape[0]
    spikes = []
    for k in range(drive.shape[0]):
        slot = (t0 + k) % L
        st, spk = alpha_step(st, c, p, ring_exc[slot] + drive[k],
                             ring_inh[slot])
        ar = archive_spikes(ar, spk, t0 + k, minus)
        ring_exc[slot].zero_()
        ring_inh[slot].zero_()
        spikes.append(spk)
    return st, torch.stack(spikes, dim=-2), ar


def update(sp: StdpParams, w, t_spike, kplus, t_last, steps, kminus, n,
           plus, minus):
    """The rule for a batch of (synapse, event) pairs -> (w, counters
    (m, 5))."""
    d, H = sp.delay_steps, steps.shape[-1]
    lam, lam_alpha = _f32(sp.lam), _f32(sp.lam * sp.alpha)
    L = plus.numel()
    m = w.numel()
    idx = torch.arange(m, device=w.device)
    n = n.long()
    t2 = t_spike.long() - d
    tl = t_last.long()
    t1 = torch.where(tl < 0, t2, tl - d)
    lim = torch.minimum(t1, t2 - 1)
    first_kept = torch.clamp(n - H, min=0)
    cur = n - 1
    depr = torch.full_like(n, -1)
    found = torch.zeros_like(n, dtype=torch.bool)
    read = torch.zeros_like(n)
    on = cur >= first_kept
    while bool(on.any()):
        st = steps[idx, torch.remainder(cur, H)].long()
        read = read + on.long()
        depr = torch.where(on & (depr < 0) & (st < t2), cur, depr)
        halt = on & (st <= lim)
        found = found | halt
        cur = torch.where(on & ~halt, cur - 1, cur)
        on = on & ~halt & (cur >= first_kept)
    short = ~found & (n > H)
    k = cur + 1
    facil = torch.zeros_like(n)
    on = k < n
    while bool(on.any()):
        st = steps[idx, torch.remainder(k, H)].long()
        on = on & (st <= t2)
        apply = on & (st > t1)
        term = kplus * plus[torch.clamp(st + d - tl, 0, L - 1)]
        grow = torch.pow(w.to(torch.float64), sp.mu).to(torch.float32)
        w = torch.where(apply, w + lam * grow * term, w)
        facil = facil + apply.long()
        k = k + 1
        on = on & (k < n)
    has = depr >= 0
    at = torch.remainder(depr, H)
    trace = kminus[idx, at] * minus[torch.clamp(
        t2 - steps[idx, at].long(), 0, L - 1)]
    after = w - lam_alpha * w * trace
    clipped = has & (after < 0)
    w = torch.where(has, torch.where(after < 0, torch.zeros_like(after),
                                     after), w)
    return w, torch.stack([torch.ones_like(n), facil, clipped.long(),
                           short.long(), read], dim=-1)


class StdpWindow(sparse.SparseWindow):
    """The pipelined window of ``cfg`` over ``net`` (a
    :class:`StdpNetwork`) with ``params`` (:class:`AlphaParams`) and the
    rule ``sp`` (:class:`StdpParams`), in ``precision``."""

    def __init__(self, cfg: dict, net: StdpNetwork, params: AlphaParams,
                 sp: StdpParams, precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        super().__init__(cfg, net, params,
                         "bf16" if precision == "bf16" else "f32")
        self.precision = precision
        self.sp = sp
        self.consts = alpha_constants(params)
        self.plus = decay(params.dt, sp.tau_plus, self.device)
        self.minus = decay(params.dt, sp.tau_minus, self.device)

    def init(self, v0: torch.Tensor) -> Carry:
        c = super().init(v0)
        st = c.state
        z = torch.zeros_like(v0)
        neuron = AlphaState(v0.clone(), z, z.clone(), z.clone(), z.clone(),
                            torch.zeros(v0.shape, dtype=torch.int32,
                                        device=v0.device))
        S, per, H = self.S, self.net.per_shard, self.sp.history
        dev = self.device
        n_pad = S * per
        plastic = PlasticState(
            self.net.p_weights.clone(),
            torch.zeros((S, n_pad), dtype=torch.float32, device=dev),
            torch.full((S, n_pad), -1, dtype=torch.int32, device=dev),
            PostArchive(torch.zeros((S, per, H), dtype=torch.int32,
                                    device=dev),
                        torch.zeros((S, per, H), dtype=torch.float32,
                                    device=dev),
                        torch.zeros((S, per), dtype=torch.int32, device=dev)),
            torch.zeros((S, len(COUNTERS)), dtype=torch.int64, device=dev))
        return Carry(st._replace(neuron=neuron), c.pending, c.link, plastic)

    def _plastic(self, ring_exc, ring_inh, words, counts, t: int,
                 ps: PlasticState) -> PlasticState:
        S, L, C, net, sp = self.S, self.L, self.C, self.net, self.sp
        per = net.per_shard
        dev = self.device
        live = (self.slots < counts[..., None]).reshape(S, -1)
        words = words.reshape(S, -1)
        slack = ev.ts_slack(ev.timestamp(words), t & ev.TS_MASK)
        addr = ev.address(words)
        src_shard = torch.arange(words.shape[1], device=dev) // C
        g = torch.where(live & (addr < per), src_shard[None] * per + addr,
                        0).long()
        shards = torch.arange(S, device=dev)[:, None].expand_as(g)
        lo = net.p_row_ptr[shards, g]
        cnt = net.p_row_ptr[shards, g + 1] - lo
        on = live & (addr < per) & (slack >= 0) & (cnt > 0)
        if not bool(on.any()):
            return ps
        # the events in order, shard-major
        e_sh, e_g, e_lo = shards[on], g[on], lo[on]
        e_cnt = cnt[on]
        e_slot = ((t + slack[on]) % L).long()
        e_tsp = (t + slack[on] - sp.delay_steps).to(torch.int32)
        n_pad = S * per
        key = e_sh * n_pad + e_g
        key_sorted, by_key = torch.sort(key, stable=True)
        occ = torch.empty_like(by_key)
        occ[by_key] = torch.arange(key.numel(), device=dev) - \
            torch.searchsorted(key_sorted, key_sorted)
        # every pair (event, synapse) in event order
        pair_ev = torch.repeat_interleave(torch.arange(key.numel(),
                                                       device=dev), e_cnt)
        within = torch.arange(pair_ev.numel(), device=dev) - \
            torch.repeat_interleave(torch.cumsum(e_cnt, 0) - e_cnt, e_cnt)
        j = e_lo[pair_ev] + within
        x = net.p_targets[j].long()
        nid = e_sh[pair_ev] * per + x
        adds = torch.empty((pair_ev.numel(),), dtype=torch.float32,
                           device=dev)
        weights, kplus, t_last = (ps.weights.clone(), ps.kplus.clone(),
                                  ps.t_last.clone())
        counts_out = ps.counts.clone()
        steps = ps.archive.step.reshape(n_pad, -1)
        kminus = ps.archive.kminus.reshape(n_pad, -1)
        n_post = ps.archive.count.reshape(-1)
        for r in range(int(occ.max()) + 1):
            evs = occ == r
            sel = evs[pair_ev]
            pe = pair_ev[sel]
            if self.precision != "static":
                w, cnts = update(sp, weights[j[sel]], e_tsp[pe],
                                 kplus[e_sh[pe], e_g[pe]],
                                 t_last[e_sh[pe], e_g[pe]], steps[nid[sel]],
                                 kminus[nid[sel]], n_post[nid[sel]],
                                 self.plus, self.minus)
                weights[j[sel]] = w
                counts_out.index_add_(0, e_sh[pe], cnts)
                es, eg, ts = e_sh[evs], e_g[evs], e_tsp[evs]
                kp, tl = kplus[es, eg], t_last[es, eg]
                kplus[es, eg] = kp * self.plus[torch.clamp(
                    ts.long() - tl.long(), 0, self.plus.numel() - 1)] + 1.0
                t_last[es, eg] = ts
            else:
                w = weights[j[sel]]
            adds[sel] = (w.to(torch.bfloat16).to(torch.float32)
                         if self.precision == "bf16" else w)
        inh = net.inh_src[e_g[pair_ev]].long()
        elem = ((inh * L + e_slot[pair_ev]) * S + e_sh[pair_ev]) * per + x
        elem_sorted, order = torch.sort(elem, stable=True)
        first = torch.searchsorted(elem_sorted, elem_sorted)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(elem.numel(), device=dev) - first
        both = torch.stack([ring_exc, ring_inh]).reshape(-1)
        for r in range(int(rank.max()) + 1):
            sel = rank == r
            both.index_put_((elem[sel],), adds[sel], accumulate=True)
        both = both.reshape((2,) + tuple(ring_exc.shape))
        ring_exc.copy_(both[0])
        ring_inh.copy_(both[1])
        return PlasticState(weights, kplus, t_last, ps.archive, counts_out)

    def step(self, carry: Carry, t: int, drive: torch.Tensor):
        state, pend, lstate, ps = carry
        S, C = self.S, self.C
        out = self.backend.exchange(lstate, pend.payload, pend.counts,
                                    enforce_credits=True)
        recv, rmeta = codec.decode_planar(out.recv_payload)
        lat = self._latency(t, rmeta, out.recv_counts, out.queue_us.T)
        miss = self._apply_events(state.ring_exc, state.ring_inh, recv,
                                  out.recv_counts, t)
        ps = self._plastic(state.ring_exc, state.ring_inh, recv,
                           out.recv_counts, t, ps)
        neuron, spikes, archive = alpha_window(
            state.neuron, self.consts, self.params, state.ring_exc,
            state.ring_inh, t, drive, ps.archive, self.minus)
        ps = ps._replace(archive=archive)
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
        fw, res_dest = sparse.flush_with_dest(words, dest, inject, S, C,
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
        pend = sparse.SourcePendingWindow(b.data, b.guids, b.counts,
                                          fw.residue, fw.residue_meta,
                                          fw.payload, res_dest)
        return Carry(state, pend, out.state, ps), stats
