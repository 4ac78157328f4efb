"""Microcircuit cells: a spiking network partitioned over wafer shards,
simulated window by window through the port's segment API
(``repro_torch.snn.simulator.build_sharded_segments`` -> ``run_segment``).

:func:`run_network` is the run and its check for any kind of network; a
kind supplies its :class:`Parts` (the inputs drawn from the seed, the
program built on them, the reference and the carry's translation to it).
This kind's parts are :data:`DENSE`: a dense (N, N) weight matrix.

Set-up (``setup_s``): the connectivity drawn on the card from the seed
and moved to the host, where the program partitions it, the program's
build (weights uploaded, routing tables, fabric), the initial potentials,
and two warm-up segments whose results are thrown away.  The benchmark
keeps no copy of the weights on the card while the window runs, and
``memory_peak_bytes`` is the peak of the window alone.

The measured window runs segments of ``segment_windows`` windows from the
initial state until ``--seconds`` have passed, each with the background
drive of its index (drawn on the card from the seed), and ends in a
synchronize: ``window_ms`` is its wall time over the windows simulated.

The check, once the window has closed and the peak memory has been read:
every window's conservation identities on the host, then the frozen
reference (``gpubench.reference.simulator``), built from the raw inputs,
follows a sample of segments drawn from the seed.  The first starts from
the reference's own initial state (which must equal the program's); the
others start from the state the program reached, since a float32 network
run window after window cannot be followed from the start within the
window's length.  Each followed segment's every ``WindowStats`` field and
its end state are held to the program's.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from gpubench.harness import compare, readers, trace as htrace
from gpubench.inputs import pd_connectivity as pd
from gpubench.reference import (flow_control as rfc, lif as rlif,
                                simulator as rsim, transport_base as rbase)

DRIVES = "simulator"     # the program a planted fault breaks
WARMUP_SEGMENTS = 2
TRACE_START = 2          # the first traced segment of a --trace 1 run


def substream(seed: int, *key: int) -> int:
    """A 63-bit generator seed for stream ``key`` of the run's seed."""
    ss = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), *key])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Inputs:
    """What the benchmark makes from the seed and hands both sides."""

    def __init__(self, config: dict, seed: int, device):
        scale, S = config["scale"], config["n_shards"]
        self.seed, self.device = seed, torch.device(device)
        gen = torch.Generator(device=self.device).manual_seed(
            substream(seed, 0))
        # (N, N) f32, drawn on the card and kept on the host: the program
        # builds from it, and the reference takes it back after the window
        self.weights = pd.weights(scale, gen).cpu()
        self.is_inh = pd.is_inhibitory(scale)
        n = self.weights.shape[0]
        self.per = -(-n // S)
        bg = np.zeros(self.per * S, np.float32)
        bg[:n] = pd.bg_rates(scale)
        self.bg_rates = bg[:n]
        self.bg = torch.from_numpy(bg.reshape(S, self.per)).to(self.device)
        self.bg_weight = float(config["bg_weight_pa"])
        self.dt = float(config["lif"]["dt"])
        lp = config["lif"]
        u = torch.rand((S, self.per), generator=gen, device=self.device)
        self.v0 = lp["e_l"] + (lp["v_th"] - lp["e_l"]) * u

    def drive(self, k: int, n_windows: int, window: int) -> torch.Tensor:
        """Segment ``k``'s background current (n_windows, window, S, per)
        f32: Poisson counts at each neuron's rate x the weight."""
        gen = torch.Generator(device=self.device).manual_seed(
            substream(self.seed, 1, k))
        lam = (self.bg * (self.dt * 1e-3)).expand(
            (n_windows, window) + tuple(self.bg.shape))
        return torch.poisson(lam, generator=gen) * self.bg_weight


def sim_fields(cell) -> dict:
    """The simulator's settings: the configuration's, with the traffic's
    fabric (transport, torus shape, capacity, credits) over them."""
    c, t = cell.config, cell.traffic
    out = {k: c[k] for k in ("n_shards", "window", "ring_len", "e_max",
                             "residue", "wire_format", "step_us",
                             "notify_latency")}
    out.update(transport="alltoall", torus_nx=0, torus_ny=0, torus_nz=0,
               link_credits=0)
    out.update({k: t[k] for k in ("transport", "torus_nx", "torus_ny",
                                  "torus_nz", "capacity", "link_credits",
                                  "notify_latency") if k in t})
    return out


class Program:
    """The port under test, built on ``inputs``; the port's segments take
    no tracer, so ``tracer`` is not used."""

    def __init__(self, cell, inputs: Inputs, device, tracer=None):
        from repro_torch.snn import lif, network, simulator as sim
        f = sim_fields(cell)
        part = network.build_partition(inputs.weights.numpy(),
                                       inputs.is_inh, n_shards=f["n_shards"])
        self.max_fan = part.fanout.shape[1]
        if part.per_shard * self.max_fan > 1 << 14:
            raise ValueError("event addresses exceed the 14-bit field")
        self.cfg = sim.SimConfig(
            n_shards=f["n_shards"], per_shard=part.per_shard,
            max_fan=self.max_fan, window=f["window"],
            ring_len=f["ring_len"], e_max=f["e_max"],
            capacity=f["capacity"],
            params=lif.LIFParams(**cell.config["lif"]), residue=f["residue"],
            transport=f["transport"], torus_nx=f["torus_nx"],
            torus_ny=f["torus_ny"], torus_nz=f["torus_nz"],
            link_credits=f["link_credits"],
            notify_latency=f["notify_latency"],
            wire_format=f["wire_format"], step_us=f["step_us"])
        init, self.run_segment, _ = sim.build_sharded_segments(
            self.cfg, part, inputs.bg_rates, inputs.bg_weight, device=device)
        del part
        c = init(0)
        neuron = c.state.neuron._replace(v=inputs.v0.clone())
        self.carry0 = c._replace(state=c.state._replace(neuron=neuron,
                                                        generator=None))


def to_reference(carry) -> rsim.Carry:
    """A copy of the program's carry as the reference's types."""
    cl = lambda x: None if x is None else x.clone()
    st, link = carry.state, carry.link
    state = rsim.ShardState(rlif.LIFState(*map(cl, st.neuron)),
                            cl(st.ring_exc), cl(st.ring_inh), cl(st.t))
    bank = rfc.CreditBank(*map(cl, link.bank))
    fab = rbase.FabricState(bank, *(cl(getattr(link, f)) for f in
                                    rbase.FabricState._fields[1:]))
    return rsim.Carry(state, rsim.PendingWindow(*map(cl, carry.pending)),
                      fab)


def dense_reference(cell, inputs: Inputs, device, precision: str):
    """The frozen reference in ``precision`` over the partition it works
    out from ``inputs.weights``; the partition is made once, on the first
    call, and the host's weight matrix is freed after it."""
    if not hasattr(inputs, "net"):
        inputs.net = rsim.partition(
            inputs.weights.to(device),
            torch.from_numpy(inputs.is_inh).to(device),
            cell.config["n_shards"])
        del inputs.weights
    return rsim.Window(sim_fields(cell), inputs.net,
                       rlif.LIFParams(**cell.config["lif"]), precision)


class Parts(NamedTuple):
    """What a network kind hands :func:`run_network`.

    * ``inputs(config, seed, device)``: what the benchmark draws from the
      seed for both sides, with ``v0`` (the initial potentials) and
      ``drive(k, n_windows, window)`` (segment ``k``'s background current);
    * ``program(cell, inputs, device, tracer)``: the port built on them,
      with ``cfg`` (its ``SimConfig``), ``carry0`` and ``run_segment(carry,
      n, drive=...) -> (carry, WindowStats)``; ``tracer`` is a
      ``repro_torch.obs.spans.Tracer`` with ``--trace 1`` (its spans in
      the profiled segments reach the readers), else the disabled
      ``spans.NULL``;
    * ``reference(cell, inputs, device, precision)``: the reference in
      ``"f32"`` or in ``control``, with ``init(v0)`` and ``segment(carry,
      drive) -> (carry, [WindowStats])``; called after the program's
      ``run_segment`` is dropped;
    * ``to_reference(carry)``: a copy of the program's carry as the
      reference's types;
    * ``control``: the precision of the control, one below the
      configuration's.
    """

    inputs: Callable
    program: Callable
    reference: Callable
    to_reference: Callable
    control: str


def identities(stats: dict, n_shards: int) -> int:
    """Windows x shards breaking the conservation and credit identities,
    over every window of the run (host numpy, (S, n) per field)."""
    g = lambda k: stats["link." + k]
    zero = np.zeros((n_shards, 1), np.int64)
    prev = lambda x: np.concatenate([zero, x[:, :-1]], axis=1)
    checks = [
        g("offered_events") == g("sent_events") + g("deferred_events")
        + g("parked_events"),
        np.broadcast_to((g("sent_events") + g("unparked_events")).sum(0)
                        == g("delivered_events").sum(0), g("sent_events")
                        .shape),
        g("stalled_by_hop").sum(-1) == g("deferred_events"),
        g("in_fabric_events") == prev(g("in_fabric_events"))
        + g("parked_events") - g("unparked_events"),
        g("offered_events") == prev(stats["events_sent"]),
        stats["latency.hist"].sum(-1) == g("delivered_events"),
        stats["offered"] - prev(stats["deferred"]) - g("deferred_events")
        >= 0,
    ]
    return int(sum((~c).sum() for c in checks))


def flatten(tree, prefix="") -> dict:
    out = {}
    for f in tree._fields:
        x = getattr(tree, f)
        if x is None:
            continue
        if isinstance(x, tuple):
            out.update(flatten(x, f"{prefix}{f}."))
        else:
            out[prefix + f] = x
    return out


def run_network(parts: Parts, cell, *, seed: int, seconds: float,
                trace: bool, device, t_start: float,
                control: bool = False) -> dict:
    """One run of ``cell`` with the network ``parts``: set-up, the timed
    window, the check (the module's docstring)."""
    from repro_torch.obs import spans
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    inputs = parts.inputs(cell.config, seed, device)
    tracer = spans.Tracer() if trace else spans.NULL
    prog = parts.program(cell, inputs, device, tracer)
    nw, win = cell.traffic["segment_windows"], prog.cfg.window
    drive = lambda k: inputs.drive(k, nw, win)
    c = prog.carry0
    for k in range(WARMUP_SEGMENTS):
        c, _ = prog.run_segment(c, nw, drive=drive(k))
    sync()
    setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # every segment's stats are kept; of the states, a reservoir of
    # (start, end) pairs drawn from the seed.  The program's carry is made
    # anew by each segment, so holding it copies nothing on the card
    kept = compare.Reservoir(cell.traffic["check_segments"],
                             np.random.default_rng(substream(seed, 2)))
    stats, last = [], [prog.carry0]

    def step(j):
        cj, sj = prog.run_segment(last[0], nw, drive=drive(j))
        stats.append(sj)
        kept.offer(j, (last[0], cj))
        last[0] = cj

    profiled, n_traced = None, cell.traffic["trace_segments"]
    t0 = time.perf_counter()
    seg_t = [t0]
    k = 0
    while True:
        if trace and k == TRACE_START:
            a = tracer.now_us()
            _, profiled = htrace.profile(
                lambda: [step(k + j) for j in range(n_traced)],
                n_traced * nw, device)
            b = tracer.now_us()
            k += n_traced
        else:
            step(k)
            k += 1
        seg_t.append(time.perf_counter())
        if time.perf_counter() - t0 >= seconds and (
                not trace or k > TRACE_START):
            break
    sync()
    wall = time.perf_counter() - t0
    n_windows = k * nw
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx = None
    if profiled is not None:
        events = [e for e in readers.program_spans(tracer)
                  if a <= e["ts"] and e["ts"] + e["dur"] <= b]
        ctx = readers.Context(profiled, sizes(
            prog, stats[TRACE_START:TRACE_START + n_traced]), events,
            root=cell.root)
    del prog.run_segment

    # -- the check ----------------------------------------------------
    t_check = time.perf_counter()
    host = {name: v.cpu().numpy() for name, v in flatten(
        compare.cat_windows(stats)).items()}
    broken = identities(host, prog.cfg.n_shards)
    ref = parts.reference(cell, inputs, device, "f32")
    ctrl = (parts.reference(cell, inputs, device, parts.control)
            if control else None)
    tally = compare.Tally()
    r0 = ref.init(inputs.v0)
    if not control:
        tally.tree(prog.carry0, r0)
    sample = sorted(kept.kept)
    failed = 0
    for j in sample:
        start = r0 if j == 0 else parts.to_reference(kept.kept[j][0])
        end, rows = ref.segment(start, drive(j))
        if control:
            got_end, got = ctrl.segment(start, drive(j))
        else:
            got_end = kept.kept[j][1]
            got = [compare.window_of(stats[j], i) for i in range(nw)]
        for i in range(nw):
            failed += tally.tree(got[i], rows[i]) > 0
        tally.tree(got_end, end)
    sync()
    compared = {
        "mismatched_ints": (tally.mismatched,
                            cell.config["limits"]["mismatched_ints"]),
        "float_gap": (tally.float_gap, cell.config["limits"]["float_gap"]),
        "broken_identities": (broken,
                              cell.config["limits"]["broken_identities"]),
    }
    return dict(
        e2e={"window_ms": wall * 1e3 / n_windows, "setup_s": setup_s},
        ctx=ctx, attempted=n_windows, failed=int(failed) + int(broken > 0),
        compared=compared, memory_peak_bytes=peak,
        checked_windows=len(sample) * nw,
        segment_ms=np.percentile(np.diff(seg_t) * 1e3,
                                 [0, 25, 50, 75, 100]).tolist(),
        check_s=time.perf_counter() - t_check)


DENSE = Parts(Inputs, Program, dense_reference, to_reference, "tf32")
run = functools.partial(run_network, DENSE)


def sizes(prog: Program, traced_stats) -> dict:
    """The cell's sizes as the program runs it: the simulator's settings,
    the torus's dimensions, whether credits bind, and the events offered a
    window over the traced stretch."""
    cfg = prog.cfg
    out = {k: v for k, v in cfg._asdict().items()
           if isinstance(v, (int, float, str))}
    out["torus"] = [d for d in (cfg.torus_nx, cfg.torus_ny, cfg.torus_nz)
                    if d] if cfg.transport != "alltoall" else []
    out["credited"] = cfg.transport != "alltoall" and cfg.link_credits > 0
    windows = sum(int(s.offered.shape[1]) for s in traced_stats)
    out["offered_per_window"] = sum(
        int(s.offered.sum()) for s in traced_stats) / max(windows, 1)
    return out
