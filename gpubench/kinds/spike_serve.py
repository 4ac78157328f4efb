"""Spike-serving cells: the port's streaming multi-tenant engine
(``repro_torch.serve.spike_engine.SpikeEngine``) on a credit-partitioned
torus, fed by the benchmark's copy of the open-loop Poisson generator.

Set-up (``setup_s``): the engine built (fabric, route tables, pinned
staging) and its own warm-up (a zero-traffic segment and drain walk).
The measured window starts the engine's ingest and device threads and
lets them serve for ``--seconds``; it ends when the device thread has
absorbed its last staged segment, before the drain.
``served_events_per_s`` is the events delivered by the windows served in
it over its wall time.

The engine is driven through its public ``start`` / ``stop(drain=True)``.
Two of its private steps are wrapped, and nothing else changed: a
reservoir drawn from the seed holds the (start, end) states of a few
segments, and the last segment's end, so the reference can follow a
segment from where the program stood; and the drain's start is
timestamped so the window's end is read on the benchmark's own clock.
The engine makes its carry anew in every window, so holding one copies
nothing on the card; the wrapper's work in the window is a draw of the
generator a segment.  ``memory_peak_bytes`` is the peak of the window
alone.

The check: every window's identities; the ledger recounted from the
generator; and the frozen reference (``gpubench.reference.engine``)
following a sample of segments drawn from the seed (the first from its
own initial state, the others from the program's state), every
``WindowServeStats`` field and end state held to the program's, then the
final drain walk from the program's last state.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from gpubench.harness import compare, readers, trace as htrace
from gpubench.inputs import loadgen
from gpubench.reference import engine as reng, flow_control as rfc
from gpubench.reference import transport_base as rbase

DRIVES = "engine"        # the program a planted fault breaks
TRACE_DELAY_S = 1.0      # serving before the traced stretch of --trace 1


def _probe(base):
    class Probe(base):
        bench_kept = None        # a compare.Reservoir while capturing

        def _segment(self, carry, fw, fc_, win0):
            out = super()._segment(carry, fw, fc_, win0)
            if self.bench_kept is not None:
                nw = self.cfg.seg_windows
                self.bench_kept.offer(win0 // nw, (carry[:4], out[0][:4]))
                self.bench_last = (win0, out[0][:4])
            return out

        def _drain(self):
            self.bench_t1 = time.perf_counter()
            self.bench_served = len(self.window_stats)
            super()._drain()
    return Probe


def profiles(cell) -> list:
    by_name = {t["name"]: t for t in cell.traffic["tenants"]}
    return [loadgen.TenantProfile(t["name"], **{
        k: by_name[t["name"]][k] for k in ("rate_epw", "burst_factor",
                                           "burst_prob")
        if k in by_name[t["name"]]}) for t in cell.config["tenants"]]


def staged(src, win: int):
    """Window ``win``'s arrivals as the engine stages them: (S, T, S, C)
    int32 words and (S, T, S) counts, shard s offering rows (tenant,
    dst)."""
    tr = src.next_window(win)
    return (torch.from_numpy(tr.words.transpose(1, 0, 2, 3).astype(
        np.uint32).view(np.int32)), torch.from_numpy(
            tr.counts.transpose(1, 0, 2).copy()))


def to_reference(carry) -> reng.Carry:
    cl = lambda x: None if x is None else x.clone()
    state = carry[0]
    bank = rfc.CreditBank(*map(cl, state.bank))
    fab = rbase.FabricState(bank, *(cl(getattr(state, f)) for f in
                                    rbase.FabricState._fields[1:]))
    return reng.Carry(fab, cl(carry[1]), cl(carry[2]), cl(carry[3]))


def identities(ws: dict) -> int:
    """Windows breaking the per-window identities ((n, S, T) per field)."""
    checks = [
        ws["offered"] == ws["sent"] + ws["deferred"] + ws["parked"],
        ws["latency.hist"].sum(-1) == ws["delivered"],
        np.broadcast_to(((ws["sent"] + ws["unparked"]).sum(1)
                         == ws["delivered"].sum(1))[:, None],
                        ws["sent"].shape),
        ws["shed"] >= 0,
    ]
    return int(sum((~c).any(axis=(1, 2)).sum() for c in checks))


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False) -> dict:
    from repro_torch.obs import spans
    from repro_torch.serve import spike_engine, tenancy
    device = torch.device(device)
    cuda = device.type == "cuda"
    c = cell.config
    S, C, nw = c["n_shards"], c["capacity"], c["seg_windows"]
    specs = [tenancy.TenantSpec(t["name"], t["reserve"]) for t in
             c["tenants"]]
    ecfg = spike_engine.EngineConfig(
        capacity=C, link_credits=c["link_credits"],
        notify_latency=c["notify_latency"], window_us=c["window_us"],
        seg_windows=nw, nx=c["torus"][0], ny=c["torus"][1],
        nz=c["torus"][2], wire_format=c["wire_format"],
        queue_depth=c["queue_depth"])
    src = loadgen.PoissonLoadGen(seed, profiles(cell), S, C)
    tracer = spans.Tracer() if trace else None
    eng = _probe(spike_engine.SpikeEngine)(S, specs, ecfg, src,
                                           tracer=tracer, device=device)
    eng.warmup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    eng.bench_kept = compare.Reservoir(
        cell.traffic["check_segments"],
        np.random.default_rng([int(seed) & ((1 << 64) - 1), 2]))
    profiled = None
    t0 = time.perf_counter()
    eng.start()
    if trace:
        time.sleep(TRACE_DELAY_S)
        a = tracer.now_us()
        _, profiled = htrace.profile(
            lambda: time.sleep(cell.traffic["trace_seconds"]), 0, device)
        b = tracer.now_us()
    time.sleep(max(seconds - (time.perf_counter() - t0), 0.0))
    try:
        eng.stop(drain=True)
        conserved = True
    except AssertionError:          # the ledger's conservation check
        conserved = False
    wall = eng.bench_t1 - t0
    t_check = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    out = _check(cell, seed, eng, src, conserved, wall, setup_s, peak,
                 profiled, tracer, (a, b) if trace else None, device,
                 control)
    out["check_s"] = time.perf_counter() - t_check
    return out


def _check(cell, seed, eng, src, conserved, wall, setup_s, peak,
           profiled, tracer, stretch, device, control) -> dict:
    c = cell.config
    S, C, nw = c["n_shards"], c["capacity"], c["seg_windows"]
    T = len(c["tenants"])
    segs, ledger = eng.window_stats, eng.ledger
    n_windows = len(segs) * nw
    n_served = eng.bench_served * nw
    ws = {}
    for name in segs[0]._fields:
        x = getattr(segs[0], name)
        if isinstance(x, tuple):
            for f in x._fields:
                ws[f"{name}.{f}"] = np.concatenate(
                    [getattr(getattr(s, name), f) for s in segs])
        else:
            ws[name] = np.concatenate([getattr(s, name) for s in segs])
    delivered_served = int(ws["delivered"][:n_served].sum())
    broken = identities(ws) + int(not conserved)

    # the ledger, recounted: what the generator staged for the served
    # windows, and what the windows report (the walk is added below)
    tally = compare.Tally()
    inj = np.zeros(T, np.int64)
    clip = np.zeros(T, np.int64)
    for w in range(n_served):
        tr = src.next_window(w)
        inj += tr.counts.astype(np.int64).sum((1, 2))
        clip += tr.clipped
    tally.tensor(torch.from_numpy(ledger.injected), torch.from_numpy(inj))
    tally.tensor(torch.from_numpy(ledger.clipped), torch.from_numpy(clip))
    broken += int(not np.array_equal(ledger.injected,
                                     ledger.delivered + ledger.shed))

    dims = tuple(c["torus"])
    mk = lambda p: reng.Engine(
        S, dims, [t["reserve"] for t in c["tenants"]], capacity=C,
        link_credits=c["link_credits"], notify_latency=c["notify_latency"],
        window_us=c["window_us"], wire_format=c["wire_format"],
        precision=p, device=device)
    ref = mk("f32")
    ctrl = mk("bf16") if control else None
    kept = eng.bench_kept.kept
    sample = sorted(kept)
    failed = 0
    zero_w = torch.zeros((S, T, S, C), dtype=torch.int32, device=device)
    zero_c = torch.zeros((S, T, S), dtype=torch.int32, device=device)
    for j in sample:
        w0 = j * nw
        start = ref.init() if j == 0 else to_reference(kept[j][0])
        carry_r, carry_c = start, start
        for i in range(nw):
            if w0 + i < n_served:
                fw, fc_ = staged(src, w0 + i)
                fw, fc_ = fw.to(device), fc_.to(device)
            else:
                fw, fc_ = zero_w, zero_c
            carry_r, want = ref.window(carry_r, fw, fc_, w0 + i)
            if control:
                carry_c, got = ctrl.window(carry_c, fw, fc_, w0 + i)
            else:
                got = compare.window_of(segs[j], i, axis=0)
            failed += tally.tree(got, want) > 0
        tally.tree(carry_c if control else to_reference(kept[j][1]),
                   carry_r)
    # the final walk from the program's last state
    last, end = eng.bench_last
    _, walk = ref.drain_walk(to_reference(end), last + nw)
    walk_delivered = sum(d.sum(0).cpu().numpy().astype(np.int64)
                         for _, d in walk)
    walk_hist = sum(s.hist.sum(0).cpu().numpy().astype(np.int64)
                    for s, _ in walk)
    tally.tensor(torch.from_numpy(ledger.delivered), torch.from_numpy(
        ws["delivered"].astype(np.int64).sum((0, 1)) + walk_delivered))
    tally.tensor(torch.from_numpy(ledger.hist), torch.from_numpy(
        ws["latency.hist"].astype(np.int64).sum((0, 1)) + walk_hist))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    lim = c["limits"]
    compared = {
        "mismatched_ints": (tally.mismatched, lim["mismatched_ints"]),
        "float_gap": (tally.float_gap, lim["float_gap"]),
        "broken_identities": (broken, lim["broken_identities"]),
    }
    ctx = None
    if profiled is not None:
        a, b = stretch
        events = readers.program_spans(tracer)
        done = [e for e in events if e["name"] == "device/dispatch"
                and a <= e["ts"] and e["ts"] + e["dur"] <= b]
        profiled.windows = max(len(done) * nw, 1)
        # the spans' own metrics read the serving after the profiled
        # stretch, which the profiler does not slow
        events = [e for e in events if e["ts"] >= b]
        sizes = {k: v for k, v in c.items()
                 if isinstance(v, (int, float, str))}
        sizes.update(torus=list(c["torus"]), n_tenants=T)
        ctx = readers.Context(profiled, sizes, events, root=cell.root)
        ctx.seg_windows = nw
    return dict(
        e2e={"served_events_per_s": delivered_served / wall,
             "setup_s": setup_s},
        ctx=ctx, attempted=n_windows, failed=int(failed) + int(broken > 0),
        compared=compared, memory_peak_bytes=peak,
        checked_windows=len(sample) * nw)
