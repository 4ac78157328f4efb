"""The frozen reference held to the port's CPU run, every window and every
field, at a tiny size (scale 0.004 over 8 shards; the serving deployment
at capacity 16)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench.harness import compare
from gpubench.inputs import loadgen
from gpubench.kinds import microcircuit as mc, spike_serve as ss
from gpubench.reference import engine as reng, lif as rlif, simulator as rsim

SEED = 2**31 + 11


@pytest.mark.parametrize("traffic", ["tiny_torus", "tiny_alltoall"])
def test_reference_follows_the_port_window_for_window(tiny_root, traffic):
    from gpubench.harness import manifest
    cell = manifest.load(tiny_root, traffic)
    inputs = mc.Inputs(cell.config, SEED, "cpu")
    prog = mc.Program(cell, inputs, "cpu")
    nw, win = 6, prog.cfg.window
    drive = inputs.drive(0, nw, win)
    carry, stats = prog.run_segment(prog.carry0, nw, drive=drive)
    f = mc.sim_fields(cell)
    net = rsim.partition(inputs.weights, torch.from_numpy(inputs.is_inh),
                         f["n_shards"])
    ref = rsim.Window(f, net, rlif.LIFParams(**cell.config["lif"]))
    r0 = ref.init(inputs.v0)
    tally = compare.Tally()
    tally.tree(prog.carry0, r0)
    end, rows = ref.segment(r0, drive)
    for i in range(nw):
        tally.tree(compare.window_of(stats, i), rows[i])
    tally.tree(carry, end)
    assert (tally.mismatched, tally.float_gap) == (0, 0.0)
    assert int(stats.spikes.sum()) > 0
    if traffic == "tiny_torus":
        assert int(stats.link.credit_stalls.sum()) > 0   # credits bind


@pytest.mark.parametrize("traffic", ["tiny_contended", "tiny_solo"])
def test_reference_serves_every_window_as_the_engine(tiny_root, traffic):
    from gpubench.harness import manifest
    from repro_torch.serve import spike_engine, tenancy
    cell = manifest.load(tiny_root, traffic)
    c = cell.config
    S, C, nw = c["n_shards"], c["capacity"], c["seg_windows"]
    src = loadgen.PoissonLoadGen(SEED, ss.profiles(cell), S, C)
    eng = spike_engine.SpikeEngine(
        S, [tenancy.TenantSpec(t["name"], t["reserve"])
            for t in c["tenants"]],
        spike_engine.EngineConfig(
            capacity=C, link_credits=c["link_credits"],
            notify_latency=c["notify_latency"], window_us=c["window_us"],
            seg_windows=nw, nx=2, ny=2, nz=2, queue_depth=2),
        src, device="cpu")
    rep = eng.run(3)
    ref = reng.Engine(S, (2, 2, 2), [t["reserve"] for t in c["tenants"]],
                      capacity=C, link_credits=c["link_credits"],
                      notify_latency=c["notify_latency"],
                      window_us=c["window_us"])
    carry, tally = ref.init(), compare.Tally()
    for j, seg in enumerate(eng.window_stats):
        for i in range(nw):
            w = j * nw + i
            if w < rep.windows:
                fw, fc_ = ss.staged(src, w)
            else:
                fw = torch.zeros((S, 2, S, C), dtype=torch.int32)
                fc_ = torch.zeros((S, 2, S), dtype=torch.int32)
            carry, want = ref.window(carry, fw, fc_, w)
            tally.tree(compare.window_of(seg, i, axis=0), want)
    _, walk = ref.drain_walk(carry, len(eng.window_stats) * nw)
    delivered = sum(seg.delivered.astype(np.int64).sum((0, 1))
                    for seg in eng.window_stats)
    delivered = delivered + sum(d.sum(0).numpy() for _, d in walk)
    assert (tally.mismatched, tally.float_gap) == (0, 0.0)
    np.testing.assert_array_equal(rep.delivered, delivered)
    assert rep.conservation_checked and rep.delivered.sum() > 0
