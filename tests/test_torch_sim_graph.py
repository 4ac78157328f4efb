"""The simulator's window loop replayed as one CUDA graph a segment.

A window reads its step count from the card (``ShardState.t``), so
``run_segment`` captures a segment's windows once and replays them.  On
the CPU (about 10 s on one worker): the window body with its step on the
device gives the digests the body with a host step gave, on each fabric;
segments run eagerly on the CPU and under a fault schedule or a recorder;
the launch bookkeeping of a replay; the cached latency bin edges.  On the
card (``python -m pytest -m card tests/test_torch_sim_graph.py``): the
graphed segments bit for bit against an eager loop of the window body on
the crossbar, the credited torus where credits bind and the sparse store,
with the carries a caller holds left alone, and the kernels' step-pointer
forms against their by-value forms.
"""
from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from repro_torch import wire
from repro_torch.core import events as ev
from repro_torch.fabric import faults
from repro_torch.kernels import dispatch, lif_step, synapse_deliver as sd
from repro_torch.obs import recorder as obs_recorder, spans
from repro_torch.snn import lif, microcircuit as mc, network, simulator as sim

S = 8
FABRICS = {
    "alltoall": dict(transport="alltoall", link_credits=0),
    "torus2d": dict(transport="torus2d", link_credits=16, torus_nx=2,
                    torus_ny=4),
    "torus3d": dict(transport="torus3d", link_credits=16, torus_nx=2,
                    torus_ny=2, torus_nz=2),
    "sparse_torus3d": dict(transport="torus3d", link_credits=16, torus_nx=2,
                           torus_ny=2, torus_nz=2),
}
# sha256 of every WindowStats tensor of two segments (4 + 3 windows) and of
# the end state's integers (refrac, t, pending, fabric), taken from the
# simulator whose window body read its step on the host, at scale 0.004
DIGESTS = {"alltoall": (167, "371cf5d57f741e2d"),
           "torus2d": (168, "cd086de08cf41839"),
           "torus3d": (167, "453b4b0eba11f7f5"),
           "sparse_torus3d": (167, "49b934fb9aff2526")}


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        subs = [_clone(x) for x in tree]
        return type(tree)(*subs) if hasattr(tree, "_fields") else tuple(subs)
    return tree


def _network(scale: float):
    spec = mc.MicrocircuitSpec(scale=scale)
    w, is_inh = spec.weight_matrix()
    return spec, network.build_partition(w, is_inh, n_shards=S)


def _sparse(p: network.Partition) -> network.SparsePartition:
    tgt, src = np.nonzero(p.weights)
    sp = network.build_sparse_partition(
        torch.from_numpy(src.astype(np.int32)),
        torch.from_numpy(tgt.astype(np.int32)),
        torch.from_numpy(p.weights[tgt, src]), p.is_inh, p.n_shards)
    sp.delays_steps = p.delays_steps.copy()
    return sp


def _drive(spec, per: int, n_windows: int, seed: int) -> torch.Tensor:
    bg = np.zeros(S * per, np.float32)
    bg[:spec.n_neurons] = spec.bg_rates()
    lam = torch.from_numpy(bg.reshape(S, per) * 1e-4)
    g = torch.Generator().manual_seed(seed)
    return torch.poisson(lam.expand(n_windows, 8, S, per), generator=g) \
        * 87.8


def _cfg(p, fabric: str, capacity: int = 16, e_max: int = 256,
         residue: int = 64, **over) -> sim.SimConfig:
    kw = dict(FABRICS[fabric], **over)
    return sim.SimConfig(n_shards=S, per_shard=p.per_shard,
                         max_fan=p.fanout.shape[1], capacity=capacity,
                         e_max=e_max, residue=residue, notify_latency=2,
                         **kw)


@pytest.fixture(scope="module")
def small():
    return _network(0.004)


@pytest.mark.parametrize("fabric", list(FABRICS))
def test_device_step_body_gives_the_host_step_digests(small, fabric):
    """On the CPU, two segments of each fabric give the stats and end
    integers that the body with a host-side step gave, run eagerly."""
    spec, p = small
    part = _sparse(p) if fabric.startswith("sparse") else p
    init, run_segment, _ = sim.build_sharded_segments(
        _cfg(p, fabric), part, spec.bg_rates(), device="cpu")
    sim.reset_segments()
    c, h, spikes = init(0), hashlib.sha256(), 0
    for k, n in enumerate((4, 3)):
        c, st = run_segment(c, n,
                            drive=_drive(spec, p.per_shard, n, 10 + k))
        for x in sim.tensors_of(st):
            h.update(x.contiguous().numpy().tobytes())
        spikes += int(st.spikes.sum())
    end = (c.state.neuron.refrac, c.state.t, c.pending, c.link)
    for x in sim.tensors_of(end):
        h.update(x.contiguous().numpy().tobytes())
    assert (spikes, h.hexdigest()[:16]) == DIGESTS[fabric]
    assert sim.SEGMENTS == {"eager": 2, "replayed": 0, "captured": 0}


def test_cpu_segments_run_eagerly(small):
    """The same number of windows again and again: every segment eager,
    nothing captured, and the generator's drive still drawn."""
    spec, p = small
    init, run_segment, _ = sim.build_sharded_segments(
        _cfg(p, "alltoall"), p, spec.bg_rates(), device="cpu")
    sim.reset_segments()
    c = init(5)
    for _ in range(3):
        c, st = run_segment(c, 2)
    assert int(c.state.t[0]) == 48 and c.state.generator is not None
    assert sim.SEGMENTS == {"eager": 3, "replayed": 0, "captured": 0}


@pytest.mark.parametrize("what", ["faults", "recorder"])
def test_faulted_and_recorded_segments_run_eagerly(small, what):
    """A fault schedule or a recorder keeps every segment eager, and the
    window body refuses to run them without the step on the host."""
    spec, p = small
    cfg = _cfg(p, "torus3d")
    kw = ({"fault_schedule": faults.link_fault((2, 2, 2), 8, 0, 0,
                                                   device="cpu")}
          if what == "faults" else
          {"recorder": obs_recorder.RecorderConfig(depth=8)})
    init, run_segment, _ = sim.build_sharded_segments(
        cfg, p, spec.bg_rates(), device="cpu", **kw)
    sim.reset_segments()
    c = init(0)
    for k in range(3):
        c, _ = run_segment(c, 2, drive=_drive(spec, p.per_shard, 2, k))
    assert sim.SEGMENTS == {"eager": 3, "replayed": 0, "captured": 0}
    _, _, body, _ = sim.make_pipeline_fns(cfg, device="cpu", **kw)
    wi = sim.window_inputs(cfg, p, spec.bg_rates(), device="cpu")
    with pytest.raises(ValueError, match="on the host"):
        body(tuple(c), None, *wi[:4], _drive(spec, p.per_shard, 1, 9)[0])


def test_launch_bookkeeping_of_a_replay(monkeypatch):
    """A capture's launches are taken back and returned; each replay
    counts them again, by kernel and by entry point."""
    monkeypatch.setattr(dispatch, "LAUNCHES", {"lif_step": 2})
    monkeypatch.setattr(dispatch, "ENTRY_LAUNCHES", {"repro_lif_window": 2})
    before = dispatch.launch_counts()
    dispatch.LAUNCHES.update(lif_step=5, flush_window=3)
    dispatch.ENTRY_LAUNCHES.update(repro_lif_window=5,
                                   repro_flush_window=3)
    taken = dispatch.take_launches(before)
    assert taken == ({"lif_step": 3, "flush_window": 3},
                     {"repro_lif_window": 3, "repro_flush_window": 3})
    assert dispatch.launch_counts() == before
    for _ in range(2):
        dispatch.count_launches(taken)
    assert dispatch.LAUNCHES == {"lif_step": 8, "flush_window": 6}
    assert dispatch.ENTRY_LAUNCHES == {"repro_lif_window": 8,
                                       "repro_flush_window": 6}


def test_latency_bin_edges_made_once_per_device():
    """``summarize_latency`` bins against one cached tensor of the edges,
    with the histogram of a direct search."""
    g = torch.Generator().manual_seed(4)
    lat = torch.rand((3, 50), generator=g) * 5000.0
    w = torch.randint(0, 4, (3, 50), generator=g)
    edges = wire.latency._bin_edges(torch.device("cpu"))
    assert edges is wire.latency._bin_edges(torch.device("cpu"))
    got = wire.summarize_latency(lat, w, batch_dims=1)
    bins = torch.searchsorted(torch.tensor(wire.LATENCY_BIN_EDGES_US),
                              lat, right=True)
    want = torch.zeros((3, wire.N_LATENCY_BINS), dtype=torch.int32
                       ).scatter_add_(-1, bins, w.to(torch.int32))
    assert torch.equal(got.hist, want)


# -- on the card -----------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph and the kernels have no "
                    "CPU build")


@pytest.fixture(scope="module")
def medium():
    return _network(0.03)            # ~290 neurons a shard


CARD_CASES = {
    "alltoall": dict(capacity=64),
    "torus3d": dict(capacity=32, link_credits=32),   # credits bind
    "sparse_torus3d": dict(capacity=32, link_credits=32),
}


@pytest.mark.card
@pytest.mark.parametrize("fabric", list(CARD_CASES))
def test_graphed_segments_match_the_eager_body(medium, fabric):
    """Segments of 16 windows (eager, capture, replays), then of 5 (a
    second capture): every WindowStats field and the end carry equal an
    eager loop of the window body over the same drives; the carries
    returned earlier are unchanged after later replays; the launches
    counted equal the eager loop's; the tracer holds a span for each
    capture and replay, and delivery spans of the eager windows only."""
    _need_card()
    spec, p = medium
    part = _sparse(p) if fabric.startswith("sparse") else p
    cfg = _cfg(p, fabric, e_max=512, residue=128, **CARD_CASES[fabric])
    lengths = (16, 16, 16, 16, 5, 5, 5)
    drives = [_drive(spec, p.per_shard, n, 100 + j).cuda()
              for j, n in enumerate(lengths)]
    tracer = spans.Tracer()
    init, run_segment, _ = sim.build_sharded_segments(
        cfg, part, spec.bg_rates(), device="cuda", tracer=tracer)
    c0 = init(0)
    c0 = c0._replace(state=c0.state._replace(generator=None))

    dispatch.reset_launches()
    sim.reset_segments()
    got, held, c = [], [], c0
    for n, d in zip(lengths, drives):
        c, st = run_segment(c, n, drive=d)
        got.append((c, st))
        held.append(_clone(c))
    torch.cuda.synchronize()
    graph_launches = dispatch.launch_counts()
    assert sim.SEGMENTS == {"eager": 2, "replayed": 5, "captured": 2}
    names = [e["name"] for e in tracer.to_dict()["traceEvents"]
             if e.get("ph") == "X"]
    assert (names.count("segment/capture"), names.count("segment/replay"),
            names.count("window/deliver")) == (
        2, 5, 16 + 5 if part is not p else 0)

    _, _, body, _ = sim.make_pipeline_fns(cfg, device="cuda",
                                          sparse=part is not p)
    wi = sim.window_inputs(cfg, part, spec.bg_rates(), device="cuda")
    dispatch.reset_launches()
    loop = tuple(_clone(c0))[:3]
    deferred = 0
    for (gc, gst), d in zip(got, drives):
        rows = []
        for k in range(d.shape[0]):
            loop, st = body(loop, None, *wi[:4], d[k])
            rows.append(st)
        want = sim.stack_windows(rows)
        for a, b in zip(sim.tensors_of(gst), sim.tensors_of(want),
                        strict=True):
            assert torch.equal(a, b)
        for a, b in zip(sim.tensors_of(gc), sim.tensors_of(loop), strict=True):
            assert torch.equal(a, b)
        deferred += int(gst.deferred.sum())
    torch.cuda.synchronize()
    assert dispatch.launch_counts() == graph_launches
    for (gc, _), h in zip(got, held):
        for a, b in zip(sim.tensors_of(gc), sim.tensors_of(h), strict=True):
            assert torch.equal(a, b)
    assert int(got[-1][1].spikes.sum()) > 0
    assert (deferred > 0) == (cfg.link_credits > 0)


@pytest.mark.card
def test_graphed_generator_drive_matches_eager(medium):
    """Without a drive the graphed segments draw it from the carry's
    generator, window by window in the eager loop's order."""
    _need_card()
    spec, p = medium
    cfg = _cfg(p, "alltoall", capacity=64, e_max=512, residue=128)
    bg_rates = spec.bg_rates()
    init, run_segment, _ = sim.build_sharded_segments(
        cfg, p, bg_rates, device="cuda")
    c = init(7)
    for _ in range(3):
        c, st = run_segment(c, 8)
    _, _, body, _ = sim.make_pipeline_fns(cfg, device="cuda")
    wi = sim.window_inputs(cfg, p, bg_rates, device="cuda")
    e = init(7)
    loop = (e.state, e.pending, e.link)
    for _ in range(24):
        d = lif.poisson_input(wi.bg.expand(8, S, p.per_shard), 87.8,
                              cfg.params.dt, generator=e.state.generator)
        loop, est = body(loop, None, *wi[:4], d)
    for a, b in zip(sim.tensors_of(c), sim.tensors_of(loop), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(st.spikes[:, -1], est.spikes)


@pytest.mark.card
def test_step_pointer_forms_match_by_value():
    """The LIF window and delivery read the step through a pointer with the
    slots, wraps and deadlines of their by-value forms, bit for bit."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    per, L, w = 300, 32, 8
    params = lif.LIFParams()
    state = lif.init_state((S, per), params, generator=g, device="cuda")
    rings = [torch.rand((L, S, per), generator=g, device="cuda") * 400
             for _ in range(2)]
    drive = torch.rand((w, S, per), generator=g, device="cuda") * 300
    for t in (0, 24, 31, 32, 1000, 32767, 40003):
        out = []
        for step in (t, torch.full((S,), t, dtype=torch.int32,
                                   device="cuda")):
            r = [x.clone() for x in rings]
            n, spk = lif_step.lif_window(state, params, *r, step, drive)
            out.append((*n, spk, *r))
        for a, b in zip(*out):
            assert torch.equal(a, b), t

    _, p = _network(0.004)
    sp = _sparse(p)
    store = network.SynapseStore(*(x.cuda() for x in sp.store))
    inh = torch.from_numpy(p.is_inh).cuda()
    C, per = 12, p.per_shard
    rings = [torch.rand((L, S, per), generator=g, device="cuda") * 400
             for _ in range(2)]
    gc = torch.Generator().manual_seed(3)
    for t in (5, 4096, 32770):
        addr = torch.randint(0, per, (S, S, C), generator=gc)
        ts = (t + torch.randint(-3, 16, (S, S, C), generator=gc)) \
            & ev.TS_MASK
        words = ev.pack(addr, ts).cuda()
        counts = torch.randint(0, C + 1, (S, S), generator=gc).to(
            torch.int32).cuda()
        out = []
        for step in (t, torch.full((S,), t, dtype=torch.int32,
                                   device="cuda")):
            r = [x.clone() for x in rings]
            miss = sd.synapse_deliver(*r, words, counts, step, store, inh,
                                      per)
            out.append((miss, *r))
        for a, b in zip(*out):
            assert torch.equal(a, b), t
