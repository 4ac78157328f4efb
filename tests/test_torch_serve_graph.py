"""The spike engine's served segment replayed as one CUDA graph.

A window reads its index from the card (a 0-d int32 stamp: the segment's
first window plus the window's offset), so ``SpikeEngine._segment``
captures a segment's windows once and replays them.  On the CPU (about 10
s on one worker): the window with its index from a device scalar gives
the digests the window with a host index gave, on a contended mix with
bursts and on a solo mix, three segments each; segments run eagerly on
the CPU and under a fault schedule or a recorder; the bookkeeping of a
replay (``SEGMENTS``, launches, spans, the carries a caller holds), with
a stand-in for the graph that runs the captured windows again on its
buffers.  On the card (``python -m pytest -m card
tests/test_torch_serve_graph.py``): the graphed segments, served and
drain, bit for bit against an eager loop of ``_window`` on every stats
field, the host copies and the end carry, with the launches of the eager
loop; and through ``warmup`` and ``run``, the carries a caller holds left
alone by later replays.
"""
from __future__ import annotations

import contextlib
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.fabric import faults
from repro_torch.kernels import dispatch
from repro_torch.obs import recorder as obs_recorder, spans
from repro_torch.serve import loadgen as lg, spike_engine as se, tenancy

# the benchmark's serving deployment: torus3d 2x2x2, two tenants
TENANTS = (("quiet", 32, 40.0, 1.0, 0.0), ("hot", 8, 600.0, 3.0, 0.25))
CFG = dict(capacity=32, link_credits=64, notify_latency=2, window_us=100.0,
           seg_windows=8, nx=2, ny=2, nz=2)
NW = CFG["seg_windows"]
MIXES = ("contended", "solo")
SEGS = (5, 6, 7)
# events delivered and sha256 of every WindowServeStats tensor of segments
# 5-7 and of the end carry, seed 11, from the engine whose window took its
# index as a host int
DIGESTS = {"contended": (4333, "8ba5968bc89ad525"),
           "solo": (1005, "54e62524f8e50939")}


def engine(mix: str, seed: int, device="cpu", **kw) -> se.SpikeEngine:
    specs = [tenancy.TenantSpec(n, r) for n, r, *_ in TENANTS]
    profiles = [lg.TenantProfile(n, 0.0 if (mix == "solo" and n == "hot")
                                 else rate, bf, bp)
                for n, _, rate, bf, bp in TENANTS]
    src = lg.PoissonLoadGen(seed, profiles, 8, CFG["capacity"])
    return se.SpikeEngine(8, specs, se.EngineConfig(**CFG), src,
                          device=device, **kw)


def staged(eng: se.SpikeEngine, seg: int):
    """Segment ``seg``'s words (nw, S, T, S, C) and counts (nw, S, T, S)
    as the ingest thread stages them, on the engine's device."""
    ws, cs = [], []
    for i in range(NW):
        tr = eng.source.next_window(seg * NW + i)
        ws.append(torch.from_numpy(tr.words.transpose(1, 0, 2, 3).astype(
            np.uint32).view(np.int32)))
        cs.append(torch.from_numpy(tr.counts.transpose(1, 0, 2).copy()))
    return torch.stack(ws).to(eng.device), torch.stack(cs).to(eng.device)


def _update(h, tree) -> None:
    for x in se._leaves(tree):
        h.update(x.contiguous().cpu().numpy().tobytes())


def _equal(a, b) -> bool:
    la, lb = se._leaves(a), se._leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


@pytest.mark.parametrize("stamp", ["host", "device"])
@pytest.mark.parametrize("mix", MIXES)
def test_device_stamp_gives_the_host_index_digests(mix, stamp):
    """Three segments from the engine's initial carry: the windows with
    their index from a 0-d int32 tensor, and the eager segments with a
    host int, give the digests of the host-int window."""
    eng = engine(mix, 11)
    se.reset_segments()
    carry, h, delivered = eng._carry, hashlib.sha256(), 0
    for seg in SEGS:
        fw, fc_ = staged(eng, seg)
        if stamp == "device":
            carry, st = eng._segment_windows(
                carry, fw, fc_, torch.tensor(seg * NW, dtype=torch.int32))
        else:
            carry, item = eng._segment(carry, fw, fc_, seg * NW)
            st = eng._ready(item)
        _update(h, st)
        delivered += int(st.delivered.sum())
    _update(h, carry)
    assert (delivered, h.hexdigest()[:16]) == DIGESTS[mix]
    eager = len(SEGS) if stamp == "host" else 0
    assert se.SEGMENTS == {"eager": eager, "replayed": 0, "captured": 0}


@pytest.mark.timeout(300)
def test_cpu_segments_run_eagerly():
    """On the CPU the warm-up, the served segments and the drain all run
    window by window; nothing is captured."""
    eng = engine("contended", 3)
    se.reset_segments()
    eng.warmup()
    rep = eng.run(3)
    assert rep.conservation_checked and rep.windows == 3 * NW
    assert not eng._graphable and eng._graph is None
    assert se.SEGMENTS == {"eager": 1 + 3 + rep.drain_windows // NW,
                           "replayed": 0, "captured": 0}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("what", ["faults", "recorder"])
def test_faulted_and_recorded_segments_run_eagerly(what):
    """A fault schedule or a recorder keeps every segment eager, and the
    window refuses an index that is not on the host."""
    kw = ({"fault_schedule": faults.link_fault((2, 2, 2), 64, 0, 0,
                                                   start=2, device="cpu")}
          if what == "faults" else
          {"recorder": obs_recorder.RecorderConfig(depth=8)})
    eng = engine("contended", 4, **kw)
    se.reset_segments()
    rep = eng.run(2)
    assert rep.conservation_checked and eng._graph is None
    assert se.SEGMENTS == {"eager": 2 + rep.drain_windows // NW,
                           "replayed": 0, "captured": 0}
    fw, fc_ = staged(eng, 0)
    with pytest.raises(ValueError, match="on the host"):
        eng._window(eng._carry, fw[0], fc_[0],
                    torch.zeros((), dtype=torch.int32))


class _StandIn:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: ``replay`` runs
    the captured windows again on the graph's input buffers and writes
    their results into its output tensors, as a replay does."""

    def __init__(self):
        self.body = None

    def replay(self):
        self.body()


# the launches the stand-in's capture counts, as a card's would
CAPTURED = ({"admission": NW, "torus_exchange": NW, "wire_codec": 2 * NW},
            {"repro_admission_tenants": NW, "repro_tenant_exchange": NW,
             "repro_wire_encode": NW, "repro_wire_decode": NW})


@contextlib.contextmanager
def _capturing(graph, **_):
    yield
    for counts, add in zip((dispatch.LAUNCHES, dispatch.ENTRY_LAUNCHES),
                           CAPTURED):
        for k, v in add.items():
            counts[k] = counts.get(k, 0) + v


def test_replay_bookkeeping(monkeypatch):
    """With the graph stood in for: the first segment eager, the second
    captures and replays, the third replays; the digests of the eager
    windows; each replay counts the capture's launches and records a
    ``segment/replay`` span and no window span; every carry passed in or
    returned is left alone by later replays and shares no storage with the
    graph's buffers."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandIn)
    monkeypatch.setattr(torch.cuda, "graph", _capturing)
    monkeypatch.setattr(dispatch, "graph_launch", lambda g: g.replay())
    monkeypatch.setattr(dispatch, "LAUNCHES", {})
    monkeypatch.setattr(dispatch, "ENTRY_LAUNCHES", {})
    tracer = spans.Tracer()
    eng = engine("contended", 11, tracer=tracer)
    eng._graphable = True
    capture = eng._capture

    def stand_in_capture(carry):
        g = capture(carry)

        def body():
            out = eng._graph_body(g.carry_in, g.carry_views, g.fw, g.fc,
                                  g.stamp)
            for d, s in zip(se._leaves((g.stats, g.carry_out,
                                        g.stats_out)),
                            se._leaves(out), strict=True):
                d.copy_(s)
        g.graph.body = body
        return g
    monkeypatch.setattr(eng, "_capture", stand_in_capture)

    se.reset_segments()
    carry, h, delivered, held = eng._carry, hashlib.sha256(), 0, []
    for seg in SEGS:
        fw, fc_ = staged(eng, seg)
        new, item = eng._segment(carry, fw, fc_, seg * NW)
        st = eng._ready(item)      # on the CPU a view of the graph's stats
        _update(h, st)
        delivered += int(st.delivered.sum())
        held += [(carry, se._tree_map(torch.clone, carry)),
                 (new, se._tree_map(torch.clone, new))]
        carry = new
    _update(h, carry)
    assert (delivered, h.hexdigest()[:16]) == DIGESTS["contended"]
    assert se.SEGMENTS == {"eager": 1, "replayed": 2, "captured": 1}
    assert dispatch.launch_counts() == tuple(
        {k: 2 * v for k, v in d.items()} for d in CAPTURED)
    names = [e["name"] for e in tracer.to_dict()["traceEvents"]
             if e.get("ph") == "X"]
    assert [names.count(n) for n in ("segment/capture", "segment/replay",
                                     "window/exchange",
                                     "window/attribute")] == [1, 2, NW, NW]
    assert eng._graph.stamp.item() == SEGS[-1] * NW
    for obj, snap in held:
        assert _equal(obj, snap)
    g = eng._graph
    graph_ptrs = {x.data_ptr() for x in se._leaves(
        (g.carry_in, g.carry_views, g.carry_out))}
    for obj, _ in held[1:]:
        assert not graph_ptrs & {x.data_ptr() for x in se._leaves(obj)}


# -- on the card -----------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph and the kernels have no "
                    "CPU build")


@pytest.mark.card
@pytest.mark.timeout(600)
@pytest.mark.parametrize("mix", MIXES)
def test_graphed_segments_match_the_eager_windows(mix):
    """Six served segments (eager, capture, replays) and a drain segment:
    every WindowServeStats field, on the host as queued, and the end
    carry equal an eager loop of ``_window`` from the same carry; the
    launches counted equal the eager loop's."""
    _need_card()
    eng = engine(mix, 21, device="cuda")
    dispatch.reset_launches()
    se.reset_segments()
    segs = [staged(eng, k) for k in range(6)]
    segs.append((eng._zero_fw, eng._zero_fc))
    got, c = [], eng._carry
    with eng._on_stream():
        for k, (fw, fc_) in enumerate(segs):
            c, item = eng._segment(c, fw, fc_, k * NW)
            got.append((c, item))
    torch.cuda.synchronize()
    graph_launches = dispatch.launch_counts()
    assert se.SEGMENTS == {"eager": 1, "replayed": 6, "captured": 1}
    per_window = graph_launches[1]
    for sym in ("repro_admission_tenants", "repro_tenant_exchange",
                "repro_wire_encode", "repro_wire_decode"):
        assert per_window[sym] == len(segs) * NW, sym

    dispatch.reset_launches()
    loop, delivered, shed = eng._carry, 0, 0
    with eng._on_stream():
        for k, ((fw, fc_), (gc, item)) in enumerate(zip(segs, got)):
            loop, want = eng._segment_windows(loop, fw, fc_, k * NW)
            host = eng._ready(item)
            assert _equal(host, want), k
            assert _equal(gc, loop), k
            delivered += int(want.delivered.sum())
            shed += int(want.shed.sum())
    torch.cuda.synchronize()
    assert dispatch.launch_counts() == graph_launches
    assert delivered > 0 and (shed > 0) == (mix == "contended")


@pytest.mark.card
@pytest.mark.timeout(600)
def test_carries_a_caller_holds_survive_later_replays():
    """Through ``warmup`` and ``run``, as the benchmark's probe holds them:
    each segment's carry passed in and carry returned, read again after
    the run, equal their copies taken when the segment returned."""
    _need_card()

    class Holder(se.SpikeEngine):
        held: list = []

        def _segment(self, carry, fw, fc_, win0):
            out = super()._segment(carry, fw, fc_, win0)
            pair = (carry[:4], out[0][:4])
            self.held.append((pair, se._tree_map(torch.clone, pair)))
            return out

    specs = [tenancy.TenantSpec(n, r) for n, r, *_ in TENANTS]
    src = lg.PoissonLoadGen(5, [lg.TenantProfile(n, rate, bf, bp)
                                for n, _, rate, bf, bp in TENANTS],
                            8, CFG["capacity"])
    tracer = spans.Tracer()
    eng = Holder(8, specs, se.EngineConfig(**CFG), src, tracer=tracer,
                 device="cuda")
    se.reset_segments()
    eng.warmup()
    assert se.SEGMENTS == {"eager": 1, "replayed": 1, "captured": 1}
    rep = eng.run(6)
    torch.cuda.synchronize()
    assert rep.conservation_checked and rep.windows == 6 * NW
    drain = rep.drain_windows // NW
    assert se.SEGMENTS == {"eager": 1, "replayed": 1 + 6 + drain,
                           "captured": 1}
    assert len(eng.held) == 2 + 6 + drain
    for k, (pair, snap) in enumerate(eng.held):
        assert _equal(pair, snap), k
    names = [e["name"] for e in tracer.to_dict()["traceEvents"]
             if e.get("ph") == "X"]
    assert names.count("segment/replay") == 1 + 6 + drain
    assert names.count("window/exchange") == NW       # the eager warm-up
