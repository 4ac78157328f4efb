"""Observability, port vs reference on the CPU (where kernel F's wrappers
run their plain loops):

* spans, metrics and logging: the same call sequence gives the same trace
  layout, the same ``validate_trace`` problems, the same Prometheus text
  and parse, the same JSONL snapshot and the same logger levels;
* the flight recorder's ring: ``ring_init`` / ``record`` / ``ring_rows`` /
  wrap / ``counter_totals`` on the same inputs, and ``global_rows`` of a
  ring with a shard axis against the reference's on the stacked per-shard
  rings;
* kernel F's stall lane: ``stalled_by_link`` of the four admission loops
  against ``jax.jit`` of the reference's ``_admit_global``,
  ``_admit_global_faulted``, ``_admit_tenants`` and
  ``_admit_tenants_faulted`` (built with ``stall_attribution=True``, so
  their ``_stall_attr`` runs), on threaded chaos windows of torus2d and
  torus3d; the table sums to the global deferred total;
* the recorded simulator on alltoall, torus2d, torus3d and torus3d under a
  dead cable (scale 0.003, 8 shards, 6 windows, the reference's initial
  state and drive): every ``WindowStats`` field, the global and every
  shard's ring rows bit for bit, and the recorder-off run equal to the
  recorded one;
* the instrumented spike engine on 1 and 8 shards: ``recorder_rows``
  (global and per shard), the run directory's report (apart from the host
  clock's fields), its Prometheus text, and the trace's spans per name;
* the Mamba-2 engine's ``serve/prefill`` and ``serve/decode`` spans on the
  reduced model, tokens equal with and without a tracer;
* the disabled path: carry structure, and outputs equal with the recorder
  on and off; the report's command line.

Every reference case that needs a mesh runs in one subprocess with 8
forced host devices (``md_helper.run_md``), on Auto-axis meshes, its
outputs turned into numpy before any per-shard indexing.
"""
import collections
import json
import logging
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from md_helper import SRC, run_md  # noqa: E402
from repro.core import flow_control as r_fc  # noqa: E402
from repro.fabric import faults as r_faults  # noqa: E402
from repro.obs import log as r_log, metrics as r_metrics  # noqa: E402
from repro.obs import recorder as r_rec, spans as r_spans  # noqa: E402
from repro.transport import base as r_base, torus as r_tt  # noqa: E402
from repro_torch import convert, obs  # noqa: E402
from repro_torch.core import flow_control as t_fc  # noqa: E402
from repro_torch.fabric import faults as t_faults  # noqa: E402
from repro_torch.obs import log as t_log, metrics as t_metrics  # noqa: E402
from repro_torch.obs import recorder as t_rec, report as t_report  # noqa: E402
from repro_torch.obs import spans as t_spans  # noqa: E402
from repro_torch.serve import loadgen as t_lg, spike_engine as t_se  # noqa: E402,E501
from repro_torch.serve import tenancy as t_ten  # noqa: E402
from repro_torch.snn import microcircuit as mc, network  # noqa: E402
from repro_torch.snn import simulator as sim  # noqa: E402
from repro_torch.transport import base as t_base  # noqa: E402
from repro_torch.transport import torus as t_tt  # noqa: E402

# the recorded simulator: the fabric tests' congested credits, 8 shards
SIM_SCALE, SIM_SHARDS, SIM_WINDOWS, SEED, DEPTH = 0.003, 8, 6, 0, 8
SIM_CFG = dict(window=8, ring_len=32, e_max=256, capacity=8, residue=64,
               link_credits=8, notify_latency=3)
SIMS = {"alltoall": ("alltoall", {}, False),
        "torus2d": ("torus2d", {"torus_nx": 2, "torus_ny": 4}, False),
        "torus3d": ("torus3d", {"torus_nx": 2, "torus_ny": 2,
                                "torus_nz": 2}, False),
        # a dead cable from window 2: the fault schedule path records too
        "torus3d-fault": ("torus3d", {"torus_nx": 2, "torus_ny": 2,
                                      "torus_nz": 2}, True)}
SIM_DIMS = (2, 2, 2)

# the instrumented engine: tests/test_obs.py's one-shard engine, and
# benchmarks/bench_serve.py's deployment, contended, a cable dead from
# window 2, 3 segments
ENGINES = {
    "one": dict(n=1, cfg=dict(capacity=8, link_credits=16, seg_windows=3,
                              nx=1, ny=1, nz=1),
                tenants=(("a", 8, 10.0), ("b", 4, 30.0)), seed=3,
                segments=4, depth=32, fault=False),
    "eight": dict(n=8, cfg=dict(capacity=32, link_credits=64,
                                notify_latency=2, window_us=100.0,
                                seg_windows=8, nx=2, ny=2, nz=2),
                  tenants=(("quiet", 32, 40.0), ("hot", 8, 600.0)),
                  seed=7, segments=3, depth=64, fault=True)}
# meta fields read off the host clock
HOST_CLOCK = ("wall_s", "events_per_s")


def engine_parts(pkg_lg, pkg_se, pkg_ten, case):
    """(tenant specs, EngineConfig, load generator) of either package."""
    specs = [pkg_ten.TenantSpec(name, reserve=r, rate_epw=rate)
             for name, r, rate in case["tenants"]]
    profiles = [pkg_lg.TenantProfile(name, rate,
                                     *((3.0, 0.25) if name == "hot" else ()))
                for name, _, rate in case["tenants"]]
    cfg = pkg_se.EngineConfig(**case["cfg"])
    src = pkg_lg.PoissonLoadGen(case["seed"], profiles, case["n"],
                                cfg.capacity)
    return specs, cfg, src


REF_SCRIPT = r"""
import json, sys, tempfile
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
sys.path.insert(0, %(TESTS)r)
from repro import obs
from repro.fabric import faults
from repro.obs import recorder as rec, report as report, spans
from repro.serve import loadgen as lg, spike_engine as se, tenancy as ten
from repro.snn import lif, microcircuit as mc, network, simulator as sim
import test_torch_obs as T

out = {}
def flat(tree, prefix):
    if tree is None:
        return
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            flat(getattr(tree, f), prefix + f + ".")
    else:
        out[prefix[:-1]] = np.asarray(tree)     # numpy before any indexing

tm = jax.tree_util.tree_map
def rows_of(ring, n, prefix):
    ring = tm(np.asarray, ring)
    out[prefix + "rows"] = np.array(json.dumps(rec.global_rows(ring, n)))
    for s in range(n):
        out[prefix + "shard%%d" %% s] = np.array(json.dumps(
            rec.ring_rows(rec.ring_shard(ring, s))))

SS, NW = T.SIM_SHARDS, T.SIM_WINDOWS
spec = mc.MicrocircuitSpec(scale=T.SIM_SCALE)
part = network.build_partition(*spec.weight_matrix(), n_shards=SS)
per = part.per_shard
mesh = Mesh(np.array(jax.devices()[:SS]), ("wafer",))
for name, (transport, kw, fault) in T.SIMS.items():
    cfg = sim.SimConfig(n_shards=SS, per_shard=per,
                        max_fan=part.fanout.shape[1], transport=transport,
                        **{**T.SIM_CFG, **kw})
    sched = (faults.link_fault(T.SIM_DIMS, NW, 0, 0, start=2) if fault
             else None)
    init, run = sim.build_sharded_sim(
        mesh, "wafer", cfg, part, spec.bg_rates(), fault_schedule=sched,
        recorder=obs.RecorderConfig(depth=T.DEPTH))
    st0 = init(T.SEED)
    st1, stats, ring = run(st0, NW)
    flat(st0, "sim.%%s.init." %% name)
    flat(st1, "sim.%%s.final." %% name)
    flat(stats, "sim.%%s.stats." %% name)
    rows_of(ring, SS, "sim.%%s." %% name)

bg = np.pad(spec.bg_rates(), (0, part.n_neurons - len(spec.bg_rates())))
bg = bg.reshape(SS, per)

@jax.jit
def draws(key, rate):
    def step(k, _):
        k, sub = jax.random.split(k)
        return k, lif.poisson_input(sub, per, rate, 87.8, 0.1)
    return jax.lax.scan(step, key, None, length=NW * 8)[1]

drive = np.stack([np.asarray(draws(jax.random.PRNGKey(s + T.SEED * 1000 + 7),
                                   jnp.asarray(bg[s]))) for s in range(SS)])
out["sim.drive"] = drive.reshape(SS, NW, 8, per).transpose(1, 2, 0, 3)

for label, case in T.ENGINES.items():
    n = case["n"]
    specs, cfg, src = T.engine_parts(lg, se, ten, case)
    sched = (faults.link_fault((2, 2, 2), 64, 0, 0, start=2)
             if case["fault"] else None)
    eng = se.SpikeEngine(Mesh(np.array(jax.devices()[:n]), ("w",)), "w",
                         specs, cfg, src, fault_schedule=sched,
                         recorder=obs.RecorderConfig(depth=case["depth"]),
                         tracer=spans.Tracer())
    rep = eng.run(case["segments"])
    rows_of(eng._carry[4], n, "eng.%%s." %% label)
    run_dir = report.write_engine_run(tempfile.mkdtemp(), eng, rep)
    out["eng.%%s.report" %% label] = np.array(json.dumps(
        report.build_report(run_dir)))
    out["eng.%%s.prom" %% label] = np.array(
        open(run_dir + "/metrics.prom").read())
    out["eng.%%s.trace" %% label] = np.array(json.dumps(eng.tracer.to_dict()))
    out["eng.%%s.delivered" %% label] = rep.delivered
np.savez(%(PATH)r, **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "obs.npz")
    out = run_md(REF_SCRIPT % dict(TESTS=os.path.dirname(
        os.path.abspath(__file__)), PATH=path), n_devices=8, timeout=900)
    assert "REF_OK" in out
    with np.load(path) as f:
        return dict(f)


def _json(ref, key):
    return json.loads(str(ref[key]))


def _same(got, want, where=""):
    """Equal JSON trees: ints and strings exactly, floats at rtol 1e-6
    (the latency digests' mean and max, as the serve tests hold them)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (where, sorted(set(got) ^ set(want)))
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert got == pytest.approx(want, rel=1e-6, abs=1e-9), where
    else:
        assert got == want and type(got) is type(want), (where, got, want)


# ---------------------------------------------------------------------------
# Spans, metrics, logging.
# ---------------------------------------------------------------------------

def _trace_calls(pkg):
    tr = pkg.Tracer(process_name="run")
    with tr.span("ingest/fill", track="spike-ingest", seg=0, win0=0) as sp:
        sp.args["extra"] = 1
    tr.complete("device/segment", 5.0, 3.0, track="device", win0=0,
                windows=2)
    tr.complete("device/neg", 9.0, -1.0, track="device")
    tr.instant("window", track="device", cat="device", ts_us=10.0, window=0)
    with tr.span("serve/decode", batch=2):     # the thread's own track
        pass
    off = pkg.Tracer(enabled=False)
    with off.span("x") as sp2:
        pass
    return tr, sp, sp2


def _layout(trace):
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur")}
            for ev in trace["traceEvents"]]


def test_spans_match_reference():
    (a, sa, oa), (b, sb, ob) = _trace_calls(t_spans), _trace_calls(r_spans)
    da, db = a.to_dict(), b.to_dict()
    assert _layout(da) == _layout(db)
    assert da["displayTimeUnit"] == db["displayTimeUnit"]
    assert sa.args == sb.args and sa.dur_us >= 0 and oa.dur_s >= 0
    assert t_spans.NULL.enabled is False and not t_spans.NULL.to_dict()[
        "traceEvents"][1:]
    for events in (da, db):
        for ev in events["traceEvents"]:
            if ev["name"] == "device/neg":
                assert ev["dur"] == 0.0
    assert t_spans.validate_trace(da) == r_spans.validate_trace(db) == []
    assert t_spans.thread_names(da) == r_spans.thread_names(db)
    bad = [{"traceEvents": []}, [], {"traceEvents": [
        {"ph": "X", "name": "a", "ts": 5, "dur": -1},
        {"name": "b"}, {"ph": "X", "name": "c"},
        {"ph": "i", "name": "d", "ts": 1},
        {"ph": "M", "name": "thread_name", "tid": 3, "args": {"name": "t"}}]}]
    for obj in bad:
        assert t_spans.validate_trace(obj) == r_spans.validate_trace(obj)
        assert t_spans.thread_names(obj) == r_spans.thread_names(obj)


def test_tracer_is_thread_safe():
    import threading
    tr = t_spans.Tracer()

    def work(k):
        for i in range(200):
            with tr.span("w", track=f"t{k}", i=i):
                pass
    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    d = tr.to_dict()
    assert t_spans.validate_trace(d) == []
    assert len([e for e in d["traceEvents"] if e["ph"] == "X"]) == 800
    assert sorted(t_spans.thread_names(d).values()) == [f"t{k}"
                                                         for k in range(4)]


def _metric_calls(pkg, hist):
    reg = pkg.Registry()
    c = reg.counter("fabric_x_total", "X events.", labels=("backend",))
    c.inc(3, backend="torus")
    c.inc(2.5, backend="alltoall")
    reg.gauge("engine_events_per_s", "Rate.").set(1234.5)
    h = reg.histogram("lat_us", "Latency.", labels=("tenant",))
    h.add_binned(hist, sum_value=42.0, tenant="a")
    h.add_binned(hist[:-1], tenant="b")          # no overflow bin, estimated
    h.observe(3.0, tenant="a")
    h.observe(1e9, tenant="b")
    assert reg.counter("fabric_x_total", labels=("backend",)) is c
    return reg, h


def test_metrics_match_reference(tmp_path):
    rng = np.random.default_rng(0)
    hist = rng.integers(0, 50, 16)
    a, ha = _metric_calls(t_metrics, torch.from_numpy(hist))
    b, hb = _metric_calls(r_metrics, hist)
    ta, tb = t_metrics.prometheus_text(a), r_metrics.prometheus_text(b)
    assert ta == tb
    assert t_metrics.parse_prometheus(ta) == r_metrics.parse_prometheus(tb)
    for q in (0.0, 0.5, 0.99, 1.0):
        for t in ("a", "b"):
            assert ha.percentile(q, tenant=t) == hb.percentile(q, tenant=t)
    assert a.snapshot(ts=1.0) == b.snapshot(ts=1.0)
    t_metrics.write_jsonl(str(tmp_path / "a.jsonl"), a, ts=2.0)
    r_metrics.write_jsonl(str(tmp_path / "b.jsonl"), b, ts=2.0)
    assert (tmp_path / "a.jsonl").read_text() == \
        (tmp_path / "b.jsonl").read_text()
    for bad in ("x{a=1} 2", "x 1\n# TYPE y counter\ny 2", "x y z w"):
        with pytest.raises(ValueError):
            t_metrics.parse_prometheus(bad)
        with pytest.raises(ValueError):
            r_metrics.parse_prometheus(bad)
    reg = t_metrics.Registry()
    with pytest.raises(ValueError):
        reg.counter("bad name")
    with pytest.raises(ValueError):
        reg.counter("ok_total", labels=("a",)).inc(1)
    with pytest.raises(ValueError):
        reg.gauge("ok_total")
    with pytest.raises(ValueError):
        reg.counter("ok_total", labels=("a",)).inc(-1, a=1)
    with pytest.raises(ValueError):
        reg.histogram("h").add_binned(np.zeros(3))


def test_link_stats_and_digest_feeders_match_reference():
    rng = np.random.default_rng(1)
    vals = {f: rng.integers(0, 100, (3, 8)).astype(np.int32)
            for f in t_base.LinkStats._fields}
    vals["queue_dwell_us"] = rng.random((3, 8)).astype(np.float32)
    t_stats = t_base.LinkStats(**{f: torch.from_numpy(v)
                                  for f, v in vals.items()})
    r_stats = r_base.LinkStats(**{f: jnp.asarray(v)
                                  for f, v in vals.items()})
    a, b = t_metrics.Registry(), r_metrics.Registry()
    t_metrics.export_link_stats(a, t_stats, backend="torus3d")
    r_metrics.export_link_stats(b, r_stats, backend="torus3d")
    from repro.serve import tenancy as r_ten
    ledger_t, ledger_r = (t_ten.TenantLedger(["q", "h"]),
                          r_ten.TenantLedger(["q", "h"]))
    for lg in (ledger_t, ledger_r):
        lg.add_injected(np.array([40, 900]), np.array([0, 3]))
        lg.add_windows(np.array([[30, 500]]), np.array([[0, 200]]),
                       np.tile(np.arange(16), (1, 2, 1)),
                       np.array([[12.0, 900.5]]), np.array([[3.5, 77.25]]))
    ledger_t.export_metrics(a)
    ledger_r.export_metrics(b)
    assert t_metrics.prometheus_text(a) == r_metrics.prometheus_text(b)


def test_logging_matches_reference(capsys):
    for pkg, root in ((t_log, "repro_torch"), (r_log, "repro")):
        assert pkg.get_logger().name == root
        assert pkg.get_logger("x.y").name == f"{root}.x.y"
        assert pkg.get_logger(f"{root}.z").name == f"{root}.z"
        assert pkg.get_logger("benchmarks.b").name == "benchmarks.b"
        assert pkg.setup_logging(quiet=True).level == logging.ERROR
        assert pkg.setup_logging(verbose=True).level == logging.DEBUG
        assert pkg.setup_logging("INFO").level == logging.INFO
        import argparse
        ap = argparse.ArgumentParser()
        pkg.add_log_args(ap)
        args = ap.parse_args(["--quiet"])
        assert pkg.setup_logging_from_args(args).level == logging.ERROR
        pkg.setup_logging("WARNING")
    t_log.get_logger("obs").warning("to stderr")
    out = capsys.readouterr()
    assert out.out == ""


# ---------------------------------------------------------------------------
# The ring.
# ---------------------------------------------------------------------------

class _Bank:
    def __init__(self, credits):
        self.credits = credits


class _State:
    def __init__(self, credits, pbl):
        self.bank, self.parked_by_link = _Bank(credits), pbl


def _inputs(n_win, lead, counter_shape, seed):
    """Per-window (stats fields, credits, pbl, sbl, hist) as numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_win):
        out.append((rng.integers(0, 99, (9,) + lead + counter_shape),
                    rng.integers(0, 9, (6,)), rng.integers(0, 9, (6,)),
                    rng.integers(0, 9, (4,)),
                    rng.integers(0, 9, lead + (3,))))
    return out


def _stats(pkg, fields, sbl):
    vals = dict(zip(r_rec.COUNTER_FIELDS, fields))
    ns = collections.namedtuple("S", list(vals) + ["stalled_by_link"])
    if pkg is t_rec:
        return ns(**{k: torch.from_numpy(np.asarray(v, np.int32))
                     for k, v in vals.items()},
                  stalled_by_link=None if sbl is None
                  else torch.from_numpy(sbl.astype(np.int32)))
    return ns(**{k: jnp.asarray(v, jnp.int32) for k, v in vals.items()},
              stalled_by_link=None if sbl is None else jnp.asarray(sbl))


@pytest.mark.parametrize("depth,n_win,counter_shape,with_sbl", [
    (8, 6, (), True), (4, 6, (), True), (5, 5, (2,), False),
    (3, 10, (2,), True)])
def test_ring_matches_reference(depth, n_win, counter_shape, with_sbl):
    """``ring_init`` / ``record`` / ``ring_rows`` / ``counter_totals`` on
    the same inputs, wrapped or not, single-tenant or with a tenant
    axis."""
    ins = _inputs(n_win, (), counter_shape, depth)
    t0 = torch.from_numpy
    ta = t_rec.ring_init(depth, _State(t0(ins[0][1].astype(np.int32)), None),
                         counter_shape, (3,), 4)
    ra = r_rec.ring_init(depth, _State(jnp.asarray(ins[0][1], jnp.int32),
                                       None), counter_shape, (3,), 4)
    for w, (fields, cr, pbl, sbl, hist) in enumerate(ins):
        sbl = sbl if with_sbl else None
        ta = t_rec.record(ta, w + 10, _stats(t_rec, fields, sbl),
                          _State(t0(cr.astype(np.int32)),
                                 t0(pbl.astype(np.int32))),
                          t0(hist.astype(np.int32)))
        ra = r_rec.record(ra, w + 10, _stats(r_rec, fields, sbl),
                          _State(jnp.asarray(cr, jnp.int32),
                                 jnp.asarray(pbl, jnp.int32)),
                          jnp.asarray(hist, jnp.int32))
    got, want = t_rec.ring_rows(ta), r_rec.ring_rows(ra)
    _same(got, want)
    assert ta.cursor == n_win and ta.depth == depth
    if n_win > depth:
        with pytest.raises(ValueError, match="wrapped"):
            t_rec.counter_totals(got)
    else:
        ta_tot, ra_tot = t_rec.counter_totals(got), r_rec.counter_totals(want)
        for f in t_rec.COUNTER_FIELDS:
            assert np.array_equal(ta_tot[f], ra_tot[f]), f


def test_sharded_ring_matches_reference_per_shard_rings():
    """A ring with a shard axis: ``ring_shard`` and ``global_rows`` equal
    the reference's on its per-shard rings stacked as ``shard_map``
    returns them."""
    S, depth, n_win, C = 3, 4, 6, (2,)
    ins = [_inputs(n_win, (), C, 100 + s) for s in range(S)]
    shared = _inputs(n_win, (), C, 99)          # the replicated lanes
    t0 = lambda a: torch.from_numpy(a.astype(np.int32))
    st = lambda w, pkg: _State(
        *(t0(shared[w][i]) if pkg is t_rec else jnp.asarray(shared[w][i],
                                                              jnp.int32)
          for i in (1, 2)))
    ta = t_rec.ring_init(depth, st(0, t_rec), C, (3,), 4, n_shards=S)
    rings = [r_rec.ring_init(depth, st(0, r_rec), C, (3,), 4)
             for _ in range(S)]
    for w in range(n_win):
        fields = np.stack([ins[s][w][0] for s in range(S)], axis=1)
        hist = np.stack([ins[s][w][4] for s in range(S)])
        sbl = np.broadcast_to(shared[w][3], (S, 4))    # per-shard copies
        ta = t_rec.record(ta, w, _stats(t_rec, fields, sbl), st(w, t_rec),
                          t0(hist))
        for s in range(S):
            rings[s] = r_rec.record(rings[s], w, _stats(
                r_rec, ins[s][w][0], shared[w][3]), st(w, r_rec),
                jnp.asarray(ins[s][w][4], jnp.int32))
    stacked = jax.tree_util.tree_map(lambda *x: np.stack(
        [np.asarray(v) for v in x]), *rings)
    _same(t_rec.global_rows(ta, S), r_rec.global_rows(stacked, S))
    for s in range(S):
        _same(t_rec.ring_rows(t_rec.ring_shard(ta, s)),
              r_rec.ring_rows(r_rec.ring_shard(stacked, s)))
    with pytest.raises(ValueError, match="shard axis"):
        t_rec.ring_rows(ta)
    with pytest.raises(ValueError):
        t_rec.ring_init(0, st(0, t_rec), (), (3,), 4)


# ---------------------------------------------------------------------------
# Kernel F's stall lane: the four admission loops.
# ---------------------------------------------------------------------------

def _ref_state(state, lead, width=4):
    f = lambda x: jnp.asarray(x.numpy())
    return r_base.FabricState(
        bank=r_fc.CreditBank(*(f(x) for x in state.bank)),
        parked_count=f(state.parked_count), parked_hop=f(state.parked_hop),
        parked_age=f(state.parked_age),
        parked_by_link=f(state.parked_by_link),
        parked_payload=jnp.zeros(lead + (width,), jnp.uint32),
        parked_hold_shared=f(state.parked_hold_shared))


@pytest.mark.parametrize("dims", [(2, 4), (2, 2, 2)])
@pytest.mark.parametrize("form", ["single", "tenant"])
def test_stall_lane_of_the_admission_loops_matches_reference(dims, form):
    """``stalled_by_link`` of the healthy and the faulted replay against the
    reference's ``_stall_attr`` on 12 threaded windows (healthy for 3,
    then chaos masks: detours, evictions, unroutable rows); every other
    field too; the table sums to the window's deferred events."""
    n = int(np.prod(dims))
    masks = np.asarray(r_faults.chaos(dims, 12, n, revive_p=0.1).link_down)
    rng = np.random.default_rng(n)
    if form == "single":
        kw = dict(link_credits=24, notify_latency=2, max_row_events=24,
                  stall_attribution=True)
        t, r = t_tt.TorusTransport(n, dims, **kw), r_tt.TorusTransport(
            n, dims, **kw)
        healthy, faulted = (jax.jit(r._admit_global),
                            jax.jit(r._admit_global_faulted))
        port = t._admit_global
        shape, lead, hi = (n, n), (n, n), 25
    else:
        reserve = (8, 0, 4)
        mk = lambda pkg, fc: pkg.TenantTorusTransport(
            n, dims, partition=fc.make_partition(24, reserve),
            notify_latency=2, max_row_events=12, stall_attribution=True)
        t, r = mk(t_tt, t_fc), mk(r_tt, r_fc)
        healthy, faulted = (jax.jit(r._admit_tenants),
                            jax.jit(r._admit_tenants_faulted))
        port = t._admit_tenants
        shape, lead, hi = (len(reserve), n, n), (n, len(reserve), n), 13
    state = t.init_state(4, device="cpu")
    stalled = 0
    for w in range(12):
        counts = rng.integers(0, hi, shape).astype(np.int32)
        down = torch.from_numpy(masks[w].copy()) if w >= 3 else None
        got = port(state, torch.from_numpy(counts), down)
        rs = _ref_state(state, lead)
        want = (healthy(rs, jnp.asarray(counts)) if down is None
                else faulted(rs, jnp.asarray(counts), jnp.asarray(masks[w])))
        assert got._fields == want._fields
        for field in got._fields:
            a, b = getattr(got, field).numpy(), np.asarray(getattr(want,
                                                                   field))
            assert a.shape == b.shape and (a == b).all(), (w, field)
        deferred = int(np.where(got.stall_hop.numpy() >= 0, counts, 0).sum())
        assert int(got.stalled_by_link.sum()) == deferred
        stalled += deferred
        offered = counts if form == "single" else counts.transpose(1, 0, 2)
        state = t.exchange(state._replace(link_down=down), torch.zeros(
            offered.shape + (4,), dtype=torch.int32),
            torch.from_numpy(offered.copy())).state
    assert stalled > 0


def test_stall_lane_blames_the_healthy_first_hop():
    """Under a dead first link a deferred row is blamed on its healthy
    route's first hop, not the detour's; without attribution the field
    is None on every path."""
    dims, n = (2, 4), 8
    t = t_tt.TorusTransport(n, dims, link_credits=4, notify_latency=2,
                            max_row_events=4, stall_attribution=True)
    seq0 = t._link_seq_alt[0]
    counts = np.zeros((n, n), np.int32)
    counts[0, 1] = counts[0, 2] = 4       # the second row is refused at hop 0
    down = torch.zeros(n * t.n_links, dtype=torch.bool)
    down[int(seq0[1, 0])] = True          # row (0, 1)'s healthy first link
    state = t.init_state(4, device="cpu")
    got = t._admit_global(state, torch.from_numpy(counts), down)
    lane = got.stalled_by_link
    assert int(lane.sum()) == int(np.where(got.stall_hop.numpy() >= 0,
                                           counts, 0).sum())
    for s, d in zip(*np.nonzero(got.stall_hop.numpy() >= 0)):
        assert int(lane[int(seq0[s * n + d, 0])]) > 0
    plain = t_tt.TorusTransport(n, dims, link_credits=4, notify_latency=2,
                                max_row_events=4)
    assert plain._admit_global(state, torch.from_numpy(counts),
                               down).stalled_by_link is None
    out = plain.exchange(state, torch.zeros((n, n, 4), dtype=torch.int32),
                         torch.from_numpy(counts))
    assert out.stats.stalled_by_link is None


# ---------------------------------------------------------------------------
# The recorded simulator.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sim_part():
    spec = mc.MicrocircuitSpec(scale=SIM_SCALE)
    return spec, network.build_partition(*spec.weight_matrix(),
                                         n_shards=SIM_SHARDS)


def _sim(ref, sim_part, name, recorder):
    spec, part = sim_part
    transport, kw, fault = SIMS[name]
    cfg = sim.SimConfig(n_shards=SIM_SHARDS, per_shard=part.per_shard,
                        max_fan=part.fanout.shape[1], transport=transport,
                        **{**SIM_CFG, **kw})
    sched = (t_faults.link_fault(SIM_DIMS, SIM_WINDOWS, 0, 0, start=2,
                                 device="cpu") if fault else None)
    _, run = sim.build_sharded_sim(cfg, part, spec.bg_rates(),
                                   fault_schedule=sched, recorder=recorder,
                                   device="cpu")
    state0 = convert.state_from_reference(ref, prefix=f"sim.{name}.init.",
                                          device="cpu")
    return run(state0, SIM_WINDOWS, drive=torch.from_numpy(ref["sim.drive"]))


@pytest.fixture(scope="module")
def sim_runs(ref, sim_part):
    return {name: (_sim(ref, sim_part, name, obs.RecorderConfig(DEPTH)),
                   _sim(ref, sim_part, name, None)) for name in SIMS}


def _check_stats(got: dict, ref: dict, prefix: str):
    keys = {k[len(prefix):] for k in ref if k.startswith(prefix)}
    assert keys == set(got), keys ^ set(got)
    for key in keys:
        want, have = ref[prefix + key], got[key]
        assert have.shape == want.shape, (key, have.shape, want.shape)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(have, want, rtol=1e-6, atol=1e-6,
                                       err_msg=key)
        else:
            assert (have == want).all(), key


@pytest.mark.parametrize("name", list(SIMS))
def test_recorded_sim_matches_reference(ref, sim_runs, name):
    """Every WindowStats field (the stall table included on the credited
    tori) and the ring's global and per-shard rows, bit for bit."""
    (state, stats, ring), _ = sim_runs[name]
    _check_stats(convert.flatten(stats), ref, f"sim.{name}.stats.")
    rows = obs.global_rows(ring, SIM_SHARDS)
    _same(rows, _json(ref, f"sim.{name}.rows"))
    for s in range(SIM_SHARDS):
        _same(obs.ring_rows(obs.ring_shard(ring, s)),
              _json(ref, f"sim.{name}.shard{s}"))
    assert [r["window"] for r in rows] == list(range(-1, SIM_WINDOWS - 1))
    totals = obs.counter_totals(rows)
    for f in obs.COUNTER_FIELDS:
        assert int(totals[f]) == int(getattr(stats.link, f).sum()), f
    deferred = stats.link.deferred_events.sum(0)
    for w, row in enumerate(rows):
        assert sum(row["stalled_by_link"]) == int(deferred[w]), w
    if name != "alltoall":
        assert int(deferred.sum()) > 0
    np.testing.assert_allclose(state.neuron.v.numpy(),
                               ref[f"sim.{name}.final.neuron.v"],
                               rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("name", list(SIMS))
def test_recorder_changes_no_sim_output(sim_runs, name):
    """Observer effect zero: the recorder-off run equals the recorded one
    on every field it has (the stall table is the recorded run's only
    extra) and on the final state."""
    (s1, st1, _), (s0, st0) = sim_runs[name]
    a, b = convert.flatten(st0), convert.flatten(st1)
    assert set(b) - set(a) <= {"link.stalled_by_link"}
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    fa, fb = convert.flatten(s0), convert.flatten(s1)
    for key in fa:
        assert np.array_equal(fa[key], fb[key]), key


# ---------------------------------------------------------------------------
# The instrumented spike engine.
# ---------------------------------------------------------------------------

def _engine(label, recorder=True, tracer=True):
    case = ENGINES[label]
    specs, cfg, src = engine_parts(t_lg, t_se, t_ten, case)
    sched = (t_faults.link_fault((2, 2, 2), 64, 0, 0, start=2, device="cpu")
             if case["fault"] else None)
    return t_se.SpikeEngine(
        case["n"], specs, cfg, src, fault_schedule=sched,
        recorder=obs.RecorderConfig(case["depth"]) if recorder else None,
        tracer=t_spans.Tracer() if tracer else None, device="cpu")


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    runs = {}
    for label, case in ENGINES.items():
        eng = _engine(label)
        rep = eng.run(case["segments"])
        run_dir = t_report.write_engine_run(
            str(tmp_path_factory.mktemp(label)), eng, rep)
        plain = _engine(label, recorder=False, tracer=False).run(
            case["segments"])
        runs[label] = (eng, rep, run_dir, plain)
    return runs


def _no_clock(report: dict) -> dict:
    report = dict(report, meta={k: v for k, v in report["meta"].items()
                                if k not in HOST_CLOCK})
    return json.loads(json.dumps(report))


@pytest.mark.parametrize("label", list(ENGINES))
def test_engine_recorder_rows_match_reference(ref, engine_runs, label):
    eng, rep, _, _ = engine_runs[label]
    n = ENGINES[label]["n"]
    rows = eng.recorder_rows()
    _same(rows, _json(ref, f"eng.{label}.rows"))
    for s in range(n):
        _same(eng.recorder_rows(s), _json(ref, f"eng.{label}.shard{s}"))
    totals = obs.counter_totals(rows)
    assert np.array_equal(totals["delivered_events"], rep.delivered)
    assert np.array_equal(rep.delivered, ref[f"eng.{label}.delivered"])
    for row in rows:       # the stall table sums to the window's deferrals
        assert sum(row["stalled_by_link"]) == sum(
            row["counters"]["deferred_events"])


@pytest.mark.parametrize("label", list(ENGINES))
def test_engine_run_directory_report_matches_reference(ref, engine_runs,
                                                       label):
    eng, rep, run_dir, _ = engine_runs[label]
    got = t_report.build_report(run_dir)
    want = json.loads(str(ref[f"eng.{label}.report"]))
    _same(_no_clock(got), _no_clock(want))
    assert {t["tenant"] for t in got["tenants"]} == {
        t[0] for t in ENGINES[label]["tenants"]}
    # equal apart from the throughput gauge (host clock); the latency
    # sums are mean x delivered, the means held at rtol 1e-6
    prom = open(os.path.join(run_dir, "metrics.prom")).read()
    parsed = t_metrics.parse_prometheus(prom)
    want_p = t_metrics.parse_prometheus(str(ref[f"eng.{label}.prom"]))
    assert set(parsed) == set(want_p)
    for metric, samples in want_p.items():
        if metric == "engine_events_per_s":
            continue
        assert set(parsed[metric]) == set(samples), metric
        for key, v in samples.items():
            if metric.endswith("_sum"):
                assert parsed[metric][key] == pytest.approx(v, rel=1e-6)
            else:
                assert parsed[metric][key] == v, (metric, key)
    name = ENGINES[label]["tenants"][0][0]
    assert parsed["tenant_delivered_events_total"][
        frozenset({("tenant", name)})] == float(rep.delivered[0])
    if ENGINES[label]["fault"]:
        assert got["faults"][0]["window"] == 2
        assert got["top_links"]
    text = t_report.render(got)
    assert "window timeline" in text and "tenants" in text


@pytest.mark.parametrize("label", list(ENGINES))
def test_engine_trace_matches_reference(ref, engine_runs, label):
    """The trace validates; its spans per name and track equal the
    reference's, but for the port's own: the reference's ``device/segment``
    on the ``device`` track is the port's ``device/stats_wait`` on the
    absorbing thread's track (the device thread's for a served segment,
    the caller's for a drain segment), and the port adds one
    ``window/exchange`` and one ``window/attribute`` a window on the
    thread that issues it; every window instant is among the ring's
    windows."""
    eng, rep, run_dir, _ = engine_runs[label]
    got = eng.tracer.to_dict()
    want = json.loads(str(ref[f"eng.{label}.trace"]))
    assert t_spans.validate_trace(got) == []
    count = lambda tr: collections.Counter(
        (ev["name"], t_spans.thread_names(tr)[ev["tid"]])
        for ev in tr["traceEvents"] if ev["ph"] != "M")
    want_n = count(want)
    nw = ENGINES[label]["cfg"]["seg_windows"]
    caller = threading.current_thread().name      # ran the fixture's stop
    assert want_n.pop(("device/segment", "device")) == (
        rep.windows + rep.drain_windows) // nw
    want_n[("device/stats_wait", "spike-device")] += rep.windows // nw
    want_n[("device/stats_wait", caller)] += rep.drain_windows // nw
    for stage in ("window/exchange", "window/attribute"):
        want_n[(stage, "spike-device")] += rep.windows
        want_n[(stage, caller)] += rep.drain_windows
    assert count(got) == want_n
    windows = [ev["args"]["window"] for ev in got["traceEvents"]
               if ev["name"] == "window"]
    assert set(windows) <= {r["window"] for r in eng.recorder_rows()}
    assert len(windows) == rep.windows + rep.drain_windows
    with open(os.path.join(run_dir, "trace.json")) as f:
        assert t_spans.validate_trace(json.load(f)) == []


@pytest.mark.parametrize("label", list(ENGINES))
def test_recorder_changes_no_engine_output(engine_runs, label):
    _, rep, _, plain = engine_runs[label]
    for f in ("injected", "delivered", "shed", "clipped"):
        assert np.array_equal(getattr(rep, f), getattr(plain, f)), f
    assert (rep.windows, rep.drain_windows) == (plain.windows,
                                                plain.drain_windows)
    for d1, d2 in zip(rep.tenants, plain.tenants):
        assert np.array_equal(d1.hist, d2.hist)
        assert (d1.max_us, d1.mean_us) == (d2.max_us, d2.mean_us)


def test_engine_without_recorder_keeps_its_carry(engine_runs):
    eng = _engine("one", recorder=False, tracer=False)
    assert len(eng._carry) == 4 and eng.tracer is t_spans.NULL
    assert eng.transport.stall_attribution is False
    with pytest.raises(RuntimeError, match="without a flight recorder"):
        eng.recorder_rows()
    assert len(engine_runs["one"][0]._carry) == 5
    # warmup leaves the ring as it was
    e = _engine("one")
    e.warmup()
    assert e._carry[4].cursor == 0 and int(e._carry[4].window.max()) == -1


# ---------------------------------------------------------------------------
# The engine's spans inside the served window, both sides of the staging
# queue, and the program's spans on the profiler's clock.
# ---------------------------------------------------------------------------

def _four_shards(tracer=None, cls=t_se.SpikeEngine):
    """The trace smoke's engine: 4 shards on a 2x2x1 torus, two tenants,
    3-window segments."""
    cfg = t_se.EngineConfig(capacity=8, link_credits=16, notify_latency=2,
                            window_us=100.0, seg_windows=3, nx=2, ny=2, nz=1)
    tenants = [t_ten.TenantSpec("a", reserve=8, rate_epw=16.0),
               t_ten.TenantSpec("b", reserve=4, rate_epw=8.0)]
    src = t_lg.PoissonLoadGen(11, [t_lg.TenantProfile("a", 16.0),
                                   t_lg.TenantProfile("b", 8.0)], 4,
                              cfg.capacity)
    return cls(4, tenants, cfg, src, tracer=tracer, device="cpu")


def test_engine_stage_spans_lie_inside_each_dispatch():
    """Each ``device/dispatch`` holds exactly one ``window/exchange`` and
    one ``window/attribute`` a window of its segment, and its ``cpu_us``
    lies in [0, dur]; the stats wait is ``device/stats_wait`` on the
    device thread's track; the OS thread ids and the wall-clock origin are
    exported beside ``traceEvents``."""
    tr = t_spans.Tracer()
    eng = _four_shards(tr)
    rep = eng.run(3)
    d = tr.to_dict()
    assert t_spans.validate_trace(d) == []
    names = t_spans.thread_names(d)
    spans = [dict(e, track=names[e["tid"]]) for e in d["traceEvents"]
             if e["ph"] == "X"]
    dispatch = [e for e in spans if e["name"] == "device/dispatch"]
    assert len(dispatch) == 3 and rep.windows == 9
    for seg in dispatch:
        assert 0.0 <= seg["args"]["cpu_us"] <= seg["dur"]
        a, b = seg["ts"], seg["ts"] + seg["dur"]
        for stage in ("window/exchange", "window/attribute"):
            inside = [e["args"]["window"] for e in spans
                      if e["name"] == stage and a <= e["ts"]
                      and e["ts"] + e["dur"] <= b]
            assert inside == [seg["args"]["win0"] + i for i in range(3)]
    assert {e["track"] for e in spans if e["name"].startswith("window/")
            } == {"spike-device", threading.current_thread().name}
    assert [e["track"] for e in spans if e["name"] == "device/stats_wait"
            ].count("spike-device") == 3
    assert not [e for e in spans if e["name"] == "device/segment"]
    other = d["otherData"]
    assert abs(other["epoch_origin_ns"] - time.time_ns()) < 600e9
    assert len(other["event_os_threads"]) == len(d["traceEvents"])
    me = threading.get_native_id()
    assert dict(other["pthread_ids"])[me] == threading.get_ident()
    device_os = {w for ev, w in zip(d["traceEvents"],
                                    other["event_os_threads"])
                 if ev["ph"] != "M" and names[ev["tid"]] == "spike-device"}
    assert me in device_os and len(device_os) == 2
    assert set(dict(other["pthread_ids"])) >= device_os
    for ev, writer in zip(d["traceEvents"], other["event_os_threads"]):
        if ev["ph"] == "M":
            assert writer is None
        elif ev["name"] == "device/dispatch":
            assert writer in device_os and writer != me


def test_disabled_tracer_reads_no_thread_clock(monkeypatch):
    def no_clock():
        raise AssertionError("thread_time_ns read by a disabled tracer")
    monkeypatch.setattr(time, "thread_time_ns", no_clock)
    with t_spans.NULL.span("device/dispatch", cpu_time=True) as sp:
        pass
    assert "cpu_us" not in sp.args and sp.dur_us >= 0


def test_slot_wait_spans_a_whole_wait():
    """Behind a device loop slowed to 0.2 s a segment, ingest waits for a
    free slot across several 50 ms polls: one ``ingest/slot_wait`` of the
    whole wait per filled slot."""
    class Slow(t_se.SpikeEngine):
        def _segment(self, *args):
            time.sleep(0.2)
            return super()._segment(*args)
    tr = t_spans.Tracer()
    _four_shards(tr, Slow).run(4)
    d = tr.to_dict()
    waits = [e["dur"] for e in d["traceEvents"]
             if e["name"] == "ingest/slot_wait"]
    assert len(waits) == 4
    assert max(waits) >= 150e3


def test_tracer_changes_no_engine_output():
    runs = [_four_shards(tracer) for tracer in (t_spans.Tracer(), None)]
    reps = [eng.run(3) for eng in runs]
    for f in ("injected", "delivered", "shed", "clipped", "windows",
              "drain_windows"):
        assert np.array_equal(getattr(reps[0], f), getattr(reps[1], f)), f
    for d1, d2 in zip(reps[0].tenants, reps[1].tenants):
        assert np.array_equal(d1.hist, d2.hist)
        assert (d1.max_us, d1.mean_us, d1.p50_us, d1.p99_us) == (
            d2.max_us, d2.mean_us, d2.p50_us, d2.p99_us)
    a, b = (eng.window_stats for eng in runs)
    assert len(a) == len(b) == 3 + reps[0].drain_windows // 3
    for x, y in zip(a, b):
        fx, fy = convert.flatten(x), convert.flatten(y)
        assert fx.keys() == fy.keys()
        for key in fx:
            assert np.array_equal(fx[key], fy[key]), key


def test_spans_on_the_profilers_clock(tmp_path):
    """A span around ATen calls on this thread, under ``torch.profiler``
    (CPU), contains those calls once shifted by the two anchors alone."""
    from torch.profiler import ProfilerActivity, profile
    tr = t_spans.Tracer()
    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.005)
        with tr.span("work"):
            for _ in range(4):
                x = torch.tanh(x @ x)
        time.sleep(0.005)
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    theirs = json.loads((tmp_path / "prof.json").read_text())
    merged = t_spans.on_profiler_clock(tr.to_dict(), theirs)
    assert merged["baseTimeNanoseconds"] == theirs["baseTimeNanoseconds"]
    me = threading.get_native_id()
    ops = [e for e in merged["traceEvents"] if e.get("cat") == "cpu_op"
           and e["name"] in ("aten::mm", "aten::tanh")]
    assert len(ops) == 8 and {e["tid"] for e in ops} == {me}
    work, = [e for e in merged["traceEvents"] if e["name"] == "work"]
    low = threading.get_ident() & 0xFFFFFFFF
    assert work["args"]["os_tid"] == me and work["args"]["pthread_tid"] == (
        abs(low - (1 << 32) if low >> 31 else low))
    assert work["pid"] not in {e.get("pid") for e in theirs["traceEvents"]}
    for e in ops:
        assert work["ts"] <= e["ts"] and (e["ts"] + e["dur"]
                                          <= work["ts"] + work["dur"])
    # 5 ms of sleep on either side: a shift off by that much would show
    assert ops[0]["ts"] - work["ts"] < 5e3


# ---------------------------------------------------------------------------
# The report's command line, the Mamba-2 engine's spans, the disabled path.
# ---------------------------------------------------------------------------

def test_report_cli_renders_sim_and_engine_run_dirs(ref, engine_runs,
                                                    sim_runs, tmp_path,
                                                    capsys):
    (state, stats, ring), _ = sim_runs["torus3d-fault"]
    sim_dir = t_report.write_run_dir(
        str(tmp_path / "sim"), meta={"kind": "sim", "dims": list(SIM_DIMS),
                                     "n_shards": SIM_SHARDS},
        recorder_rows=obs.global_rows(ring, SIM_SHARDS),
        fault_events=t_faults.transitions(t_faults.link_fault(
            SIM_DIMS, SIM_WINDOWS, 0, 0, start=2, device="cpu")))
    for run_dir in (sim_dir, engine_runs["eight"][2]):
        t_report.main([run_dir])
        text = capsys.readouterr().out
        assert "window timeline" in text and "link_down" in text
        t_report.main([run_dir, "--json"])
        built = json.loads(capsys.readouterr().out)
        assert built["faults"][0]["window"] == 2
        assert built["top_links"], run_dir
    with pytest.raises(FileNotFoundError, match="meta.json"):
        t_report.build_report(str(tmp_path))
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                          sim_dir], check=True, capture_output=True,
                         text=True, env=env)
    assert "top congested links" in out.stdout


def test_mamba_engine_spans_on_the_reduced_model():
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    lm = build(reduced(get_config("mamba2-2.7b")))
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    reqs = [Request(rid=0, prompt=np.array([5, 6, 7], np.int32)),
            Request(rid=1, prompt=np.array([9, 10], np.int32)),
            Request(rid=2, prompt=np.array([3, 4, 8, 11], np.int32))]
    scfg = ServeConfig(slots=2, max_len=64, max_new_tokens=4)
    tr = t_spans.Tracer()
    traced = Engine(lm, scfg, tracer=tr)
    got = traced.generate_batch(params, reqs)
    want = Engine(lm, scfg).generate_batch(params, reqs)
    assert set(got) == set(want)
    for rid in want:
        assert np.array_equal(got[rid], want[rid])
    d = tr.to_dict()
    assert t_spans.validate_trace(d) == []
    spans = [e for e in d["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["serve/prefill", "serve/decode"] * 2
    assert set(t_spans.thread_names(d).values()) == {"serve"}
    assert [e["args"] for e in spans[::2]] == [
        {"batch": 2, "prompt_len": 3}, {"batch": 1, "prompt_len": 4}]
    assert all(e["args"]["tokens"] == len(want[0]) for e in spans[1:2])
    for wave, (pre, dec) in zip(traced.waves, zip(spans[::2], spans[1::2])):
        assert wave.prefill_s == pytest.approx(pre["dur"] * 1e-6)
        assert wave.decode_s == pytest.approx(dec["dur"] * 1e-6)


def test_disabled_path_carry_structure(sim_part):
    """Without a recorder the carry is the pre-observability one: a
    SimCarry's ring is None, ``body`` takes and returns three elements
    and the credited torus attributes no stalls."""
    assert sim.SimCarry(1, 2, 3) == sim.SimCarry(1, 2, 3, None)
    spec, part = sim_part
    cfg = sim.SimConfig(n_shards=SIM_SHARDS, per_shard=part.per_shard,
                        max_fan=part.fanout.shape[1], transport="torus3d",
                        torus_nx=2, torus_ny=2, torus_nz=2, **SIM_CFG)
    init, run_segment, _ = sim.build_sharded_segments(
        cfg, part, spec.bg_rates(), device="cpu")
    carry = init(0)
    assert carry.ring is None
    carry, stats = run_segment(carry, 2)
    assert carry.ring is None and stats.link.stalled_by_link is None
    init_r, run_r, _ = sim.build_sharded_segments(
        cfg, part, spec.bg_rates(), recorder=obs.RecorderConfig(4),
        device="cpu")
    carry = init_r(0)
    ring0 = carry.ring
    carry, stats = run_r(carry, 2)
    assert carry.ring.cursor == 2 and ring0.cursor == 0
    assert int(ring0.window.max()) == -1        # the caller's ring is kept
    assert tuple(stats.link.stalled_by_link.shape) == (
        SIM_SHARDS, 2, SIM_SHARDS * 6)


def test_obs_modules_import_no_jax():
    code = ("import sys, repro_torch.obs, repro_torch.obs.report, "
            "repro_torch.obs.log, repro_torch.serve.engine; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "assert not bad, bad; "
            "import repro_torch.obs as o; import repro.obs as r; "
            "assert o.__all__ == r.__all__")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=SRC))
