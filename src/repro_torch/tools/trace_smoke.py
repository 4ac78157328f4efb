"""Trace smoke of the port (counterpart of ``tools/trace_smoke.py``): serve
two instrumented segments, validate every artifact.

Runs the streaming spike serving engine (4 shards, a leading tensor
dimension) for 2 segments with the full observability stack on --
flight-recorder ring in the device carry, span tracing on the host
threads, Prometheus metrics -- writes the run directory, then checks:

* ``trace.json`` parses as Chrome Trace Event JSON, per-track timestamps
  are monotonic, and every engine thread (``spike-ingest``,
  ``spike-device``, ``device``) contributed at least one span;
* host spans correlate to device windows: every ``window`` instant's
  absolute window index also appears in the flight-recorder rows;
* ``metrics.prom`` parses as Prometheus text exposition;
* ``python -m repro_torch.obs.report`` builds a structured report from
  the directory (timeline rows + tenant SLO blocks present).

Exits non-zero with the reasons on any failure.  ``--artifact PATH``
copies the validated trace to PATH, and only there.

Usage: PYTHONPATH=src python -m repro_torch.tools.trace_smoke
           [--out-dir DIR] [--artifact PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from repro_torch import examples
from repro_torch.kernels import dispatch
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs import report as obs_report
from repro_torch.obs import spans as obs_spans
from repro_torch.serve.loadgen import PoissonLoadGen, TenantProfile
from repro_torch.serve.spike_engine import EngineConfig, SpikeEngine
from repro_torch.serve.tenancy import TenantSpec

SEGMENTS = 2
N_SHARDS = 4
THREADS = ("spike-ingest", "spike-device", "device")


def engine(device) -> SpikeEngine:
    """The smoke's engine on ``device``: 4 shards on a 2x2x1 torus, two
    tenants, load-generator seed 11, the recorder (depth 32) and a
    tracer."""
    cfg = EngineConfig(capacity=8, link_credits=16, notify_latency=2,
                       window_us=100.0, seg_windows=3, nx=2, ny=2, nz=1)
    tenants = [TenantSpec("a", reserve=8, rate_epw=16.0),
               TenantSpec("b", reserve=4, rate_epw=8.0)]
    src = PoissonLoadGen(11, [TenantProfile("a", 16.0),
                              TenantProfile("b", 8.0)], N_SHARDS,
                         cfg.capacity)
    return SpikeEngine(N_SHARDS, tenants, cfg, src,
                       recorder=obs_recorder.RecorderConfig(depth=32),
                       tracer=obs_spans.Tracer(), device=device)


def serve(out_dir: str, device) -> str:
    """Serve ``SEGMENTS`` instrumented segments and write the run
    directory under ``out_dir``; returns its path."""
    eng = engine(device)
    eng.warmup()
    rep = eng.run(SEGMENTS)
    run_dir = obs_report.write_engine_run(out_dir, eng, rep)
    print(f"run dir: {run_dir} ({rep.windows} windows, "
          f"{int(rep.delivered.sum())} delivered)")
    return run_dir


def validate(run_dir: str) -> tuple[list[str], str]:
    """(failures, summary) of a run directory's artifacts."""
    failures: list[str] = []

    # -- trace.json: parses, monotonic, every engine thread present --------
    trace_path = os.path.join(run_dir, "trace.json")
    try:
        with open(trace_path) as f:
            trace = json.load(f)
    except (OSError, ValueError) as e:
        return [f"trace.json unreadable: {e}"], ""
    failures += [f"trace.json: {p}" for p in obs_spans.validate_trace(trace)]
    names = obs_spans.thread_names(trace)
    spans_per_track: dict[str, int] = {}
    windows_in_trace: set[int] = set()
    for ev in trace["traceEvents"]:
        if ev.get("ph") in ("X", "i"):
            track = names.get(ev.get("tid", 0), "?")
            spans_per_track[track] = spans_per_track.get(track, 0) + 1
            if ev.get("name") == "window":
                windows_in_trace.add(int(ev["args"]["window"]))
    for track in THREADS:
        if spans_per_track.get(track, 0) < 1:
            failures.append(f"trace.json: no spans on thread {track!r} "
                            f"(have {spans_per_track})")

    # -- correlation: trace window indices exist in the recorder rows ------
    rec_windows = {int(r["window"]) for r in obs_report._read_jsonl(
        os.path.join(run_dir, "recorder.jsonl"))}
    orphans = windows_in_trace - rec_windows
    if not windows_in_trace:
        failures.append("trace.json: no per-window device instants")
    if orphans:
        failures.append(f"correlation: trace windows {sorted(orphans)} "
                        f"missing from recorder.jsonl {sorted(rec_windows)}")

    # -- metrics.prom: valid Prometheus exposition -------------------------
    metrics: dict = {}
    try:
        with open(os.path.join(run_dir, "metrics.prom")) as f:
            metrics = obs_metrics.parse_prometheus(f.read())
        if not metrics:
            failures.append("metrics.prom: empty exposition")
    except (OSError, ValueError) as e:
        failures.append(f"metrics.prom: {e}")

    # -- report: structured output builds ----------------------------------
    try:
        report = obs_report.build_report(run_dir)
        if not report["timeline"]:
            failures.append("report: empty window timeline")
        if not all("slo" in t for t in report["tenants"]):
            failures.append("report: tenant rows missing SLO block")
    except Exception as e:  # noqa: BLE001 - smoke gate, report any failure
        failures.append(f"report: build_report raised {e!r}")

    summary = (f"{sum(spans_per_track.values())} events on "
               f"{len(spans_per_track)} tracks, {len(rec_windows)} recorded "
               f"windows, {len(metrics)} metric families")
    return failures, summary


def main(argv=None) -> int:
    """Serve, write, validate; exits non-zero (``SystemExit`` with the
    reasons) on any failure, else returns 0."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_trace_smoke"))
    ap.add_argument("--artifact", default=None,
                    help="copy the validated trace.json here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = dispatch.resolve_device(args.device)

    run_dir = serve(args.out_dir, device)
    failures, summary = validate(run_dir)
    if failures:
        sys.exit("trace-smoke FAIL:\n  " + "\n  ".join(failures))
    if args.artifact:
        shutil.copyfile(os.path.join(run_dir, "trace.json"), args.artifact)
        print(f"artifact: {args.artifact}")
    print(f"trace-smoke OK on {examples.device_label(device)}: {summary}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
