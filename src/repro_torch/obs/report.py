"""Observability report: one window timeline from a run directory (port
of ``src/repro/obs/report.py``).

A run directory is the on-disk form of one instrumented run, written by
:func:`write_run_dir` (or :func:`write_engine_run` for a served
``SpikeEngine``) and rendered by ``python -m repro_torch.obs.report
<run-dir>``:

* ``recorder.jsonl`` -- one ``obs.recorder`` row per recorded window
  (global view: counter and histogram lanes summed over the shards);
* ``events.jsonl`` -- ``fabric.faults.transitions`` events (``{"window",
  "event": "link_down" | "link_up", "links": [...]}``);
* ``tenants.jsonl`` -- ``serve.tenancy.tenant_rows`` rows (QoS contract,
  conservation ledger, latency digest); absent for single-tenant runs;
* ``meta.json`` -- the run's shape: ``dims``, ``n_shards``, counts,
  ``window_us``, throughput;
* ``metrics.prom`` / ``metrics.jsonl`` / ``trace.json`` -- optional
  Prometheus exposition, metrics snapshot and Perfetto trace.

:func:`build_report` merges the first four onto one window timeline
(which links were congested when, which windows a cable died or healed,
each tenant's p99 meanwhile) and returns it as a plain dict; :func:`render`
prints it; :func:`main` is the command line.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Sequence

import numpy as np

from repro_torch.fabric import faults as fabric_faults
from repro_torch.wire import latency as wire_latency

#: timeline counters taken from each recorder row
_TIMELINE_FIELDS = ("offered_events", "sent_events", "deferred_events",
                    "delivered_events", "parked_events", "unparked_events",
                    "rerouted")


# -- writing ----------------------------------------------------------------

def _write_jsonl(path: str, rows: Sequence[dict]) -> None:
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def write_run_dir(run_dir: str, *, meta: dict,
                  recorder_rows: Sequence[dict] | None = None,
                  fault_events: Sequence[dict] | None = None,
                  tenant_rows: Sequence[dict] | None = None,
                  registry=None, tracer=None) -> str:
    """Write one run's artifacts into ``run_dir`` and return it.

    ``meta`` is required; everything else is optional and left out when
    None.  ``registry`` (an ``obs.metrics.Registry``) lands as both
    ``metrics.prom`` and ``metrics.jsonl``; an enabled ``tracer`` as
    ``trace.json``.
    """
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    if recorder_rows is not None:
        _write_jsonl(os.path.join(run_dir, "recorder.jsonl"), recorder_rows)
    if fault_events is not None:
        _write_jsonl(os.path.join(run_dir, "events.jsonl"), fault_events)
    if tenant_rows is not None:
        _write_jsonl(os.path.join(run_dir, "tenants.jsonl"), tenant_rows)
    if registry is not None:
        from repro_torch.obs import metrics as obs_metrics
        with open(os.path.join(run_dir, "metrics.prom"), "w") as f:
            f.write(obs_metrics.prometheus_text(registry))
        obs_metrics.write_jsonl(
            os.path.join(run_dir, "metrics.jsonl"), registry)
    if tracer is not None and getattr(tracer, "enabled", False):
        tracer.write(os.path.join(run_dir, "trace.json"))
    return run_dir


def write_engine_run(run_dir: str, engine, report) -> str:
    """A run directory from a served ``SpikeEngine`` and its
    ``EngineReport`` (after ``stop()``): recorder rows, fault transitions,
    tenant rows, ledger metrics and the trace, whichever the engine has."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serve import tenancy
    cfg = engine.cfg
    meta = {
        "kind": "serve",
        "dims": [int(d) for d in engine.transport.dims],
        "n_shards": engine.n_shards,
        "n_tenants": engine.n_tenants,
        "window_us": float(cfg.window_us),
        "seg_windows": int(cfg.seg_windows),
        "link_credits": int(cfg.link_credits),
        "notify_latency": int(cfg.notify_latency),
        "windows": int(report.windows),
        "drain_windows": int(report.drain_windows),
        "wall_s": float(report.wall_s),
        "events_per_s": float(report.events_per_s),
    }
    reg = obs_metrics.Registry()
    engine.ledger.export_metrics(reg)
    reg.gauge("engine_events_per_s",
              "Delivered throughput of the run.").set(report.events_per_s)
    reg.gauge("engine_windows_served",
              "Flush windows served (excl. drain).").set(report.windows)
    return write_run_dir(
        run_dir, meta=meta,
        recorder_rows=(engine.recorder_rows()
                       if engine.recorder is not None else None),
        fault_events=(fabric_faults.transitions(engine.fault_schedule)
                      if engine.fault_schedule is not None else None),
        tenant_rows=tenancy.tenant_rows(
            engine.tenants, engine.ledger, cfg.notify_latency),
        registry=reg, tracer=engine.tracer)


# -- reading ----------------------------------------------------------------

def _read_jsonl(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _counter(row: dict, field: str) -> int:
    """One recorder-row counter as a global int (sums the tenant axis)."""
    return int(np.asarray(row["counters"][field], np.int64).sum())


def _label(dims, lid: int) -> str:
    if dims and lid < int(np.prod(dims)) * 2 * len(dims):
        return fabric_faults.link_label(dims, lid)
    return f"link{lid}"


def _p99s(row: dict, names: Sequence[str]) -> dict[str, float]:
    """Per-tenant (or overall) p99 of one recorder row's histogram."""
    hist = np.asarray(row["hist"], np.int64)
    if hist.ndim == 1:
        return {"all": wire_latency.percentile_from_hist(hist, 0.99)}
    return {(names[t] if t < len(names) else f"t{t}"):
            wire_latency.percentile_from_hist(hist[t], 0.99)
            for t in range(hist.shape[0])}


def build_report(run_dir: str) -> dict:
    """Merge a run directory into one report dict: ``meta``, ``timeline``
    (one entry per recorded window: counters, the three most stalled
    links, fault events, per-tenant p99), ``top_links`` (ranked by total
    stalled demand), ``faults``, ``tenants`` (rows and SLO burn) and
    ``totals``."""
    meta_path = os.path.join(run_dir, "meta.json")
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"{run_dir!r} is not a run directory "
                                f"(missing meta.json)")
    with open(meta_path) as f:
        meta = json.load(f)
    dims = tuple(meta.get("dims") or ())
    rows = _read_jsonl(os.path.join(run_dir, "recorder.jsonl"))
    faults = _read_jsonl(os.path.join(run_dir, "events.jsonl"))
    tenants = _read_jsonl(os.path.join(run_dir, "tenants.jsonl"))
    names = [t["tenant"] for t in tenants]
    by_window: dict[int, list[dict]] = {}
    for ev in faults:
        by_window.setdefault(int(ev["window"]), []).append(ev)

    timeline, link_stall, link_windows = [], {}, {}
    for row in rows:
        w = int(row["window"])
        sbl = np.asarray(row["stalled_by_link"], np.int64)
        hot = np.flatnonzero(sbl)
        for lid in hot:
            link_stall[int(lid)] = link_stall.get(int(lid), 0) + int(sbl[lid])
            link_windows[int(lid)] = link_windows.get(int(lid), 0) + 1
        entry = {"window": w}
        entry.update({f: _counter(row, f) for f in _TIMELINE_FIELDS})
        entry["stalled_links"] = [
            {"link": int(l), "label": _label(dims, int(l)),
             "stalled": int(sbl[l])}
            for l in hot[np.argsort(-sbl[hot])][:3]]
        entry["events"] = [
            {"event": ev["event"], "links": ev["links"],
             "labels": [_label(dims, l) for l in ev["links"]]}
            for ev in by_window.get(w, [])]
        entry["p99_us"] = _p99s(row, names)
        timeline.append(entry)

    top_links = [
        {"link": lid, "label": _label(dims, lid),
         "stalled_events": link_stall[lid],
         "windows_congested": link_windows[lid]}
        for lid in sorted(link_stall, key=lambda l: -link_stall[l])[:10]]

    for t in tenants:
        g = float(t.get("guaranteed_epw", 0.0))
        offered = float(t.get("rate_epw", 0.0))
        t["slo"] = {
            "guaranteed_epw": g,
            "offered_epw": offered,
            # above 1 the tenant offers more than its guaranteed
            # admission: latency beyond the guarantee is its own burst,
            # not a failure of isolation
            "overcommit": (offered / g) if g > 0 else float("inf"),
            "delivered_ratio": (t["delivered"] / t["injected"]
                                if t.get("injected") else 1.0),
        }

    totals = {f: int(sum(e[f] for e in timeline)) for f in _TIMELINE_FIELDS}
    return {"meta": meta, "timeline": timeline, "top_links": top_links,
            "faults": faults, "tenants": tenants, "totals": totals}


# -- rendering --------------------------------------------------------------

def render(report: dict) -> str:
    """Human-readable rendering of :func:`build_report`'s dict."""
    meta = report["meta"]
    out = [f"== run: kind={meta.get('kind', '?')} dims={meta.get('dims')} "
           f"shards={meta.get('n_shards')} "
           f"windows={meta.get('windows', len(report['timeline']))}"]
    if meta.get("events_per_s"):
        out.append(f"   throughput: {meta['events_per_s']:,.0f} events/s "
                   f"(wall {meta.get('wall_s', 0):.2f}s)")
    if report["top_links"]:
        out.append("-- top congested links (stalled demand) --")
        for l in report["top_links"]:
            out.append(f"   {l['label']:>10}  {l['stalled_events']:>8} "
                       f"events over {l['windows_congested']} windows")
    if report["tenants"]:
        out.append("-- tenants --")
        for t in report["tenants"]:
            slo = t["slo"]
            out.append(
                f"   {t['tenant']:>8}  delivered {t['delivered']:>8}  "
                f"shed {t['shed']:>6}  p50 {t['p50_us']:>8.1f}us  "
                f"p99 {t['p99_us']:>8.1f}us  "
                f"offered/guaranteed {slo['overcommit']:.2f}x")
    out.append("-- window timeline --")
    for e in report["timeline"]:
        marks = "".join(
            f"  [{ev['event']} {','.join(ev['labels'])}]"
            for ev in e["events"])
        stall = (" stall@" + ",".join(
            f"{s['label']}:{s['stalled']}" for s in e["stalled_links"])
            if e["stalled_links"] else "")
        p99 = " ".join(f"p99[{k}]={v:.0f}us"
                       for k, v in e["p99_us"].items())
        out.append(f"   w{e['window']:>4}  off {e['offered_events']:>6} "
                   f"dlv {e['delivered_events']:>6} "
                   f"def {e['deferred_events']:>5} "
                   f"rer {e['rerouted']:>4}  {p99}{stall}{marks}")
    t = report["totals"]
    out.append(f"-- totals: offered {t['offered_events']} delivered "
               f"{t['delivered_events']} deferred {t['deferred_events']} "
               f"rerouted {t['rerouted']}")
    return "\n".join(out)


def main(argv: Sequence[str] | None = None) -> None:
    from repro_torch.obs import log as obs_log
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render one run directory's window timeline.")
    ap.add_argument("run_dir", help="directory written by write_run_dir")
    ap.add_argument("--json", action="store_true",
                    help="emit the structured report as JSON")
    obs_log.add_log_args(ap)
    args = ap.parse_args(argv)
    obs_log.setup_logging_from_args(args)
    report = build_report(args.run_dir)
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        print(render(report))


if __name__ == "__main__":
    main()
