"""A network kind added by files alone.

``gpubench/kinds/mc_probe.py`` hands the dense parts to
``microcircuit.run_network`` with a program that records one span a
segment through the run's tracer; a configuration of that kind (the small
microcircuit), a cell on the small torus mix and a metric that reads the
span join a copied manifest as entries, and nothing of the harness is
edited.  The probe cell runs and is checked as ``tiny_torus`` is, its
span reaches its reader, and the run loads nothing of JAX.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time

import pytest

from gpubench.conftest import TINY_CONFIGS, make_tiny_root
from gpubench.harness import manifest

PROBE_KIND = '''
"""The dense microcircuit, its program recording one ``probe/segment``
span a segment on the track ``probe``."""
from gpubench.kinds import microcircuit as mc

DRIVES = "simulator"


def program(cell, inputs, device, tracer):
    prog = mc.Program(cell, inputs, device)
    run_segment = prog.run_segment

    def traced(carry, n, drive=None):
        with tracer.span("probe/segment", track="probe"):
            return run_segment(carry, n, drive=drive)
    prog.run_segment = traced
    return prog


PARTS = mc.DENSE._replace(program=program)


def run(cell, **kw):
    return mc.run_network(PARTS, cell, **kw)
'''

PROBE_METRIC = '''
"""Host milliseconds of a profiled segment of the probe's program."""


def read(ctx):
    secs, n = ctx.span_total_s("probe/segment", track="probe")
    return secs * 1e3 / n if n else None
'''

METRIC = "probe.segment_ms"
SEED = 2**33 + 5

RUN = """
import json, sys, time
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
from pathlib import Path
from gpubench.harness import guard, runner
from gpubench.test_gpubench_harness import check_manifest
check_manifest(Path(root))
out = {}
for trace in (0, 1):
    for cell in ("tiny_probe", "tiny_torus"):
        out[f"{cell}.{trace}"] = runner.run_cell(
            Path(root), cell, seed=int(sys.argv[2]), seconds=0.5,
            trace=bool(trace), device="cpu", t_start=time.perf_counter())
out["forbidden"] = guard.forbidden_modules()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def probe_root(tmp_path_factory):
    pd_tiny = TINY_CONFIGS["pd-tiny"]
    root = make_tiny_root(
        tmp_path_factory.mktemp("probe"),
        configs={"pd-probe": {"base": pd_tiny["base"], "set": {
            **pd_tiny["set"], "kind": "mc_probe"}}},
        cells={"tiny_probe": ("pd-probe", "tiny_torus")})
    bench = root / "gpubench"
    (bench / "kinds" / "mc_probe.py").write_text(PROBE_KIND)
    (bench / "metrics" / f"{METRIC}.py").write_text(PROBE_METRIC)
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["per_layer"].append({
        "name": METRIC, "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "probe", "moves": "window_ms",
        "workloads": ["tiny_probe"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return root


def test_kind_added_by_a_file_alone_runs_and_reads_its_span(probe_root,
                                                            tiny_root):
    """In a process of the copied checkout: the manifest check passes;
    the probe cell is correct and compares as ``tiny_torus`` on the same
    seed; traced, its span metric reads and ``tiny_torus`` reads what it
    read before; nothing of JAX is loaded."""
    proc = subprocess.run(
        [sys.executable, "-c", RUN, str(probe_root), str(SEED)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out.pop("forbidden") == []
    for name, line in out.items():
        assert line["correct"], (name, line["compared"])
        assert line["failed"] == 0
    for trace in (0, 1):
        assert (out[f"tiny_probe.{trace}"]["compared"]
                == out[f"tiny_torus.{trace}"]["compared"])
    probe, torus = out["tiny_probe.1"]["metrics"], out["tiny_torus.1"][
        "metrics"]
    assert probe[METRIC]["value"] > 0.0 and probe[METRIC]["unit"] == "ms"
    assert set(probe) - {METRIC} == set(torus)
    assert set(out["tiny_probe.0"]["metrics"]) == set(
        out["tiny_torus.0"]["metrics"]) == {"window_ms", "setup_s"}
    names = lambda root: [m["name"] for m in manifest.load(
        root, "tiny_torus").per_layer]
    assert names(probe_root) == names(tiny_root)


def test_readers_get_the_spans_of_the_profiled_segments(probe_root):
    """``run_network`` hands the readers the program's spans that lie in
    the profiled segments, one a segment here, each with its track."""
    from gpubench.kinds import microcircuit as mc
    path = probe_root / "gpubench" / "kinds" / "mc_probe.py"
    spec = importlib.util.spec_from_file_location("mc_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    cell = manifest.load(probe_root, "tiny_probe")
    out = mc.run_network(probe.PARTS, cell, seed=SEED, seconds=0.3,
                         trace=True, device="cpu",
                         t_start=time.perf_counter())
    spans = out["ctx"].spans
    assert [(e["name"], e["track"]) for e in spans] == [
        ("probe/segment", "probe")] * cell.traffic["trace_segments"]
    plain = mc.run(manifest.load(probe_root, "tiny_torus"), seed=SEED,
                   seconds=0.3, trace=True, device="cpu",
                   t_start=time.perf_counter())
    assert plain["ctx"].spans == []
