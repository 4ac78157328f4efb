"""The harness: the manifest and the files it names, the import guard, a
cell added by files and entries alone, the refusal to run without a card,
and the reduction of a profiler trace."""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench.harness import guard, manifest, readers, trace

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_manifest(root: Path) -> None:
    """``root/BENCHMARK.json`` keeps to the contract and names only files
    that exist: each configuration's kind is ``gpubench/kinds/<kind>.py``
    with a ``run``, each per-layer metric has its reader."""
    man = json.loads((root / "BENCHMARK.json").read_text())
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (root / c["file"]).is_file()
        kind = json.loads((root / c["file"]).read_text())["kind"]
        assert (root / "gpubench" / "kinds" / f"{kind}.py").is_file(), kind
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25
                                    for m in e2e.values())
    for w in man["workloads"]:
        cell = manifest.load(root, w["name"])
        assert callable(manifest.kind_module(cell).run), cell.kind
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        assert callable(manifest.metric_reader(root, m["name"]))
        assert all(w in e2e[m["moves"]].get("workloads", [w])
                   for w in m["workloads"])
    for path in (root / "gpubench" / "rooflines").glob("*.py"):
        counter = manifest.roofline(path.stem, root)
        assert callable(counter.count) and re.compile(counter.PATTERN)


def test_manifest_names_only_files_that_exist():
    check_manifest(ROOT)


def test_guard_compares_top_level_names_whole():
    mods = ["repro_torch", "repro_torch.snn", "reproduce", "jaxtyping",
            "torch", "benchmarks_x"]
    assert guard.forbidden_modules(mods) == []
    assert guard.forbidden_modules(mods + ["repro.core", "jax",
                                           "benchmarks.run"]) == [
        "benchmarks.run", "jax", "repro.core"]


ADDED_CELL = """
import json, sys, time
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
from pathlib import Path
from gpubench.harness import guard, runner
out = {}
for cell in sys.argv[2:]:
    out[cell] = runner.run_cell(Path(root), cell, seed=2**33 + 1,
                                seconds=0.5, trace=False, device="cpu",
                                t_start=time.perf_counter())
out["forbidden"] = guard.forbidden_modules()
print(json.dumps(out))
"""


def test_cell_added_by_files_alone_runs_and_loads_no_jax(tiny_root):
    """The small cells exist only as new config and traffic files and new
    entries of a copied manifest; each cell's whole path, set-up to check,
    loads nothing of JAX, the JAX package or its benchmarks."""
    proc = subprocess.run(
        [sys.executable, "-c", ADDED_CELL, str(tiny_root), "tiny_torus",
         "tiny_solo"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out.pop("forbidden") == []
    for cell, line in out.items():
        assert line["correct"], (cell, line["compared"])
        assert line["attempted"] > 0 and line["failed"] == 0
        assert set(line["metrics"]) >= {"setup_s"}
        assert list(line)[-1] == "compared"


def test_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "mc8_torus3d_c124",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_trace_reduction():
    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name,
                                     "ts": ts, "dur": dur}
    events = [ev("kernel", "void lif_window_kernel<8>(float*)", 0, 10),
              ev("gpu_memcpy", "Memcpy HtoD", 5, 10),
              ev("kernel", "admission_kernel(int*)", 40, 20),
              ev("kernel", "admission_tenants_kernel(int*)", 70, 5),
              ev("cpu_op", "aten::where", 20, 15),
              ev("cuda_runtime", "cudaLaunchKernel", 30, 5)]
    t = trace.DeviceTrace(events, 100e-6, 2)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.kernel(manifest.roofline("admission").PATTERN) == (
        pytest.approx(20e-6), 1)
    b = t.breakdown()
    assert b["idle_gaps"] == [["aten::where", pytest.approx(25e-6)],
                              ["no host operation", pytest.approx(10e-6)]]
    assert b["device_ops"][0] == ["admission_kernel(int*)",
                                  pytest.approx(20e-6)]
    ctx = readers.Context(t, dict(n_shards=4, per_shard=250, window=8))
    assert abs(ctx.idle_pct() - 60.0) < 1e-9
    assert ctx.fns_per_window() == 2.0
    assert abs(ctx.roofline_pct("lif_window")
               - 100 * 200000 / 3.35e12 / 10e-6) < 1e-9


NEW_KERNEL = """
\"\"\"A kernel no cell had: 4 B read and 4 B written an element.\"\"\"
PATTERN = r"\\bscale_kernel\\b"


def count(s):
    return 8 * s["elements"], s["elements"]
"""


def test_kernel_added_by_a_file_alone_is_named_and_counted(tmp_path):
    """A new kernel's roofline needs only its counter file, which names
    its device function and counts a launch from the cell's sizes (and a
    reader file that asks for it): nothing of the harness is edited."""
    rooflines = tmp_path / "gpubench" / "rooflines"
    rooflines.mkdir(parents=True)
    (rooflines / "scale.py").write_text(NEW_KERNEL)
    ev = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name,
                                "ts": ts, "dur": dur}
    t = trace.DeviceTrace([ev("void scale_kernel<float>(float*)", 0, 4),
                           ev("void scale_kernel<float>(float*)", 10, 6),
                           ev("upscale_kernel(float*)", 20, 50)], 1e-3, 2)
    ctx = readers.Context(t, dict(elements=10**6), root=tmp_path)
    assert ctx.kernel_us_per_window("scale") == pytest.approx(5.0)
    assert ctx.roofline_pct("scale") == pytest.approx(
        100 * 8e6 / 3.35e12 / 5e-6)
    none = trace.DeviceTrace([ev("upscale_kernel(float*)", 0, 5)], 1e-3, 1)
    assert readers.Context(none, {}, root=tmp_path).roofline_pct(
        "scale") is None


def test_reference_imports_nothing_of_the_program():
    import ast
    for path in (ROOT / "gpubench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            assert not [n for n in names if n.split(".")[0] in (
                "repro_torch", "repro", "jax", "benchmarks")], path
