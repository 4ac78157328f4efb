"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout whose manifest gains small cells, added the way a later
change adds one, by files and entries alone."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# the microcircuit at scale 0.004 over 8 shards, the serving deployment at
# capacity 16: small enough for a CPU test to run a cell in seconds
TINY_CONFIGS = {
    "pd-tiny": {"base": "pd-microcircuit-0.2-8w", "set": {
        "scale": 0.004, "e_max": 256, "residue": 64}},
    "serve-tiny": {"base": "spike-serve-2t-torus3d-8w", "set": {
        "capacity": 16}},
}
TINY_TRAFFIC = {
    "tiny_torus": {"base": "torus3d_c124", "set": {
        "capacity": 16, "link_credits": 16, "notify_latency": 2,
        "segment_windows": 4, "check_segments": 2, "trace_segments": 1}},
    "tiny_alltoall": {"base": "alltoall_c1024", "set": {
        "capacity": 16, "segment_windows": 4, "check_segments": 2,
        "trace_segments": 1}},
    "tiny_hot": {"base": "hot600_burst3", "set": {
        "tenants": [{"name": "quiet", "rate_epw": 40.0},
                    {"name": "hot", "rate_epw": 200.0, "burst_factor": 3.0,
                     "burst_prob": 0.25}], "check_segments": 2}},
    "tiny_solo": {"base": "hot0_solo", "set": {"check_segments": 2}},
}
TINY_CELLS = {
    "tiny_torus": ("pd-tiny", "tiny_torus"),
    "tiny_alltoall": ("pd-tiny", "tiny_alltoall"),
    "tiny_contended": ("serve-tiny", "tiny_hot"),
    "tiny_solo": ("serve-tiny", "tiny_solo"),
}


def make_tiny_root(dest: Path, configs: dict | None = None,
                   traffic: dict | None = None,
                   cells: dict | None = None) -> Path:
    """Copy the benchmark to ``dest`` and add the small cells, with
    ``configs``, ``traffic`` and ``cells`` (specs shaped like
    ``TINY_CONFIGS``, ``TINY_TRAFFIC`` and ``TINY_CELLS``) beside them.  A
    cell joins every metric of the manifest's cell whose traffic its
    traffic is made from."""
    configs = {**TINY_CONFIGS, **(configs or {})}
    traffic = {**TINY_TRAFFIC, **(traffic or {})}
    cells = {**TINY_CELLS, **(cells or {})}
    shutil.copytree(ROOT / "gpubench", dest / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = dest / "gpubench"
    files = {c["name"]: c["file"] for c in man["configs"]}
    for name, spec in configs.items():
        cfg = json.loads((ROOT / files[spec["base"]]).read_text())
        cfg.update(spec["set"])
        path = f"gpubench/configs/{name}.json"
        (dest / path).write_text(json.dumps(cfg))
        man["configs"].append({"name": name, "source": "test",
                               "file": path, "reduced": [], "why": "test"})
    for name, spec in traffic.items():
        tr = json.loads((bench / "traffic" / f"{spec['base']}.json")
                        .read_text())
        tr.update(spec["set"])
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    by_traffic = {w["traffic"]: w["name"] for w in man["workloads"]}
    for cell, (config, mix) in cells.items():
        man["workloads"].append({"name": cell, "config": config,
                                 "traffic": mix, "chips": 1,
                                 "why": "test"})
        like = by_traffic[traffic[mix]["base"]]
        for m in man["end_to_end"] + man["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    (dest / "src").symlink_to(ROOT / "src")
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("bench"))
