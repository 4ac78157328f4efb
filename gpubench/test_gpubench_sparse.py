"""The full-scale microcircuit's kind (``microcircuit_sparse``) on its small
CPU twin: ``pd-microcircuit-1.0-8w`` at scale 0.004 on a small mix made
from ``torus3d_c124_full``, added to a copied manifest by files and
entries alone.  The sound program is correct and bit for bit; traced, its
delivery span metric reads; each planted fault and the bf16 control fail;
nothing of JAX is loaded."""
from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from gpubench.conftest import TINY_CONFIGS, TINY_TRAFFIC, make_tiny_root
from gpubench.harness import manifest, runner
from gpubench.test_gpubench_faults import FAULTS, plant

CELL = "tiny_full_torus"
SEED = 2**33 + 7


@pytest.fixture(scope="module")
def sparse_root(tmp_path_factory):
    return make_tiny_root(
        tmp_path_factory.mktemp("sparse"),
        configs={"pd-full-tiny": {"base": "pd-microcircuit-1.0-8w",
                                  "set": TINY_CONFIGS["pd-tiny"]["set"]}},
        traffic={CELL: {"base": "torus3d_c124_full",
                        "set": TINY_TRAFFIC["tiny_torus"]["set"]}},
        cells={CELL: ("pd-full-tiny", CELL)})


def run(root, *, trace=False, control=False):
    return runner.run_cell(root, CELL, seed=SEED, seconds=0.4, trace=trace,
                           device="cpu", t_start=time.perf_counter(),
                           control=control)


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
    out[trace] = runner.run_cell(
        Path(root), sys.argv[2], seed=int(sys.argv[3]), seconds=0.4,
        trace=bool(trace), device="cpu", t_start=time.perf_counter())
out["forbidden"] = guard.forbidden_modules()
print(json.dumps(out))
"""


def test_sparse_twin_is_correct_and_reads_its_delivery_span(sparse_root):
    """In a process of the copied checkout: the manifest check passes; the
    twin is correct bit for bit, untraced and traced; traced, its delivery
    span metric reads; nothing of JAX is loaded."""
    proc = subprocess.run(
        [sys.executable, "-c", RUN, str(sparse_root), CELL, str(SEED)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out.pop("forbidden") == []
    for line in out.values():
        assert line["correct"], line["compared"]
        assert line["failed"] == 0 and line["attempted"] > 0
        assert line["compared"]["mismatched_ints"]["value"] == 0
        assert line["compared"]["float_gap"]["value"] == 0.0
    assert set(out["0"]["metrics"]) == {"window_ms", "setup_s"}
    traced = out["1"]["metrics"]
    assert traced["mc.deliver_ms_per_window"]["value"] > 0.0
    assert traced["mc.deliver_ms_per_window"]["unit"] == "ms"
    names = {m["name"] for m in manifest.load(sparse_root, CELL).per_layer}
    assert {"mc.deliver_ms_per_window", "synapse_deliver_roofline",
            "mc.device_fns_per_window"} <= names


def test_sparse_twin_sizes_count_the_traced_windows(sparse_root):
    """The traced run's sizes carry the synapses and events delivered a
    window over the traced segments, from the store's counter and the
    link statistics."""
    from gpubench.kinds import microcircuit_sparse as mcs
    cell = manifest.load(sparse_root, CELL)
    out = mcs.run(cell, seed=SEED, seconds=0.3, trace=True, device="cpu",
                  t_start=time.perf_counter())
    z = out["ctx"].sizes
    assert z["synapses_per_window"] > 0 and z["delivered_per_window"] > 0
    assert z["synapses_per_window"] > z["delivered_per_window"]
    assert [e["name"] for e in out["ctx"].spans] == ["window/deliver"] * (
        cell.traffic["trace_segments"] * cell.traffic["segment_windows"])


@pytest.mark.parametrize("fault", FAULTS)
def test_broken_sparse_simulator_is_not_correct(sparse_root, monkeypatch,
                                                fault):
    plant(monkeypatch, sparse_root, CELL, fault)
    line = run(sparse_root)
    assert not line["correct"], line["compared"]


def test_bf16_weight_control_is_not_correct(sparse_root):
    line = run(sparse_root, control=True)
    assert not line["correct"]
    assert line["compared"]["float_gap"]["value"] > 1e-4
