"""NEST's HPC benchmark kind (``hpc_stdp``) on its small CPU twin:
``hpc-benchmark-8-8w`` at 400 neurons (in-degrees 80 + 20) on a small mix
made from ``torus3d_c124_k4096``, added to a copied manifest by files and
entries alone.  The sound program is correct and bit for bit, plastic
state and counters included; each planted fault and the plasticity-off
control fail; the traced run reads its metrics; the roofline counters at
the cell's sizes.  About 30 s on one worker.

Run as a script, the same faults are planted in the cell at its own size
on the card, one run each per seed:

    python3 gpubench/test_gpubench_stdp.py <seed> [<seed> ...]

which prints one JSON line a run: the fault, the seed, ``correct`` and the
numbers compared."""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from gpubench.conftest import TINY_TRAFFIC, make_tiny_root
from gpubench.harness import manifest, readers, runner
from gpubench.test_gpubench_faults import FAULTS, plant_sim

STDP_FAULTS = FAULTS + ["rule_skipped"]

CELL = "tiny_hpc_stdp"
SEED = 2**33 + 11
TINY = {"scale": 400 / 11250, "ce": 80, "ci": 20, "je_mv": 2.8,
        "e_max": 256, "residue": 64}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the twin runs many small ops, which a thread
    pool shared with the suite's other workers only slows."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stdp_root(tmp_path_factory):
    return make_tiny_root(
        tmp_path_factory.mktemp("stdp"),
        configs={"hpc-tiny": {"base": "hpc-benchmark-8-8w", "set": TINY}},
        traffic={CELL: {"base": "torus3d_c124_k4096", "set": {
            **TINY_TRAFFIC["tiny_torus"]["set"], "link_credits": 24}}},
        cells={CELL: ("hpc-tiny", CELL)})


def plant(monkeypatch, fault):
    """The planted faults of ``test_gpubench_faults.py`` on the alpha
    window (its faults on the exponential one reach no alpha neuron), and
    one of the rule: delivery that adds the plastic synapses but updates
    nothing of their state."""
    import torch
    from repro_torch.snn import simulator, stdp
    if fault in ("state_unchanged", "no_exchange"):
        return plant_sim(monkeypatch, fault, "torus3d")
    real_window = simulator.lif_alpha_window
    real_deliver = simulator.stdp_deliver
    if fault == "half_batch":
        def window(neuron, p, re, ri, t0, drive, **k):
            new, spikes = real_window(neuron, p, re, ri, t0, drive, **k)
            half = neuron.v.shape[0] // 2
            kept = type(new)(*(torch.cat([x[:half], y[half:]]) for x, y in
                               zip(new, neuron)))
            spikes = spikes.clone()
            spikes[half:] = False
            return kept, spikes
        monkeypatch.setattr(simulator, "lif_alpha_window", window)
    elif fault == "answer_altered":
        def window(*a, **k):
            new, spikes = real_window(*a, **k)
            spikes = spikes.clone()
            spikes[0, 0, 0] = ~spikes[0, 0, 0]
            return new, spikes
        monkeypatch.setattr(simulator, "lif_alpha_window", window)
    elif fault == "rule_skipped":
        def deliver(re, ri, words, counts, t, lists, state, *a):
            real_deliver(re, ri, words, counts, t, lists, stdp.clone(state),
                         *a)
        monkeypatch.setattr(simulator, "stdp_deliver", deliver)


def run(root, *, trace=False, control=False, seconds=0.4):
    return runner.run_cell(root, CELL, seed=SEED, seconds=seconds,
                           trace=trace, device="cpu",
                           t_start=time.perf_counter(), control=control)


RUN = """
import json, sys, time
import torch
torch.set_num_threads(1)
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


def test_stdp_twin_is_correct_and_reads_its_metrics(stdp_root):
    """In a process of the copied checkout: the manifest check passes; the
    twin is correct bit for bit, untraced and traced, with plastic
    updates and facilitations in the followed windows; nothing of JAX is
    loaded."""
    proc = subprocess.run(
        [sys.executable, "-c", RUN, str(stdp_root), CELL, str(SEED)],
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
    names = {m["name"] for m in manifest.load(stdp_root, CELL).per_layer}
    assert {"stdp_deliver_roofline", "lif_alpha_window_roofline",
            "synapse_deliver_roofline", "mc.device_fns_per_window"} <= names
    assert "lif_window_roofline" not in names


def test_stdp_twin_counts_its_plastic_work(stdp_root):
    """The traced run's sizes: plastic updates, archive entries read,
    static synapses and events a window, all from the program's own
    counters; history_short stays 0 and the weights moved."""
    from gpubench.kinds import hpc_stdp
    cell = manifest.load(stdp_root, CELL)
    made = []

    class Kept(hpc_stdp.Program):
        def __init__(self, *a):
            super().__init__(*a)
            made.append(self)
    parts = hpc_stdp.STDP._replace(program=Kept)
    out = hpc_stdp.mc.run_network(parts, cell, seed=SEED, seconds=0.3,
                                  trace=True, device="cpu",
                                  t_start=time.perf_counter())
    z = made[0].traced_sizes()
    assert z["plastic_updates_per_window"] > z["synapses_per_window"] > 0
    assert z["archive_reads_per_window"] > 0
    assert z["delivered_per_window"] > 0
    assert out["compared"]["mismatched_ints"][0] == 0


@pytest.mark.parametrize("fault", STDP_FAULTS)
def test_broken_stdp_simulator_is_not_correct(stdp_root, monkeypatch,
                                              fault):
    plant(monkeypatch, fault)
    line = run(stdp_root)
    assert not line["correct"], line["compared"]


def test_plasticity_off_control_is_not_correct(stdp_root):
    line = run(stdp_root, control=True)
    assert not line["correct"]
    assert line["compared"]["float_gap"]["value"] > 1e-4


@pytest.mark.parametrize("kernel", ["stdp_deliver", "lif_alpha_window",
                                    "synapse_deliver"])
def test_roofline_counters_at_the_cells_sizes(kernel):
    """The counters at the cell's sizes (90,000 neurons over 8 shards, ~720
    spikes a window at 10 Hz): each launch's least time a few to a few
    hundred microseconds, so a kernel's share cannot pass 100% unless the
    profiler's time falls below it."""
    z = {"n_shards": 8, "per_shard": 11250, "window": 8,
         "spikes_per_window": 720.0, "plastic_updates_per_window": 5.2e6,
         "archive_reads_per_window": 1.5e7, "synapses_per_window": 2.9e6,
         "delivered_per_window": 5760.0}
    n_bytes, n_ops = manifest.roofline(kernel).count(z)
    least = max(n_bytes / readers.HBM_BYTES_PER_S,
                n_ops / readers.F32_OPS_PER_S)
    assert 1e-6 < least < 1e-3, (kernel, least)


def main(argv) -> int:
    """Each fault planted in the cell ``hpc8_stdp_torus3d_c124`` at its own
    size on the card, once a seed in ``argv``."""
    from gpubench import run as bench_run
    root = bench_run.ROOT
    bench_run.setup_process()
    for fault in STDP_FAULTS:
        for seed in (int(x) for x in argv):
            with pytest.MonkeyPatch.context() as mp:
                plant(mp, fault)
                line = runner.run_cell(root, "hpc8_stdp_torus3d_c124",
                                       seed=seed, seconds=3.0, trace=False,
                                       device="cuda",
                                       t_start=time.perf_counter())
            print(json.dumps({"fault": fault, "seed": seed,
                              "correct": line["correct"],
                              "compared": line["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
