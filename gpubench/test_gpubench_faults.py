"""A run with the timed path broken underneath must come out not correct.

Each test drives a whole small cell on the CPU (the harness's look for a
card skipped) with one fault planted in the program: a step that returns
its state unchanged, half of the batch (the shards) left out, the
exchange between shards left out (on the cell's own transport), an
answer altered where it is produced.

Run as a script, the same faults are planted in cells of the manifest at
their own size on the card, one run each per seed:

    python3 gpubench/test_gpubench_faults.py <cell> <seed> [<seed> ...]

which prints one JSON line a run: the cell, the fault, the seed,
``correct`` and the numbers compared.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from gpubench.harness import manifest, runner  # noqa: E402


def run(root, cell):
    return runner.run_cell(root, cell, seed=2**32 + 3, seconds=0.4,
                           trace=False, device="cpu",
                           t_start=time.perf_counter())


def _no_delivery(out, keep):
    """``out`` with every received row of the shards ``keep`` does not
    select emptied."""
    counts = torch.where(keep, out.recv_counts, 0)
    return out._replace(recv_counts=counts)


def plant_sim(monkeypatch, fault, transport):
    from repro_torch.snn import simulator
    from repro_torch.transport import alltoall, torus
    real_window = simulator.lif_window
    real_build = simulator.build_sharded_segments
    cls = (alltoall.AllToAllTransport if transport == "alltoall"
           else torus.TorusTransport)
    real_exchange = cls.exchange

    if fault == "state_unchanged":
        def build(*a, **k):
            init, run_segment, finish = real_build(*a, **k)
            return init, (lambda carry, n, drive=None: (
                carry, run_segment(carry, n, drive)[1])), finish
        monkeypatch.setattr(simulator, "build_sharded_segments", build)
    elif fault == "half_batch":
        def window(neuron, p, re, ri, t0, drive):
            new, spikes = real_window(neuron, p, re, ri, t0, drive)
            half = neuron.v.shape[0] // 2
            kept = type(new)(*(torch.cat([x[:half], y[half:]]) for x, y in
                               zip(new, neuron)))
            spikes = spikes.clone()
            spikes[half:] = False
            return kept, spikes
        monkeypatch.setattr(simulator, "lif_window", window)
    elif fault == "no_exchange":
        def exchange(self, state, payload, counts, **k):
            out = real_exchange(self, state, payload, counts, **k)
            return _no_delivery(out, torch.zeros_like(counts, dtype=bool))
        monkeypatch.setattr(cls, "exchange", exchange)
    elif fault == "answer_altered":
        def window(*a):
            new, spikes = real_window(*a)
            spikes = spikes.clone()
            spikes[0, 0, 0] = ~spikes[0, 0, 0]
            return new, spikes
        monkeypatch.setattr(simulator, "lif_window", window)


def plant_serve(monkeypatch, fault):
    from repro_torch.serve import spike_engine
    from repro_torch.transport import torus
    from repro_torch.wire import codec
    real_window = spike_engine.SpikeEngine._window
    real_exchange = torus.TenantTorusTransport.exchange
    real_decode = codec.decode_planar

    if fault == "state_unchanged":
        def window(self, carry, fw_w, fc_w, win_abs):
            return carry, real_window(self, carry, fw_w, fc_w, win_abs)[1]
        monkeypatch.setattr(spike_engine.SpikeEngine, "_window", window)
    elif fault in ("half_batch", "no_exchange"):
        def exchange(self, state, payload, counts, **k):
            out = real_exchange(self, state, payload, counts, **k)
            keep = torch.zeros_like(out.recv_counts, dtype=torch.bool)
            if fault == "half_batch":
                keep[: keep.shape[0] // 2] = True
            return _no_delivery(out, keep)
        monkeypatch.setattr(torus.TenantTorusTransport, "exchange",
                            exchange)
    elif fault == "answer_altered":
        def decode(buf, *a):
            word, meta = real_decode(buf, *a)
            return word, meta + 1
        monkeypatch.setattr(codec, "decode_planar", decode)


FAULTS = ["state_unchanged", "half_batch", "no_exchange", "answer_altered"]


def plant(monkeypatch, root, cell, fault):
    """Plant ``fault`` in the program that ``cell`` of ``root`` runs."""
    c = manifest.load(root, cell)
    drives = manifest.kind_module(c).DRIVES
    if drives == "simulator":
        plant_sim(monkeypatch, fault, c.traffic["transport"])
    elif drives == "engine":
        plant_serve(monkeypatch, fault)
    else:
        raise ValueError(f"no faults to plant in a {drives!r} program")


@pytest.mark.parametrize("cell", ["tiny_alltoall", "tiny_torus"])
@pytest.mark.parametrize("fault", FAULTS)
def test_broken_simulator_is_not_correct(tiny_root, monkeypatch, cell,
                                         fault):
    plant(monkeypatch, tiny_root, cell, fault)
    line = run(tiny_root, cell)
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("cell", ["tiny_contended", "tiny_solo"])
@pytest.mark.parametrize("fault", FAULTS)
def test_broken_engine_is_not_correct(tiny_root, monkeypatch, cell, fault):
    plant(monkeypatch, tiny_root, cell, fault)
    line = run(tiny_root, cell)
    assert not line["correct"], line["compared"]


def main(argv) -> int:
    """Each fault planted in ``argv[0]`` at its own size on the card, once
    a seed in ``argv[1:]``."""
    from gpubench import run as bench_run
    root = bench_run.ROOT
    bench_run.setup_process()
    cell, seeds = argv[0], [int(x) for x in argv[1:]]
    for fault in FAULTS:
        for seed in seeds:
            with pytest.MonkeyPatch.context() as mp:
                plant(mp, root, cell, fault)
                line = runner.run_cell(root, cell, seed=seed, seconds=3.0,
                                       trace=False, device="cuda",
                                       t_start=time.perf_counter())
            print(json.dumps({"cell": cell, "fault": fault, "seed": seed,
                              "correct": line["correct"],
                              "compared": line["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
