"""NEST's HPC benchmark network with its plastic E->E synapses on the
port: the balanced random network of ``snn/hpc_benchmark.py`` (fixed
in-degrees 9,000 + 2,250 with multapses, ``iaf_psc_alpha`` neurons, 1.5 ms
delays, a Poisson drive per neuron, ``stdp_pl_synapse_hom`` on every
E->E synapse) at ``--scale``, one benchmark unit a wafer shard by default
(scale 8 over 8 shards: 90,000 neurons, 1.01 billion synapses), on a
credited torus3d of 124-event rows (one Extoll bucket), drawn and run on
the card.

Prints the network, then, after ``--ms`` of biological time: the mean
rate, the mean CV of the interspike intervals (from each neuron's kept
post-spike archive), spikes and synaptic events a window, the share of
the events offered to the flush that were dropped, deadline misses, the
E->E weights' mean and s.d., the plasticity counters (history_short
among them), the peak device memory and the wall time a window, beside
the device's name.

Run:  PYTHONPATH=src python -m repro_torch.examples.hpc_benchmark \\
          [--scale 8] [--ms 1000] [--credits 4096] [--device cpu]

(``--device cpu`` runs the plain versions; keep ``--scale`` at 0.2 or
below there: the in-degree is 11,250 at every scale.  Without it the
run raises when there is no card.)
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import examples
from repro_torch.kernels import dispatch
from repro_torch.snn import hpc_benchmark as hb, network, simulator as sim
from repro_torch.snn import stdp

SEGMENT = 16
N_SHARDS = 8                 # torus3d 2x2x2
CAPACITY = 124               # one Extoll bucket a row
E_MAX = 4096                 # twice the worst window the card showed


def main(scale: float = 8.0, ms: float = 1000.0, *, credits: int = 4096,
         seed: int = 1, device=None) -> dict:
    device = dispatch.resolve_device(device)
    spec = hb.HpcSpec(scale=scale)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    src = spec.draw_sources(gen)
    part = network.build_indegree_partition(src, spec.is_inh(), N_SHARDS,
                                            spec.je_pa, spec.ji_pa,
                                            hb.STDP.delay_steps)
    del src
    n_syn = part.n_synapses + int(part.plastic.targets.numel())
    print(f"HPC benchmark at scale {scale:g}: {spec.n_neurons:,} neurons "
          f"({spec.n_exc:,} E, {spec.n_inh:,} I), {n_syn:,} synapses "
          f"({int(part.plastic.targets.numel()):,} plastic E->E), "
          f"{N_SHARDS} shards of {part.per_shard:,}")
    cfg = sim.SimConfig(
        n_shards=N_SHARDS, per_shard=part.per_shard,
        max_fan=part.fanout.shape[1], window=8, ring_len=32, e_max=E_MAX,
        capacity=CAPACITY, params=hb.PARAMS, residue=256,
        transport="torus3d", torus_nx=2, torus_ny=2, torus_nz=2,
        link_credits=credits, notify_latency=4)
    rate = np.full(spec.n_neurons, spec.drive_rate_hz(), np.float32)
    init, run_segment, _ = sim.build_sharded_segments(
        cfg, part, rate, spec.je_pa, device=device, stdp=hb.STDP)
    n_plastic = int(part.plastic.targets.numel())
    del part
    carry = init(seed)
    v0 = hb.V0_MEAN + hb.V0_SD * torch.randn(
        (N_SHARDS, cfg.per_shard), generator=gen, device=device)
    carry = carry._replace(state=carry.state._replace(
        neuron=carry.state.neuron._replace(v=v0)))
    examples.synchronize(device)
    print(f"built in {time.perf_counter() - t0:.1f} s")
    steps_per_ms = round(1.0 / hb.PARAMS.dt)
    n_seg = max(1, round(ms * steps_per_ms / (cfg.window * SEGMENT)))
    keys = ("spikes", "offered", "overflow", "deadline_miss",
            "delivered")
    tot = dict.fromkeys(keys, 0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t1 = time.perf_counter()
    for _ in range(n_seg):
        carry, st = run_segment(carry, SEGMENT)
        for k in keys[:-1]:
            tot[k] += int(getattr(st, k).sum())
        tot["delivered"] += int(st.link.delivered_events.sum())
    examples.synchronize(device)
    wall = time.perf_counter() - t1
    windows = n_seg * SEGMENT
    bio_s = windows * cfg.window * hb.PARAMS.dt * 1e-3
    ar = carry.plastic.archive
    H = ar.step.shape[-1]
    n = ar.count.reshape(-1).long()
    steps = ar.step.reshape(-1, H).long()
    # the kept spikes in time order: entry (n - k) % H for k = kept..1
    k = torch.arange(H, 0, -1, device=device)
    order = torch.remainder(n[:, None] - k[None], H)
    times = torch.gather(steps, 1, order).double()
    kept = torch.clamp(n, max=H)
    valid = k[None] <= kept[:, None]
    isi = times[:, 1:] - times[:, :-1]
    ok = valid[:, 1:] & valid[:, :-1]
    cnt = ok.sum(1)
    mean = (isi * ok).sum(1) / cnt.clamp(min=1)
    var = ((isi - mean[:, None]) ** 2 * ok).sum(1) / cnt.clamp(min=1)
    has = cnt >= 2
    cv = float((var.sqrt() / mean)[has].mean()) if bool(has.any()) \
        else float("nan")
    w = carry.plastic.weights
    counts = dict(zip(stdp.COUNTERS, carry.plastic.counts.sum(0).tolist()))
    out = {
        "rate_hz": tot["spikes"] / (spec.n_neurons * bio_s),
        "cv": cv,
        "spikes_per_window": tot["spikes"] / windows,
        "delivered_per_window": tot["delivered"] / windows,
        "plastic_updates_per_window": counts["updates"] / windows,
        "dropped_share": tot["overflow"] / max(tot["offered"]
                                               + tot["overflow"], 1),
        "deadline_miss": tot["deadline_miss"],
        "w_mean": float(w.mean()), "w_sd": float(w.std()),
        "w_min": float(w.min()), "w_max": float(w.max()),
        "counters": counts, "n_plastic": n_plastic,
        "window_ms": wall * 1e3 / windows, "bio_s": bio_s,
        "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                    if device.type == "cuda" else 0.0),
    }
    print(f"{bio_s:.3f} s simulated in {windows} windows: "
          f"{out['rate_hz']:.3f} Hz, CV {cv:.3f}, "
          f"{out['spikes_per_window']:.1f} spikes and "
          f"{out['plastic_updates_per_window']:,.0f} plastic updates a "
          f"window")
    print(f"events dropped at the flush: {100 * out['dropped_share']:.3f}%"
          f" ; deadline misses: {tot['deadline_miss']}")
    print(f"E->E weights: mean {out['w_mean']:.4f} pA, s.d. "
          f"{out['w_sd']:.4f} (min {out['w_min']:.3f}, max "
          f"{out['w_max']:.3f}; start {spec.je_pa:.4f})")
    print("plasticity: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    print(f"history_short: {counts['history_short']}")
    print(f"wall: {out['window_ms']:.3f} ms a window, peak "
          f"{out['peak_gb']:.2f} GB on {examples.device_label(device)}")
    return out


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=8.0)
    ap.add_argument("--ms", type=float, default=1000.0,
                    help="biological time to simulate [ms]")
    ap.add_argument("--credits", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default=None)
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = _parse()
    main(a.scale, a.ms, credits=a.credits, seed=a.seed, device=a.device)
