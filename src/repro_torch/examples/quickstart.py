"""Quickstart of the port (counterpart of ``examples/quickstart.py``): the
paper's event-aggregation fabric in a minute.

1. push a window of spike events through the bucket aggregator (on the
   card the flush-window kernel), 2. run a trace through the cycle-level
   bucket model (on the card one launch of the cycle-model kernel) and
   watch the paper's header-overhead effect, 3. build routing tables
   (source LUT + GUID multicast) for a toy 2-FPGA system, 4. train a tiny
   LM for a few steps with the same framework stack.

The reference draws the window's addresses and deadlines with
``jax.random``; here they come from ``np.random.default_rng(0)``, or are
passed in (``spike_aggregation_demo(addr, deadline)``).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import aggregator, bucket, events as ev, routing as rt
from repro_torch.kernels import dispatch

N_EVENTS = 256
LM_STEPS = 10


def draw_window():
    """(addr, deadline): 256 addresses in [0, 64) and deadlines in
    [50, 200), from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 64, N_EVENTS), rng.integers(50, 200, N_EVENTS)


def spike_aggregation_demo(addr=None, deadline=None, *, device=None):
    """Aggregation and the cycle model; returns (buckets, (final bucket
    state, cycle outputs))."""
    device = dispatch.resolve_device(device)
    print("=== paper §3.1: event aggregation ===")
    # events from 8 HICANN links, addressed to 4 destination FPGAs
    if addr is None:
        addr, deadline = draw_window()
    addr = torch.as_tensor(np.array(addr), dtype=torch.int32,
                           device=device)
    deadline = torch.as_tensor(np.array(deadline), dtype=torch.int32,
                               device=device)
    n = addr.shape[0]
    words = ev.pack(addr, deadline)
    dest = addr % 4

    b = aggregator.aggregate(words, dest, None, n_dest=4, capacity=124)
    cost = aggregator.window_cost(b.counts)
    naive = aggregator.unaggregated_cost(n)
    print(f"  {n} events -> buckets {list(b.counts.cpu().numpy())}")
    print(f"  aggregated: {int(cost.bytes)} wire bytes "
          f"(eff {float(cost.efficiency):.2f})")
    print(f"  unaggregated: {int(naive.bytes)} wire bytes "
          f"(eff {float(naive.efficiency):.2f})  "
          f"-> {int(naive.bytes) / int(cost.bytes):.1f}x saved")

    # the cycle-level model (the 'simulation model' the paper calls for)
    cfg = bucket.BucketConfig(n_buckets=4, capacity=124, n_dest=4,
                              flush_margin=8)
    T = 200
    steps = torch.arange(T, dtype=torch.int32, device=device)[:, None]
    tr_words = ev.pack(torch.zeros((T, 1), dtype=torch.int32, device=device),
                       (steps + 100) & ev.TS_MASK)
    tr_dest = torch.zeros((T, 1), dtype=torch.int32, device=device)
    st, out = bucket.run_trace(cfg, tr_words, tr_dest)
    sent = out.sent_count.cpu().numpy()
    print(f"  cycle model: {int(sent.sum())} events drained in {T} clocks, "
          f"packets of mean {sent[sent > 0].mean():.1f} events")
    return b, (st, out)


def routing_demo(*, device=None):
    """LUT routing and GUID multicast; returns (dest, guid, routed,
    masks)."""
    device = dispatch.resolve_device(device)
    print("=== paper §3: LUT routing + GUID multicast ===")
    tabs = rt.build_tables(16, [
        rt.Projection(0, 8, dest_node=3, dest_links=[0, 5]),
        rt.Projection(8, 16, dest_node=7, dest_links=[2]),
    ], device=device)
    words = ev.pack(torch.arange(16, device=device),
                    torch.zeros(16, dtype=torch.int32, device=device))
    dest, guid, ok = tabs.route(words)
    masks = tabs.multicast(guid)
    print(f"  sources 0-7  -> node {int(dest[0])}, multicast links "
          f"{[i for i in range(8) if int(masks[0]) >> i & 1]}")
    print(f"  sources 8-15 -> node {int(dest[8])}, multicast links "
          f"{[i for i in range(8) if int(masks[8]) >> i & 1]}")
    return dest, guid, ok, masks


def tiny_lm_demo(params=None, *, device=None) -> list[float]:
    """Reduced qwen3-32b trained for 10 steps on ``synthetic_batch``
    (from ``params``, else a draw from seed 0); returns the 10 losses."""
    device = dispatch.resolve_device(device)
    print("=== the LM stack on the same substrate ===")
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.models import build
    from repro_torch.models.transformer import Runtime
    from repro_torch.train import optimizer as opt
    from repro_torch.train.optimizer import OptimizerConfig, ScheduleConfig
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        make_train_step)

    cfg = reduced(get_config("qwen3_32b"))
    model = build(cfg)
    tcfg = TrainConfig(optimizer=OptimizerConfig(
        schedule=ScheduleConfig(kind="cosine", peak_lr=2e-3,
                                warmup_steps=3, total_steps=30)))
    if params is None:
        state = init_train_state(model, torch.Generator().manual_seed(0),
                                 tcfg, device)
    else:
        state = {"params": params,
                 "opt": opt.init_opt(params, tcfg.optimizer),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
    step = make_train_step(model, tcfg, Runtime())
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
    losses = []
    for i in range(LM_STEPS):
        batch = {k: v.to(device) for k, v in synthetic_batch(dcfg, i).items()}
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        if i % 3 == 0:
            print(f"  step {i}: loss {float(metrics['loss']):.3f} "
                  f"lr {float(metrics['lr']):.2e}")
    return [float(x) for x in losses]


def main(*, device=None):
    """The four demos; returns their outputs (the aggregation and cycle
    model's, the routing's, the tiny LM's losses)."""
    device = dispatch.resolve_device(device)
    fabric = spike_aggregation_demo(device=device)
    routes = routing_demo(device=device)
    losses = tiny_lm_demo(device=device)
    print("done.")
    return fabric, routes, losses


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    main(device=ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
