"""End-to-end run of the port (counterpart of
``examples/multiwafer_microcircuit.py``): the paper's target workload, a
Potjans-Diesmann cortical microcircuit spread over 4 'wafer' shards, spikes
exchanged through the bucket-aggregated transport fabric.

Prints the reference's lines in its order: the network, the partition,
(from ``WIDE_FROM`` up only) the buffer sizes, the transport, spikes and
mean rate, events shipped, wire bytes, the aggregation saving, deadline
misses and overflows, frame-exact bytes on the wire of the chosen profile,
the event latency percentiles and, on a torus, the link statistics; then
the run's wall time on its device.  The shard axis is a leading tensor
dimension (no mesh): each window is one LIF window launch, one flush
window (route, bucket, wire encode) and one decode for all shards.

Run:  PYTHONPATH=src python -m repro_torch.examples.multiwafer_microcircuit \\
          [alltoall|torus2d|torus3d] [extoll|ethernet] [--scale S] \\
          [--device cpu]

(the transport and wire profile as in the reference: ``torus2d`` walks a
2x2 torus, ``torus3d`` a 1x2x2 one whose Z rings are the wafer axis.
``--scale`` is the microcircuit's, default the reference's 0.004; 0.2,
15,431 neurons, is the widest whose dense replica layout fits the 14-bit
address over 4 shards.  From scale ``WIDE_FROM`` (0.05) up the buffers
are ``WIDE_SIZES``, at which nothing overflows at 0.2, not the
reference's ``SIZES``, and above 0.2 ``SPARSE_SIZES``; the run prints
them.  Above scale ``DENSE_UP_TO`` (0.2) the network is drawn sparsely
(``MicrocircuitSpec.synapses``) into a ``network.SparsePartition`` on the
device, with source labels in the 14-bit address, over ``SPARSE_SHARDS``
(8) shards: at full scale (1.0, 77,169 neurons, ~285 M synapses) 9,647
neurons a shard; asked for 4 shards (``main(n_shards=4)``, 19,293 a
shard) the address does not fit, and the run refuses before drawing
anything.
Without ``--device cpu`` it runs on the card and raises without one.)

``main`` also takes a prebuilt network (``build_network``: at scale 0.2
the host build of the 0.95 GB weight matrix is the set-up cost, so reuse
it across transports), an initial state and the background ``drive``
(``(n_windows, window, shards, per_shard)`` f32), which the reference
draws with ``jax.random`` inside its scan: injecting both is how a run is
held to the reference's, or a card's run to the CPU's.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import NamedTuple

import torch

from repro_torch import examples
from repro_torch.configs import brainscales
from repro_torch.core import aggregator
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import wafer_torus_shape, wafer_wire_format
from repro_torch.snn import microcircuit as mc, network, simulator as sim

TRANSPORTS = ("alltoall", "torus2d", "torus3d")
WIRE_FORMATS = ("extoll", "ethernet")
REFERENCE_SCALE = 0.004
N_SHARDS = 4
N_WINDOWS = 25                 # 25 x 8 x 0.1 ms = 20 ms biological
SIZES = dict(e_max=512, capacity=512)          # the reference's
WIDE_SIZES = dict(e_max=1024, capacity=1024)  # no overflow at scale 0.2
# above DENSE_UP_TO: a neuron fires at most once a window (its 2 ms
# refractory time is longer than a window), so neither the compaction nor
# a bucket row can hold more than the 9,647 neurons of a full-scale shard
SPARSE_SIZES = dict(e_max=16384, capacity=16384)
WIDE_FROM = 0.05               # scales from which WIDE_SIZES apply
DENSE_UP_TO = 0.2              # above it the network is drawn sparsely
SPARSE_SHARDS = 8              # shards of a sparse network by default


class Network(NamedTuple):
    spec: mc.MicrocircuitSpec
    n_synapses: int
    part: network.Partition | network.SparsePartition


class Result(NamedTuple):
    cfg: sim.SimConfig
    state: sim.ShardState          # after the run
    stats: sim.WindowStats         # stacked to (shards, windows)
    wall_s: float                  # the run, host clock, synchronised


def build_network(scale: float = REFERENCE_SCALE, n_shards: int | None = None,
                  *, device=None) -> Network:
    """The microcircuit at ``scale`` partitioned over ``n_shards`` shards
    (default ``N_SHARDS``, above ``DENSE_UP_TO`` ``SPARSE_SHARDS``): up to
    ``DENSE_UP_TO`` from the dense weight matrix (host numpy, dropped once
    partitioned), above it drawn sparsely and partitioned on ``device``.
    Raises before drawing when the layout's addresses do not fit 14 bits."""
    spec = mc.MicrocircuitSpec(scale=scale)
    n_shards = n_shards or (N_SHARDS if scale <= DENSE_UP_TO
                            else SPARSE_SHARDS)
    # either layout needs an address a neuron of a shard: refuse before
    # the draw (the replica layout's own check follows it)
    network.check_address_layout("source", -(-spec.n_neurons // n_shards))
    if scale <= DENSE_UP_TO:
        w, is_inh = spec.weight_matrix()
        n_synapses = int((w != 0).sum())
        part = network.build_partition(w, is_inh, n_shards=n_shards)
        return Network(spec, n_synapses, part)
    device = dispatch.resolve_device(device)
    src, tgt, weight, is_inh = spec.synapses()
    as_t = lambda a: torch.from_numpy(a).to(device)
    part = network.build_sparse_partition(as_t(src), as_t(tgt),
                                          as_t(weight), is_inh, n_shards)
    return Network(spec, part.n_synapses, part)


def sim_config(net: Network, transport: str = "alltoall",
               wire_format: str = "extoll") -> sim.SimConfig:
    """The example's simulator configuration: ``brainscales.CONFIG``'s
    transport fields with ``transport`` and ``wire_format``, 8-step
    windows, a 32-slot delay ring and the buffers of the network's
    width."""
    part = net.part
    bs = dataclasses.replace(brainscales.CONFIG, transport=transport,
                             wire_format=wire_format)
    sizes = (SPARSE_SIZES if net.spec.scale > DENSE_UP_TO else
             WIDE_SIZES if net.spec.scale >= WIDE_FROM else SIZES)
    return sim.SimConfig(
        n_shards=part.n_shards, per_shard=part.per_shard,
        max_fan=part.fanout.shape[1],
        window=8,                  # <= min axonal delay (deadline flush)
        ring_len=32, **sizes, **bs.transport_fields())


def main(transport: str = "alltoall", wire_format: str = "extoll", *,
         scale: float = REFERENCE_SCALE, net: Network | None = None,
         state: sim.ShardState | None = None, drive=None,
         n_windows: int = N_WINDOWS, device=None,
         n_shards: int | None = None) -> Result:
    """Simulate ``n_windows`` windows and print the reference's summary.
    ``net`` (else built at ``scale`` over ``n_shards``), ``state`` (else
    drawn from seed 0) and ``drive`` (else drawn from the state's
    generator) as in the module docstring; ``device`` ``None`` /
    ``"cuda"`` is the card."""
    device = dispatch.resolve_device(device)
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, got "
                         f"{transport!r}")
    if wire_format not in WIRE_FORMATS:
        raise ValueError(f"wire_format must be one of {WIRE_FORMATS}, got "
                         f"{wire_format!r}")
    net = net or build_network(scale, n_shards, device=device)
    spec, part = net.spec, net.part
    n_shards = part.n_shards
    print(f"microcircuit: {spec.n_neurons} neurons, "
          f"{net.n_synapses} synapses (scale={spec.scale})")
    print(f"partition: {n_shards} wafer shards x {part.per_shard} neurons, "
          f"max fan-out {part.fanout.shape[1]} shards/source")
    if isinstance(part, network.SparsePartition):
        print("layout: source labels in the 14-bit address, sparse "
              "synapse store, delivery in event order")

    cfg = sim_config(net, transport, wire_format)
    if spec.scale >= WIDE_FROM:
        print(f"buffers: e_max {cfg.e_max}, capacity {cfg.capacity} "
              f"(the reference's are {SIZES['e_max']} and "
              f"{SIZES['capacity']}; wider from scale {WIDE_FROM} up, "
              f"wider still above {DENSE_UP_TO})")
    if transport == "torus2d":
        print(f"transport: {transport} {wafer_torus_shape(n_shards)} torus")
    elif transport == "torus3d":
        print(f"transport: {transport} "
              f"{wafer_torus_shape(n_shards, ndim=3)} torus")
    else:
        print(f"transport: {transport}")
    init, run = sim.build_sharded_sim(cfg, part, spec.bg_rates(),
                                      device=device)
    if state is None:
        state = init(seed=0)

    t0 = time.perf_counter()
    state, stats = run(state, n_windows, drive=drive)
    examples.synchronize(device)
    wall = time.perf_counter() - t0

    host = lambda t: t.cpu().numpy()
    sent = int(host(stats.events_sent).sum())
    wire = int(host(stats.wire_bytes).sum())
    miss = int(host(stats.deadline_miss).sum())
    ovf = int(host(stats.overflow).sum())

    bio_ms = n_windows * cfg.window * cfg.params.dt
    total_spikes = int(host(stats.spikes).sum())
    rate = total_spikes / (spec.n_neurons * bio_ms * 1e-3)
    print(f"\nsimulated {bio_ms:.1f} ms: {total_spikes} spikes, "
          f"mean rate {rate:.1f} Hz")
    print(f"events shipped (incl. fan-out replicas): {sent}")
    print(f"Extoll wire bytes: {wire} "
          f"({wire / max(sent, 1):.1f} B/event effective)")
    naive = int(aggregator.unaggregated_cost(sent).bytes)
    print(f"without aggregation: {naive} bytes "
          f"-> bucket aggregation saves {naive / max(wire, 1):.1f}x")
    print(f"deadline misses: {miss}   bucket overflows: {ovf}")
    # frame-exact wire accounting and the per-event latency distribution
    # of the configured protocol profile
    fmt = wafer_wire_format(wire_format)
    on_wire = int(host(stats.link.bytes_on_wire).sum())
    p50s = host(stats.latency.p50_us)
    p50 = float(p50s[:, 1:].mean()) if p50s.shape[1] > 1 else 0.0
    p99 = float(host(stats.latency.p99_us).max())
    lmax = float(host(stats.latency.max_us).max())
    print(f"wire profile '{fmt.name}': {on_wire} bytes on wire "
          f"(frame-exact; {fmt.header_bytes + fmt.crc_bytes} B/frame tax, "
          f"{fmt.gap_bytes} B gap, {fmt.cell_bytes} B cells)")
    print(f"event latency: p50 {p50:.2f} us (mean over windows), "
          f"p99 {p99:.2f} us, max {lmax:.2f} us")
    if transport in ("torus2d", "torus3d"):
        link = stats.link
        print(f"torus link stats: {int(link.hops[0, 0])} hops/window, "
              f"{int(host(link.forwarded_bytes).sum())} forwarded bytes, "
              f"max in-flight {int(host(link.max_in_flight).max())} events, "
              f"{int(host(link.credit_stalls).sum())} credit stalls")
    print(f"wall: {n_windows} windows in {wall * 1e3:.1f} ms, "
          f"{wall * 1e3 / n_windows:.3f} ms per window on "
          f"{examples.device_label(device)}")
    assert miss == 0, "windowed exchange must respect timestamp deadlines"
    print("ok.")
    return Result(cfg, state, stats, wall)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("transport", nargs="?", default="alltoall",
                    choices=TRANSPORTS)
    ap.add_argument("wire_format", nargs="?", default="extoll",
                    choices=WIRE_FORMATS)
    ap.add_argument("--scale", type=float, default=REFERENCE_SCALE,
                    help="microcircuit scale (0.2: 15,431 neurons, the "
                         "widest whose dense replica layout the 14-bit "
                         "address carries over 4 shards; above it the "
                         "sparse store over 8 shards, 1.0 the full 77,169 "
                         "neurons; from 0.05 up the buffers are 1,024 "
                         "wide, not the reference's 512)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)
    main(args.transport, args.wire_format, scale=args.scale,
         device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
