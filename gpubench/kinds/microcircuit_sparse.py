"""Microcircuit cells over a sparse synapse store: the network drawn as COO
synapses on the card (``gpubench.inputs.pd_sparse``), partitioned by the
port into its source address layout and sparse store
(``repro_torch.snn.network.build_sparse_partition``) and run through the
same segment API, set-up, timed window and check as the dense kind
(``kinds/microcircuit.py:run_network``), against the sparse reference
(``gpubench.reference.sparse_simulator``).

No (N, N) array exists on either side.  The COO inputs stay on the card
for the reference; the program's store is dropped before the reference
builds its own.  The control is the reference with its weights rounded to
bfloat16 before the adds.

With ``--trace 1`` the program records its delivery in ``window/deliver``
spans, and the cell's sizes gain, over the traced segments, the synapses
delivered a window (the store's device counter, zeroed before the
profiled stretch and read once after it) and the events delivered a
window (``link.delivered_events``), which ``rooflines/synapse_deliver.py``
counts from.
"""
from __future__ import annotations

import torch

from gpubench.inputs import pd_connectivity as pd, pd_sparse
from gpubench.kinds import microcircuit as mc
from gpubench.reference import lif as rlif, sparse_simulator as rsparse

DRIVES = "simulator"


class Inputs(mc.Inputs):
    """The dense kind's inputs with COO synapses in place of the weight
    matrix: ``src``, ``tgt``, ``weight`` drawn on the card from the same
    stream, then ``v0`` from it; the drive's streams unchanged."""

    def __init__(self, config: dict, seed: int, device):
        scale, S = config["scale"], config["n_shards"]
        self.seed, self.device = seed, torch.device(device)
        gen = torch.Generator(device=self.device).manual_seed(
            mc.substream(seed, 0))
        self.src, self.tgt, self.weight = pd_sparse.synapses(scale, gen)
        self.is_inh = pd.is_inhibitory(scale)
        n = len(self.is_inh)
        self.per = -(-n // S)
        bg = torch.zeros(self.per * S, dtype=torch.float32)
        bg[:n] = torch.from_numpy(pd.bg_rates(scale))
        self.bg_rates = bg[:n].numpy()
        self.bg = bg.reshape(S, self.per).to(self.device)
        self.bg_weight = float(config["bg_weight_pa"])
        self.dt = float(config["lif"]["dt"])
        lp = config["lif"]
        u = torch.rand((S, self.per), generator=gen, device=self.device)
        self.v0 = lp["e_l"] + (lp["v_th"] - lp["e_l"]) * u


class Program:
    """The port over its sparse partition; with an enabled ``tracer`` it
    counts the traced segments' synapses and events (module docstring)."""

    def __init__(self, cell, inputs: Inputs, device, tracer):
        from repro_torch.snn import lif, network, simulator as sim
        f = mc.sim_fields(cell)
        part = network.build_sparse_partition(
            inputs.src, inputs.tgt, inputs.weight, inputs.is_inh,
            f["n_shards"])
        self.cfg = sim.SimConfig(
            n_shards=f["n_shards"], per_shard=part.per_shard,
            max_fan=part.fanout.shape[1], window=f["window"],
            ring_len=f["ring_len"], e_max=f["e_max"],
            capacity=f["capacity"],
            params=lif.LIFParams(**cell.config["lif"]), residue=f["residue"],
            transport=f["transport"], torus_nx=f["torus_nx"],
            torus_ny=f["torus_ny"], torus_nz=f["torus_nz"],
            link_credits=f["link_credits"],
            notify_latency=f["notify_latency"],
            wire_format=f["wire_format"], step_us=f["step_us"])
        init, run_segment, _ = sim.build_sharded_segments(
            self.cfg, part, inputs.bg_rates, inputs.bg_weight, device=device,
            tracer=tracer)
        self.counter = part.store.count
        del part
        c = init(0)
        neuron = c.state.neuron._replace(v=inputs.v0.clone())
        self.carry0 = c._replace(state=c.state._replace(neuron=neuron,
                                                        generator=None))
        self.run_segment = run_segment
        self.traced, self.traced_synapses = [], None
        if tracer.enabled:
            self._count_traced(run_segment, cell.traffic["trace_segments"])

    def _count_traced(self, run_segment, n_traced: int):
        first = mc.WARMUP_SEGMENTS + mc.TRACE_START
        calls = [0]

        def counted(carry, n, drive=None):
            j = calls[0]
            calls[0] += 1
            if j == first + n_traced:
                self._read_counter()
            out = run_segment(carry, n, drive=drive)
            if first <= j < first + n_traced:
                self.traced.append(out[1])
            elif j == first - 1:
                self.counter.zero_()      # queued after that segment
            return out
        self.run_segment = counted

    def _read_counter(self):
        if self.traced_synapses is None:
            self.traced_synapses = int(self.counter)

    def traced_sizes(self) -> dict:
        """Synapses and events delivered a window over the traced
        segments."""
        self._read_counter()
        windows = sum(int(s.spikes.shape[1]) for s in self.traced)
        events = sum(int(s.link.delivered_events.sum()) for s in self.traced)
        return {"synapses_per_window": self.traced_synapses / windows,
                "delivered_per_window": events / windows}


def to_reference(carry) -> mc.rsim.Carry:
    """A copy of the program's carry as the reference's types, the
    residue's destinations with it."""
    ref = mc.to_reference(carry._replace(pending=tuple(carry.pending)[:6]))
    return ref._replace(pending=rsparse.SourcePendingWindow(
        *ref.pending, carry.pending.residue_dest.clone()))


def sparse_reference(cell, inputs: Inputs, device, precision: str):
    """The sparse reference in ``precision`` over the partition it works
    out from the COO inputs; made once, on the first call, after which the
    inputs' COO arrays are freed."""
    if not hasattr(inputs, "net"):
        inputs.net = rsparse.partition(
            inputs.src, inputs.tgt, inputs.weight,
            torch.from_numpy(inputs.is_inh).to(device),
            cell.config["n_shards"])
        del inputs.src, inputs.tgt, inputs.weight
    return rsparse.SparseWindow(mc.sim_fields(cell), inputs.net,
                                rlif.LIFParams(**cell.config["lif"]),
                                precision)


SPARSE = mc.Parts(Inputs, Program, sparse_reference, to_reference, "bf16")


def run(cell, **kw) -> dict:
    """``run_network`` with the sparse parts; a traced run's sizes gain
    the traced segments' synapses and events a window."""
    made = []

    def program(*a):
        made.append(Program(*a))
        return made[-1]
    out = mc.run_network(SPARSE._replace(program=program), cell, **kw)
    if out["ctx"] is not None:
        out["ctx"].sizes.update(made[0].traced_sizes())
    return out
