"""NEST's HPC benchmark cells: a balanced network of alpha-current neurons
with fixed in-degrees, multapses and plastic E->E synapses, drawn on the
card from the seed (``gpubench.inputs.hpc_sparse``: each target's sources
in draw order, no weights), partitioned by the port one destination shard
at a time (``repro_torch.snn.network.build_indegree_partition``) and run
through the segment API with plasticity on, under ``kinds/microcircuit.py:
run_network``'s set-up, timed window and check, against
``gpubench.reference.stdp_simulator``.

The carry the check follows includes the plastic state: the weights, each
source's trace and last spike per shard, the post-spike archive and the
rule's counters (history_short among them).  The control is the reference
with plasticity off.

With ``--trace 1`` the cell's sizes gain, over the traced segments, the
static synapses delivered a window (the store's device counter), the
events delivered a window (``link.delivered_events``), and the plastic
updates and archive entries read a window (the carry's counters), which
``rooflines/synapse_deliver.py`` and ``rooflines/stdp_deliver.py`` count
from.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gpubench.inputs import hpc_sparse
from gpubench.kinds import microcircuit as mc
from gpubench.reference import simulator as rsim, stdp_simulator as rstdp
from gpubench.reference import flow_control as rfc, transport_base as rbase

DRIVES = "simulator"


def weights_pa(config: dict) -> tuple[float, float]:
    """(JE_pA, JI_pA): the script's conversion of a PSP peak of JE mV into
    the alpha PSC amplitude that gives it, and g times that."""
    p = config["lif"]
    tm, ts, cm = p["tau_m"], p["tau_syn"], p["c_m"]
    a, b = tm / ts, 1.0 / ts - 1.0 / tm
    x = -math.exp(-1.0 / a) / a
    w = math.log(-x) - math.log(-math.log(-x))       # W_{-1}(x), Halley
    for _ in range(64):
        e = math.exp(w)
        f = w * e - x
        w -= f / (e * (w + 1) - (w + 2) * f / (2 * w + 2))
    t_rise = 1.0 / b * (-w - 1.0 / a)
    v_max = math.e / (ts * cm * b) * (
        (math.exp(-t_rise / tm) - math.exp(-t_rise / ts)) / b
        - t_rise * math.exp(-t_rise / ts))
    je = config["je_mv"] / v_max
    return je, config["g"] * je


def drive_rate_hz(config: dict, je_pa: float) -> float:
    p = config["lif"]
    nu_th = p["v_th"] / (config["ce"] * p["tau_m"] / p["c_m"] * je_pa
                         * math.e * p["tau_syn"])
    return config["eta"] * nu_th * config["ce"] * 1000.0


class Inputs(mc.Inputs):
    """The source table, the initial potentials N(mean, sd) and the
    drive's streams (the dense kind's: Poisson counts x JE_pA)."""

    def __init__(self, config: dict, seed: int, device):
        scale, S = config["scale"], config["n_shards"]
        self.seed, self.device = seed, torch.device(device)
        gen = torch.Generator(device=self.device).manual_seed(
            mc.substream(seed, 0))
        n_exc = int(round(9000 * scale))
        n_inh = int(round(2250 * scale))
        n = n_exc + n_inh
        self.sources = hpc_sparse.sources(n_exc, n_inh, config["ce"],
                                          config["ci"], gen)
        self.is_inh = np.arange(n) >= n_exc
        self.per = -(-n // S)
        self.je, self.ji = weights_pa(config)
        rate = drive_rate_hz(config, self.je)
        bg = torch.zeros(self.per * S, dtype=torch.float32)
        bg[:n] = rate
        self.bg_rates = bg[:n].numpy()
        self.bg = bg.reshape(S, self.per).to(self.device)
        self.bg_weight = self.je
        self.dt = float(config["lif"]["dt"])
        z = torch.randn((S, self.per), generator=gen, device=self.device)
        self.v0 = config["v0_mean"] + config["v0_sd"] * z
        self.delay_steps = int(round(config["delay_ms"] / self.dt))


class Program:
    """The port over its partition with plasticity on; with an enabled
    ``tracer`` it counts the traced segments' work (module docstring)."""

    def __init__(self, cell, inputs: Inputs, device, tracer):
        from repro_torch.snn import lif, network, simulator as sim, stdp
        f = mc.sim_fields(cell)
        part = network.build_indegree_partition(
            inputs.sources, inputs.is_inh, f["n_shards"], inputs.je,
            inputs.ji, delay_steps=inputs.delay_steps)
        self.cfg = sim.SimConfig(
            n_shards=f["n_shards"], per_shard=part.per_shard,
            max_fan=part.fanout.shape[1], window=f["window"],
            ring_len=f["ring_len"], e_max=f["e_max"],
            capacity=f["capacity"],
            params=lif.AlphaParams(**cell.config["lif"]),
            residue=f["residue"], transport=f["transport"],
            torus_nx=f["torus_nx"], torus_ny=f["torus_ny"],
            torus_nz=f["torus_nz"], link_credits=f["link_credits"],
            notify_latency=f["notify_latency"],
            wire_format=f["wire_format"], step_us=f["step_us"])
        init, run_segment, _ = sim.build_sharded_segments(
            self.cfg, part, inputs.bg_rates, inputs.bg_weight,
            device=device, tracer=tracer,
            stdp=stdp.StdpParams(**cell.config["stdp"]))
        self.counter = part.store.count
        del part
        c = init(0)
        neuron = c.state.neuron._replace(v=inputs.v0.clone())
        self.carry0 = c._replace(state=c.state._replace(neuron=neuron,
                                                        generator=None))
        self.run_segment = run_segment
        self.traced, self.traced_synapses = [], None
        self.plastic_counts = []
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
                if j == first:
                    self.plastic_counts.append(carry.plastic.counts)
                if j == first + n_traced - 1:
                    self.plastic_counts.append(out[0].plastic.counts)
            elif j == first - 1:
                self.counter.zero_()      # queued after that segment
            return out
        self.run_segment = counted

    def _read_counter(self):
        if self.traced_synapses is None:
            self.traced_synapses = int(self.counter)

    def traced_sizes(self) -> dict:
        """Static synapses, events, plastic updates and archive entries
        read a window over the traced segments."""
        self._read_counter()
        windows = sum(int(s.spikes.shape[1]) for s in self.traced)
        events = sum(int(s.link.delivered_events.sum()) for s in self.traced)
        a, b = (c.sum(0).cpu() for c in self.plastic_counts)
        d = (b - a).tolist()
        return {"synapses_per_window": self.traced_synapses / windows,
                "delivered_per_window": events / windows,
                "plastic_updates_per_window": d[0] / windows,
                "archive_reads_per_window": d[4] / windows,
                "spikes_per_window": sum(int(s.spikes.sum())
                                         for s in self.traced) / windows}


def to_reference(carry) -> rstdp.Carry:
    """A copy of the program's carry as the reference's types."""
    cl = lambda x: x.clone()
    st, link, ps = carry.state, carry.link, carry.plastic
    state = rsim.ShardState(rstdp.AlphaState(*map(cl, st.neuron)),
                            cl(st.ring_exc), cl(st.ring_inh), cl(st.t))
    bank = rfc.CreditBank(*map(cl, link.bank))
    fab = rbase.FabricState(bank, *(
        None if getattr(link, f) is None else cl(getattr(link, f))
        for f in rbase.FabricState._fields[1:]))
    plastic = rstdp.PlasticState(cl(ps.weights), cl(ps.kplus),
                                 cl(ps.t_last),
                                 rstdp.PostArchive(*map(cl, ps.archive)),
                                 cl(ps.counts))
    from gpubench.reference import sparse_simulator as rsparse
    return rstdp.Carry(state, rsparse.SourcePendingWindow(
        *map(cl, carry.pending)), fab, plastic)


def stdp_reference(cell, inputs: Inputs, device, precision: str):
    """The reference in ``precision`` (``"f32"``, or the control
    ``"static"``: plasticity off) over the partition it works out from the
    source table; made once, on the first call, after which the table is
    freed."""
    if not hasattr(inputs, "net"):
        inputs.net = rstdp.partition(
            inputs.sources, torch.from_numpy(inputs.is_inh).to(device),
            cell.config["n_shards"], inputs.je, inputs.ji,
            inputs.delay_steps)
        del inputs.sources
    return rstdp.StdpWindow(mc.sim_fields(cell), inputs.net,
                            rstdp.AlphaParams(**cell.config["lif"]),
                            rstdp.StdpParams(**cell.config["stdp"]),
                            precision)


STDP = mc.Parts(Inputs, Program, stdp_reference, to_reference, "static")


def run(cell, **kw) -> dict:
    """``run_network`` with these parts; a traced run's sizes gain the
    traced segments' work a window."""
    made = []

    def program(*a):
        made.append(Program(*a))
        return made[-1]
    out = mc.run_network(STDP._replace(program=program), cell, **kw)
    if out["ctx"] is not None:
        out["ctx"].sizes.update(made[0].traced_sizes())
    return out
