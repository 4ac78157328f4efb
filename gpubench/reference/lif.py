"""Leaky integrate-and-fire dynamics, plain PyTorch (frozen from the
port's ``snn/lif.py`` and ``kernels/lif_step.py``'s plain window).

NEST's ``iaf_psc_exp`` with separate excitatory/inhibitory currents, exact
exponential integration per dt step and an absolute refractory countdown.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch



class LIFParams(NamedTuple):
    """Potjans-Diesmann defaults (mV, ms, pA, pF)."""

    tau_m: float = 10.0
    tau_syn: float = 0.5
    c_m: float = 250.0
    e_l: float = -65.0
    v_th: float = -50.0
    v_reset: float = -65.0
    t_ref: float = 2.0
    dt: float = 0.1


class LIFState(NamedTuple):
    v: torch.Tensor         # membrane potential [mV] f32
    i_exc: torch.Tensor     # excitatory synaptic current [pA] f32
    i_inh: torch.Tensor     # inhibitory synaptic current [pA] f32
    refrac: torch.Tensor    # remaining refractory steps int32


def init_state(v: torch.Tensor) -> LIFState:
    """Potentials ``v`` [mV], no synaptic current, nothing refractory."""
    z = torch.zeros_like(v)
    return LIFState(v, z, z.clone(),
                    torch.zeros(v.shape, dtype=torch.int32, device=v.device))


@functools.lru_cache(maxsize=None)
def propagators(p: LIFParams):
    """Exact-integration constants for one dt step, rounded to f32 as the
    reference computes them -> (pm, ps, pv, ref_steps, tau_c) where tau_c
    scales the external current."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    pm = torch.exp(f32(-p.dt / p.tau_m))
    ps = torch.exp(f32(-p.dt / p.tau_syn))
    tau_r = p.tau_syn * p.tau_m / (p.tau_m - p.tau_syn)
    pv = f32(tau_r / p.c_m) * (pm - ps)
    tau_c = f32(p.tau_m / p.c_m) * (1.0 - pm)
    return (pm.item(), ps.item(), pv.item(), int(round(p.t_ref / p.dt)),
            tau_c.item())


def step(state: LIFState, p: LIFParams, exc_in: torch.Tensor,
         inh_in: torch.Tensor, i_ext: float | torch.Tensor = 0.0):
    """One dt of exact-integration LIF -> (state, spikes bool).

    Every operation rounds to f32 in this order (the CUDA kernel repeats
    it with ``__fmul_rn`` / ``__fadd_rn``)."""
    pm, ps, pv, ref_steps, tau_c = propagators(p)
    # f32 product tau_c * i_ext, as the kernel computes it
    ext = (float(np.float32(tau_c) * np.float32(i_ext))
           if isinstance(i_ext, (int, float)) else i_ext * tau_c)
    active = state.refrac <= 0
    i_tot = state.i_exc + state.i_inh
    v = torch.where(active, p.e_l + (state.v - p.e_l) * pm + pv * i_tot
                    + ext, state.v)
    i_exc = state.i_exc * ps + exc_in
    i_inh = state.i_inh * ps + inh_in
    spikes = active & (v >= p.v_th)
    v = torch.where(spikes, torch.full_like(v, p.v_reset), v)
    refrac = torch.where(spikes, torch.full_like(state.refrac, ref_steps),
                         torch.clamp(state.refrac - 1, min=0))
    return LIFState(v, i_exc, i_inh, refrac), spikes


def window(neuron: LIFState, p: LIFParams, ring_exc: torch.Tensor,
           ring_inh: torch.Tensor, t0: int, drive: torch.Tensor):
    """``drive.shape[0]`` steps off the delay rings, the consumed slots
    cleared in place -> (neuron, spikes (..., n_steps, per) bool)."""
    ring_len = ring_exc.shape[0]
    spikes = []
    for k in range(drive.shape[0]):
        slot = (t0 + k) % ring_len
        neuron, spk = step(neuron, p, ring_exc[slot] + drive[k],
                           ring_inh[slot])
        ring_exc[slot].zero_()
        ring_inh[slot].zero_()
        spikes.append(spk)
    return neuron, torch.stack(spikes, dim=-2)
