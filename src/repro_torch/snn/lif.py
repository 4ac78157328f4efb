"""Leaky integrate-and-fire dynamics (port of ``src/repro/snn/lif.py``).

NEST's ``iaf_psc_exp`` with separate excitatory/inhibitory currents, exact
exponential integration per dt step and an absolute refractory countdown.
:func:`step` is the plain PyTorch version; the simulator runs the same
update through the CUDA kernel of ``repro_torch.kernels.lif_step``, which
follows this function's operation order so the two agree bit for bit.

NEST's ``iaf_psc_alpha`` (no reference counterpart) is the same neuron
with alpha-shaped currents: :class:`AlphaParams` selects it, its state is
an :class:`AlphaState` (a current and its derivative per synapse type),
:func:`alpha_step` its plain step, whose order the kernel's alpha form
repeats.  :func:`alpha_step` also keeps, when given one, the neurons'
post-spike archive for spike-timing-dependent plasticity
(:class:`PostArchive`).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import dispatch


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


def init_state(shape, p: LIFParams, *, generator: torch.Generator | None
               = None, device=None) -> LIFState:
    """Resting state, or potentials drawn uniformly in [e_l, v_th) from
    ``generator`` (randomized starts avoid startup synchrony)."""
    device = dispatch.resolve_device(device)
    if generator is None:
        v = torch.full(shape, p.e_l, dtype=torch.float32, device=device)
    else:
        u = torch.rand(shape, generator=generator, device=device)
        v = p.e_l + (p.v_th - p.e_l) * u
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return LIFState(v, z, z.clone(),
                    torch.zeros(shape, dtype=torch.int32, device=device))


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


class AlphaParams(NamedTuple):
    """``iaf_psc_alpha`` (mV, ms, pA, pF); the defaults are NEST's HPC
    benchmark's (``snn/hpc_benchmark.py``)."""

    tau_m: float = 10.0
    tau_syn: float = 0.32582722403722841
    c_m: float = 250.0
    e_l: float = 0.0
    v_th: float = 20.0
    v_reset: float = 0.0
    t_ref: float = 0.5
    dt: float = 0.1


class AlphaState(NamedTuple):
    v: torch.Tensor         # membrane potential [mV] f32
    di_exc: torch.Tensor    # derivative of the excitatory current [pA/ms]
    i_exc: torch.Tensor     # excitatory synaptic current [pA]
    di_inh: torch.Tensor    # derivative of the inhibitory current [pA/ms]
    i_inh: torch.Tensor     # inhibitory synaptic current [pA]
    refrac: torch.Tensor    # remaining refractory steps int32


class PostArchive(NamedTuple):
    """Each neuron's last ``H`` spikes, a ring: entry ``n % H`` is its
    n-th spike's step and the depression trace K- just after it (the
    previous spike's K- decayed to it, plus 1); ``count`` its spikes so
    far, so entries ``count - H`` on have been overwritten."""

    step: torch.Tensor      # (..., per, H) int32 global step
    kminus: torch.Tensor    # (..., per, H) f32
    count: torch.Tensor     # (..., per) int32


DECAY_STEPS = 1 << 15
"""Length of a trace's decay table: e^{-k dt / tau} for k below it, f32
(zero from about k = 31,000 at tau 30 ms); longer differences take its
last entry, 0."""


@functools.lru_cache(maxsize=None)
def _decay_table(dt: float, tau: float) -> torch.Tensor:
    return torch.exp(torch.arange(DECAY_STEPS, dtype=torch.float64)
                     * (-dt / tau)).to(torch.float32)


def decay_table(dt: float, tau: float, device=None) -> torch.Tensor:
    """(``DECAY_STEPS``,) f32 e^{-k dt / tau}, computed in float64 on the
    CPU and rounded once; indexed by a step difference, clamped."""
    return _decay_table(float(dt), float(tau)).to(device)


def init_alpha_state(v: torch.Tensor) -> AlphaState:
    """Potentials ``v`` [mV], no current, nothing refractory."""
    z = torch.zeros_like(v)
    return AlphaState(v, z, z.clone(), z.clone(), z.clone(),
                      torch.zeros(v.shape, dtype=torch.int32,
                                  device=v.device))


def init_archive(shape, history: int, device=None) -> PostArchive:
    """An empty archive of ``history`` entries for neurons of ``shape``."""
    return PostArchive(
        torch.zeros(tuple(shape) + (history,), dtype=torch.int32,
                    device=device),
        torch.zeros(tuple(shape) + (history,), dtype=torch.float32,
                    device=device),
        torch.zeros(tuple(shape), dtype=torch.int32, device=device))


def _f32(x: float) -> float:
    return float(np.float32(x))


@functools.lru_cache(maxsize=None)
def alpha_propagators(p: AlphaParams):
    """Exact-integration constants of ``iaf_psc_alpha`` for one dt step,
    computed in float64 and each rounded to f32 once -> (p11, p21, p31,
    p32, p33, psc_init, ref_steps): with a = 1/tau_syn, b = 1/tau_m, c =
    a - b, h = dt, p11 = p22 = e^{-ah}, p21 = h e^{-ah}, p32 = (e^{-bh} -
    e^{-ah}) / (c C), p31 = ((e^{-bh} - e^{-ah}) / c^2 - h e^{-ah} / c) /
    C, p33 = e^{-bh}, and psc_init = e / tau_syn scales a step's input
    into the current's derivative (a unit weight peaks at 1 pA)."""
    h, a, b = p.dt, 1.0 / p.tau_syn, 1.0 / p.tau_m
    c = a - b
    ea, eb = math.exp(-a * h), math.exp(-b * h)
    p32 = (eb - ea) / (c * p.c_m)
    p31 = ((eb - ea) / (c * c) - h * ea / c) / p.c_m
    return (_f32(ea), _f32(h * ea), _f32(p31), _f32(p32), _f32(eb),
            _f32(math.e / p.tau_syn), int(round(p.t_ref / p.dt)))


def alpha_step(state: AlphaState, p: AlphaParams, exc_in: torch.Tensor,
               inh_in: torch.Tensor, t=None, archive: PostArchive | None
               = None, minus_table: torch.Tensor | None = None):
    """One dt of ``iaf_psc_alpha`` -> (state, spikes bool), in NEST's
    order and rounding every operation to f32 as the kernel does: when
    not refractory, u = v - e_l becomes p33 u + p31 dI_e + p32 I_e + p31
    dI_i + p32 I_i (left to right) and v = e_l + u; then each current I =
    p21 dI + p22 I and dI = p11 dI + psc_init x input; then the threshold
    test, the reset and the refractory countdown.

    With an ``archive`` (updated in place) each spike of the step ``t``
    (an int) is appended, its K- the newest entry's times
    ``minus_table[t - step]`` (clamped) plus 1, or 1 for a first spike."""
    p11, p21, p31, p32, p33, psc, ref_steps = alpha_propagators(p)
    active = state.refrac <= 0
    u = state.v - p.e_l
    u = (p33 * u + p31 * state.di_exc + p32 * state.i_exc
         + p31 * state.di_inh + p32 * state.i_inh)
    v = torch.where(active, p.e_l + u, state.v)
    i_exc = p21 * state.di_exc + p11 * state.i_exc
    di_exc = p11 * state.di_exc + psc * exc_in
    i_inh = p21 * state.di_inh + p11 * state.i_inh
    di_inh = p11 * state.di_inh + psc * inh_in
    spikes = active & (v >= p.v_th)
    v = torch.where(spikes, torch.full_like(v, p.v_reset), v)
    refrac = torch.where(spikes, torch.full_like(state.refrac, ref_steps),
                         torch.clamp(state.refrac - 1, min=0))
    if archive is not None:
        append_spikes(archive, spikes, t, minus_table)
    return AlphaState(v, di_exc, i_exc, di_inh, i_inh, refrac), spikes


def append_spikes(archive: PostArchive, spikes: torch.Tensor, t: int,
                  minus_table: torch.Tensor) -> None:
    """Append the step ``t``'s ``spikes`` to ``archive`` in place."""
    H = archive.step.shape[-1]
    n = archive.count.long()
    newest = ((n - 1) % H)[..., None]
    prev_step = torch.gather(archive.step, -1, newest)[..., 0]
    prev_km = torch.gather(archive.kminus, -1, newest)[..., 0]
    gap = torch.clamp(t - prev_step.long(), 0, minus_table.numel() - 1)
    km = torch.where(n > 0, prev_km * minus_table[gap] + 1.0,
                     torch.ones_like(prev_km))
    at = (n % H)[..., None]
    archive.step.scatter_(-1, at, torch.where(
        spikes, torch.full_like(prev_step, t), torch.gather(
            archive.step, -1, at)[..., 0])[..., None])
    archive.kminus.scatter_(-1, at, torch.where(
        spikes, km, torch.gather(archive.kminus, -1, at)[..., 0])[..., None])
    archive.count.add_(spikes.to(torch.int32))


def poisson_input(rate_hz: torch.Tensor, weight: float, dt_ms: float, *,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Background drive: Poisson spike count x weight per step (pA)."""
    lam = rate_hz * (dt_ms * 1e-3)
    return torch.poisson(lam, generator=generator) * weight
