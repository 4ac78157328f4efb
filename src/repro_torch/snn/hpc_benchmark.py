"""NEST's HPC benchmark network (``pynest/examples/hpc_benchmark.py``;
Kunkel et al. 2014, Front. Neuroinform. 8:78), the field's standard test
of spike exchange between compute nodes: a balanced random network of
``iaf_psc_alpha`` neurons with fixed in-degrees (multapses allowed,
autapses not), every delay 1.5 ms, a Poisson drive per neuron, and
plastic E->E synapses (``stdp_pl_synapse_hom``, ``snn/stdp.py``).

:class:`HpcSpec` holds the script's values at a ``scale`` (NE = 9,000 x
scale, NI = 2,250 x scale; the in-degrees CE = 9,000 and CI = 2,250 at
every scale), its weight conversion (:func:`convert_synapse_weight`: the
PSC amplitude whose PSP peaks at JE mV), the drive's rate, and
:meth:`HpcSpec.draw_sources`, the fixed in-degree draw on the device from
a generator, in chunks of target rows.  The draw is this module's own;
the benchmark's inputs draw theirs (``gpubench/inputs/hpc_sparse.py``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.snn import lif, stdp

NE_UNIT = 9000               # excitatory neurons at scale 1
NI_UNIT = 2250
CE = 9000                    # excitatory in-degree, every scale
CI = 2250
JE_MV = 0.14                 # PSP peak of an excitatory synapse [mV]
G = -5.0                     # JI = G * JE
ETA = 1.685                  # drive over the threshold rate
DELAY_MS = 1.5
V0_MEAN, V0_SD = 5.7, 7.2    # initial V_m ~ N(mean, sd) [mV]
PARAMS = lif.AlphaParams()   # the script's neuron
STDP = stdp.StdpParams(      # the script's rule, d = the whole delay
    lam=0.1, alpha=0.0513, mu=0.4, tau_plus=15.0, tau_minus=30.0,
    delay_steps=round(DELAY_MS / PARAMS.dt), history=256)


def _lambertw_m1(x: float) -> float:
    """The lower branch W_{-1}(x) for -1/e < x < 0, by Halley's method."""
    w = math.log(-x) - math.log(-math.log(-x))
    for _ in range(64):
        e = math.exp(w)
        f = w * e - x
        w_new = w - f / (e * (w + 1) - (w + 2) * f / (2 * w + 2))
        if abs(w_new - w) <= 1e-15 * abs(w):
            return w_new
        w = w_new
    return w


def t_rise(p: lif.AlphaParams = PARAMS) -> float:
    """Time [ms] of an alpha PSP's peak after its input, at rest."""
    a = p.tau_m / p.tau_syn
    b = 1.0 / p.tau_syn - 1.0 / p.tau_m
    return 1.0 / b * (-_lambertw_m1(-math.exp(-1.0 / a) / a) - 1.0 / a)


def convert_synapse_weight(p: lif.AlphaParams = PARAMS) -> float:
    """The script's factor from a PSP peak [mV] to the PSC amplitude
    [pA] that gives it."""
    b = 1.0 / p.tau_syn - 1.0 / p.tau_m
    tr = t_rise(p)
    v_max = math.e / (p.tau_syn * p.c_m * b) * (
        (math.exp(-tr / p.tau_m) - math.exp(-tr / p.tau_syn)) / b
        - tr * math.exp(-tr / p.tau_syn))
    return 1.0 / v_max


@dataclasses.dataclass(frozen=True)
class HpcSpec:
    scale: float = 1.0

    @property
    def n_exc(self) -> int:
        return int(round(NE_UNIT * self.scale))

    @property
    def n_inh(self) -> int:
        return int(round(NI_UNIT * self.scale))

    @property
    def n_neurons(self) -> int:
        return self.n_exc + self.n_inh

    @property
    def je_pa(self) -> float:
        return JE_MV * convert_synapse_weight()

    @property
    def ji_pa(self) -> float:
        return G * self.je_pa

    def drive_rate_hz(self) -> float:
        """eta x nu_th x CE x 1000 Hz, nu_th = V_th / (CE tau_m / C_m JE_pA
        e tau_syn) [1/ms]."""
        p = PARAMS
        nu_th = p.v_th / (CE * p.tau_m / p.c_m * self.je_pa * math.e
                          * p.tau_syn)
        return ETA * nu_th * CE * 1000.0

    def is_inh(self) -> np.ndarray:
        return np.arange(self.n_neurons) >= self.n_exc

    def draw_sources(self, generator: torch.Generator, chunk_rows: int = 4096,
                     ce: int = CE, ci: int = CI) -> torch.Tensor:
        """(N, ce + ci) int32 on the generator's device: row i the sources
        of target i, ``ce`` excitatory then ``ci`` inhibitory, each drawn
        uniformly from its population without i itself (no autapses;
        repeats allowed)."""
        dev = generator.device
        ne, n = self.n_exc, self.n_neurons
        out = torch.empty((n, ce + ci), dtype=torch.int32, device=dev)
        for r0 in range(0, n, chunk_rows):
            rows = torch.arange(r0, min(r0 + chunk_rows, n), device=dev)
            for lo, hi, k, col in ((0, ne, ce, 0), (ne, n, ci, ce)):
                own = (rows >= lo) & (rows < hi)
                m = hi - lo - own.long()              # candidates a row
                u = torch.rand((rows.numel(), k), generator=generator,
                               device=dev)
                r = torch.floor(u * m[:, None]).long()
                r = torch.minimum(r, m[:, None] - 1)
                skip = own[:, None] & (r >= (rows - lo)[:, None])
                out[r0:r0 + rows.numel(), col:col + k] = (lo + r + skip.long()).to(
                    torch.int32)
        return out
