"""The Potjans & Diesmann (2014) cortical microcircuit's connectivity rule
(Cerebral Cortex 24(3):785-806, Tables 4-5; the benchmark's copy of the
rule in the port's ``snn/microcircuit.py``), drawn on the device.

Eight populations over four layers; ``scale`` shrinks the neuron counts and
keeps the connection probabilities and weights.  The dense (N, N) weight
matrix [pA] (target row, source column) is drawn in one pass per target
population from a ``torch.Generator`` seeded with the run's seed: a
uniform for the connection mask and a normal for the weight (mean 87.8 pA,
x -4 from inhibitory sources, the L4E -> L23E projection doubled, relative
s.d. 0.1).  The rule's original draws numpy variates on the host; the
distribution is the same, the draws are not.
"""
from __future__ import annotations

import numpy as np
import torch

POPULATIONS = ("L23E", "L23I", "L4E", "L4I", "L5E", "L5I", "L6E", "L6I")
FULL_SIZES = np.array([20683, 5834, 21915, 5479, 4850, 1065, 14395, 2948])
CONN_PROB = np.array([
    [0.1009, 0.1689, 0.0437, 0.0818, 0.0323, 0.0000, 0.0076, 0.0000],
    [0.1346, 0.1371, 0.0316, 0.0515, 0.0755, 0.0000, 0.0042, 0.0000],
    [0.0077, 0.0059, 0.0497, 0.1350, 0.0067, 0.0003, 0.0453, 0.0000],
    [0.0691, 0.0029, 0.0794, 0.1597, 0.0033, 0.0000, 0.1057, 0.0000],
    [0.1004, 0.0622, 0.0505, 0.0057, 0.0831, 0.3726, 0.0204, 0.0000],
    [0.0548, 0.0269, 0.0257, 0.0022, 0.0600, 0.3158, 0.0086, 0.0000],
    [0.0156, 0.0066, 0.0211, 0.0166, 0.0572, 0.0197, 0.0396, 0.2252],
    [0.0364, 0.0010, 0.0034, 0.0005, 0.0277, 0.0080, 0.0658, 0.1443],
])
BG_INDEGREE = np.array([1600, 1500, 2100, 1900, 2000, 1900, 2900, 2100])
BG_RATE_HZ = 8.0
W_EXC_PA = 87.8
W_REL_SD = 0.1
G_INH = -4.0
W_L4E_L23E = 2.0


def sizes(scale: float) -> np.ndarray:
    return np.maximum((FULL_SIZES * scale).astype(int), 4)


def population_of(scale: float) -> np.ndarray:
    return np.repeat(np.arange(len(POPULATIONS)), sizes(scale))


def is_inhibitory(scale: float) -> np.ndarray:
    return np.array([p.endswith("I") for p in POPULATIONS])[
        population_of(scale)]


def bg_rates(scale: float) -> np.ndarray:
    """Per-neuron background Poisson rate [Hz] (in-degree x 8 Hz)."""
    return np.repeat(BG_INDEGREE * BG_RATE_HZ, sizes(scale)).astype(
        np.float32)


def weights(scale: float, generator: torch.Generator) -> torch.Tensor:
    """(N, N) float32 weights on the generator's device."""
    dev = generator.device
    sz = sizes(scale)
    pop = torch.from_numpy(population_of(scale)).to(dev)
    n = int(sz.sum())
    inh_src = torch.from_numpy(is_inhibitory(scale)).to(dev)
    w = torch.empty((n, n), dtype=torch.float32, device=dev)
    lo = 0
    for i, rows in enumerate(sz):
        p = torch.from_numpy(CONN_PROB[i]).to(dev, torch.float32)[pop]
        base = torch.where(inh_src, W_EXC_PA * G_INH, W_EXC_PA)
        if i == 0:
            base = torch.where(pop == 2, base * W_L4E_L23E, base)
        u = torch.rand((int(rows), n), generator=generator, device=dev)
        z = torch.randn((int(rows), n), generator=generator, device=dev)
        w[lo:lo + rows] = torch.where(u < p, base + base.abs() * W_REL_SD * z,
                                      0.0)
        lo += int(rows)
    return w
