"""Potjans-Diesmann cortical microcircuit (port of
``src/repro/snn/microcircuit.py``; numpy only, kept as the port's own copy
so the port imports nothing of the reference) — the paper's named target
workload ("One of the first multi-wafer networks will be a full scale
cortical microcircuit model" [8, 9]).

Eight populations over four layers; the standard connectivity map from
Potjans & Diesmann (2014), Table 5.  A ``scale`` parameter shrinks neuron
counts (and compensates in-degrees) so the same code runs full scale on a
wafer system and at 1e-3 scale in CPU tests.
"""
from __future__ import annotations

import dataclasses

import numpy as np

POPULATIONS = ("L23E", "L23I", "L4E", "L4I", "L5E", "L5I", "L6E", "L6I")

# full-scale neuron counts (77,169 total)
FULL_SIZES = np.array([20683, 5834, 21915, 5479, 4850, 1065, 14395, 2948])

# connection probabilities C[target, source] (Potjans & Diesmann, Table 5)
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

# background Poisson in-degrees (x 8 Hz per connection)
BG_INDEGREE = np.array([1600, 1500, 2100, 1900, 2000, 1900, 2900, 2100])
BG_RATE_HZ = 8.0

W_EXC_PA = 87.8          # mean excitatory PSC amplitude
W_REL_SD = 0.1
G_INH = -4.0             # inhibitory weight ratio
W_L4E_L23E = 2.0         # doubled L4E -> L23E projection
DELAY_EXC_MS = 1.5
DELAY_INH_MS = 0.75


@dataclasses.dataclass(frozen=True)
class MicrocircuitSpec:
    scale: float = 1.0
    seed: int = 42

    @property
    def sizes(self) -> np.ndarray:
        return np.maximum((FULL_SIZES * self.scale).astype(int), 4)

    @property
    def n_neurons(self) -> int:
        return int(self.sizes.sum())

    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.sizes)])

    def weight_matrix(self) -> tuple[np.ndarray, np.ndarray]:
        """Dense (N, N) weight [pA] + delay-is-inhibitory masks.

        At reduced scale, connection probability is kept and weights are NOT
        rescaled (we test communication, not dynamics fidelity); the full
        wafer system realizes the same spec sparsely.
        Returns (weights, is_inh_source).
        """
        rng = np.random.default_rng(self.seed)
        sizes = self.sizes
        off = self.offsets()
        n = self.n_neurons
        w = np.zeros((n, n), np.float32)
        is_inh = np.zeros((n,), bool)
        for j, src in enumerate(POPULATIONS):
            inh = src.endswith("I")
            is_inh[off[j]:off[j + 1]] = inh
            for i, _tgt in enumerate(POPULATIONS):
                p = CONN_PROB[i, j]
                if p <= 0:
                    continue
                mask = rng.random((sizes[i], sizes[j])) < p
                base = W_EXC_PA * (G_INH if inh else 1.0)
                if i == 0 and j == 2:        # L4E -> L23E doubled
                    base = base * W_L4E_L23E
                ww = rng.normal(base, abs(base) * W_REL_SD,
                                (sizes[i], sizes[j])).astype(np.float32)
                w[off[i]:off[i + 1], off[j]:off[j + 1]] = np.where(mask, ww, 0.0)
        return w, is_inh

    def synapses(self, chunk_rows: int = 2048
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """The same rule drawn sparsely: a Bernoulli draw per (target,
        source) pair with the population pair's probability and, for each
        synapse drawn, a normal weight as in :meth:`weight_matrix`, in
        chunks of ``chunk_rows`` target rows, so no (N, N) array exists.
        Its own stream of the spec's seed: the same distribution as the
        dense draw, not the same draws.  Returns COO arrays (source id
        int32, target id int32, weight f32 [pA]; by chunk of target rows)
        and the inhibitory-source flags."""
        rng = np.random.default_rng(self.seed)
        sizes, off = self.sizes, self.offsets()
        is_inh = np.repeat([p.endswith("I") for p in POPULATIONS], sizes)
        srcs, tgts, ws = [], [], []
        for i in range(len(POPULATIONS)):
            for r0 in range(0, sizes[i], chunk_rows):
                rows = min(chunk_rows, sizes[i] - r0)
                for j, src in enumerate(POPULATIONS):
                    p = CONN_PROB[i, j]
                    if p <= 0:
                        continue
                    base = W_EXC_PA * (G_INH if src.endswith("I") else 1.0)
                    if i == 0 and j == 2:        # L4E -> L23E doubled
                        base = base * W_L4E_L23E
                    ti, sj = np.nonzero(rng.random((rows, sizes[j]),
                                                   dtype=np.float32) < p)
                    srcs.append((off[j] + sj).astype(np.int32))
                    tgts.append((off[i] + r0 + ti).astype(np.int32))
                    ws.append(rng.normal(base, abs(base) * W_REL_SD,
                                         len(ti)).astype(np.float32))
        return (np.concatenate(srcs), np.concatenate(tgts),
                np.concatenate(ws), is_inh)

    def bg_rates(self) -> np.ndarray:
        """Per-neuron background Poisson rate [Hz]."""
        sizes = self.sizes
        return np.repeat(BG_INDEGREE * BG_RATE_HZ, sizes).astype(np.float32)

    def population_of(self) -> np.ndarray:
        return np.repeat(np.arange(8), self.sizes)
