"""The Potjans & Diesmann (2014) microcircuit's connectivity rule drawn
sparsely on the device (``pd_connectivity``'s rule and constants): for
each target population, in chunks of target rows, a uniform per (target,
source) pair against the population pair's connection probability and,
for each synapse drawn, a normal for its weight (mean 87.8 pA, x -4 from
inhibitory sources, the L4E -> L23E projection doubled, relative s.d.
0.1).  No (N, N) array exists: at full scale the draw makes ~285 M
synapses as COO arrays (int32 source and target ids, f32 weights), 3.4 GB.
"""
from __future__ import annotations

import torch

from gpubench.inputs import pd_connectivity as pd

CHUNK_ROWS = 4096


def synapses(scale: float, generator: torch.Generator,
             chunk_rows: int = CHUNK_ROWS):
    """-> (source int32, target int32, weight f32) on the generator's
    device, target-major."""
    dev = generator.device
    sz = pd.sizes(scale)
    n = int(sz.sum())
    pop = torch.from_numpy(pd.population_of(scale)).to(dev)
    inh_src = torch.from_numpy(pd.is_inhibitory(scale)).to(dev)
    srcs, tgts, ws = [], [], []
    lo = 0
    for i, rows in enumerate(sz):
        p = torch.from_numpy(pd.CONN_PROB[i]).to(dev, torch.float32)[pop]
        base = torch.where(inh_src, pd.W_EXC_PA * pd.G_INH, pd.W_EXC_PA)
        if i == 0:
            base = torch.where(pop == 2, base * pd.W_L4E_L23E, base)
        for r0 in range(0, int(rows), chunk_rows):
            r = min(chunk_rows, int(rows) - r0)
            u = torch.rand((r, n), generator=generator, device=dev)
            ti, sj = torch.nonzero(u < p, as_tuple=True)
            del u
            z = torch.randn((ti.numel(),), generator=generator, device=dev)
            b = base[sj]
            ws.append(b + b.abs() * pd.W_REL_SD * z)
            srcs.append(sj.to(torch.int32))
            tgts.append((ti + lo + r0).to(torch.int32))
        lo += int(rows)
    return torch.cat(srcs), torch.cat(tgts), torch.cat(ws)
