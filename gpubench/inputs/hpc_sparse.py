"""NEST's HPC benchmark connectivity drawn on the device from the run's
seed: each target's fixed in-degree, CE excitatory and CI inhibitory
sources drawn uniformly from their populations, the target itself left
out (no autapses), repeats allowed (multapses).  Kept as one (N, CE + CI)
int32 table of sources, target-major in draw order (4.05 GB at scale 8);
no target column, no weights (a source's kind fixes its weight).
"""
from __future__ import annotations

import torch

CHUNK_ROWS = 4096


def sources(n_exc: int, n_inh: int, ce: int, ci: int,
            generator: torch.Generator, chunk_rows: int = CHUNK_ROWS):
    """-> (N, ce + ci) int32 on the generator's device."""
    dev = generator.device
    n = n_exc + n_inh
    table = torch.empty((n, ce + ci), dtype=torch.int32, device=dev)
    for r0 in range(0, n, chunk_rows):
        r1 = min(r0 + chunk_rows, n)
        tgt = torch.arange(r0, r1, device=dev)
        for lo, size, k, col in ((0, n_exc, ce, 0), (n_exc, n_inh, ci, ce)):
            mine = (tgt >= lo) & (tgt < lo + size)
            pool = (size - mine.long())[:, None]           # candidates
            pick = torch.randint(0, 1 << 62, (r1 - r0, k), generator=generator,
                                 device=dev) % pool
            pick = pick + (mine[:, None] & (pick >= (tgt - lo)[:, None]))
            table[r0:r1, col:col + k] = (lo + pick).to(torch.int32)
    return table
