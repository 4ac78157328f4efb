"""Public wrappers around the hand-written kernels (port of
``src/repro/kernels/ops.py``).  Each launches its CUDA kernel for CUDA
tensors and runs the plain PyTorch version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.core.aggregator import Buckets
from repro_torch.kernels.bucket_scatter import bucket_scatter as _scatter


def bucket_scatter(words, dests, guids, n_dest: int,
                   capacity: int) -> Buckets:
    """Legacy one-hot binning (kernel D), kept as an independent
    cross-check of the aggregation: invalid words and out-of-range
    destinations are dropped, counts clipped to the capacity."""
    valid = ev.is_valid(words) & (dests >= 0) & (dests < n_dest)
    dests_m = torch.where(valid, dests, -1).to(torch.int32).contiguous()
    data, gout, raw = _scatter(words.to(torch.int32).contiguous(), dests_m,
                               guids.to(torch.int32).contiguous(), n_dest,
                               capacity)
    accepted = torch.clamp(raw, max=capacity)
    return Buckets(data, gout, accepted,
                   (raw - accepted).sum(-1, dtype=torch.int32))


def fused_scatter(words, dests, guids, n_dest: int,
                  capacity: int) -> Buckets:
    """Drop-in for ``core.aggregator.aggregate(impl="pallas")``: the
    buckets of the flush-window kernel A."""
    from repro_torch.kernels import fused_route_bucket as frb
    return frb.flush_window(words, n_dest, capacity, dest=dests,
                            meta=guids).buckets


def ssd_chunk(x, dt, A, B, C, s_prev):
    """One Mamba-2 SSD chunk (kernel E; f32 outputs)."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk as _ssd
    return _ssd(x, dt, A, B, C, s_prev)


def lif_step(state, params, exc_in, inh_in, i_ext=0.0):
    """Fused LIF step (kernel C); the kernel covers ragged sizes itself,
    so nothing is padded."""
    from repro_torch.kernels.lif_step import lif_step as _lif
    return _lif(state, params, exc_in, inh_in, i_ext)
