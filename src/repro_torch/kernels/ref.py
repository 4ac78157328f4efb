"""Plain-torch oracles for every kernel (port of
``src/repro/kernels/ref.py``): small, obviously correct implementations
that the kernel tests sweep against, independent of ``core.aggregator``."""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.core.routing import lookup
from repro_torch.kernels.ssd_chunk import ssd_chunk_plain
from repro_torch.snn import lif as lif_mod
from repro_torch.snn.lif import LIFParams, LIFState


def bucket_scatter_ref(words, dests, guids, n_dest: int, capacity: int):
    """O(N * D * C) binning of one window, window order, capacity-clipped
    -> (data (D, C), guids (D, C), raw counts (D,)), all int32."""
    d_ids = torch.arange(n_dest, device=words.device)
    mask = dests[None, :] == d_ids[:, None]                 # (D, N)
    mask_i = mask.to(torch.int32)
    pos = torch.cumsum(mask_i, dim=1) - mask_i              # exclusive
    onehot = mask[:, :, None] & (
        pos[:, :, None] == torch.arange(capacity, device=words.device))
    zero = torch.zeros((), dtype=torch.int32, device=words.device)
    data = torch.where(onehot, words[None, :, None], zero).sum(
        1, dtype=torch.int32)
    gout = torch.where(onehot, guids[None, :, None], zero).sum(
        1, dtype=torch.int32)
    return data, gout, mask_i.sum(1, dtype=torch.int32)


def fused_route_aggregate_ref(words, dest_lut, guid_lut, n_dest: int,
                              capacity: int):
    """Oracle of the fused route+aggregate window: the clamped-index LUT
    semantics of ``RoutingTables.route``, then :func:`bucket_scatter_ref`."""
    idx = torch.clamp(ev.address(words), max=dest_lut.shape[0] - 1)
    dest = lookup(dest_lut, idx)
    guid = lookup(guid_lut, idx).to(torch.int32)
    valid = ev.is_valid(words) & (dest >= 0) & (dest < n_dest)
    dm = torch.where(valid, dest, -1)
    wm = torch.where(valid, words, 0)
    return bucket_scatter_ref(wm, dm, guid, n_dest, capacity)


def lif_step_ref(state: LIFState, p: LIFParams, exc_in, inh_in, i_ext):
    """The SNN substrate's own step function is the oracle."""
    st, spk = lif_mod.step(state, p, exc_in, inh_in, i_ext)
    return st, spk.to(torch.int32)


ssd_chunk_ref = ssd_chunk_plain
