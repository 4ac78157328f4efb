"""Per-destination bucket binning in window order (port of
``src/repro/kernels/bucket_scatter.py``), kernel D.

:func:`bucket_scatter` launches the hand-written kernel
``csrc/bucket_scatter.cu`` on CUDA tensors and runs
:func:`bucket_scatter_plain` on CPU tensors.  It is the legacy one-hot
binning kept as an independent cross-check of the sort-based aggregation
(``kernels.ops.bucket_scatter``): for each destination, the matching events
take the row's slots in window order up to the capacity, and the counts
are the raw, pre-clip counts.  Leading batch axes (the shard axis) run in
one launch: one thread-block cluster per window ranks and places it in a
single pass (``csrc/dest_rank.cuh``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import dispatch

MAX_BATCH = 65535          # the kernel's batch rows are grid.y


def bucket_scatter_plain(words, dests, guids, n_dest: int, capacity: int):
    """Plain PyTorch version: words, dests, guids (..., N) int32 (dest -1
    drops the event) -> data, guids (..., D, C) int32 and raw counts
    (..., D) int32.  The slot of each event is the exclusive prefix count
    of its destination's mask."""
    d_ids = torch.arange(n_dest, dtype=torch.int32, device=words.device)
    mask = dests[..., None, :] == d_ids[:, None]               # (..., D, N)
    mi = mask.to(torch.int32)
    pos = torch.cumsum(mi, dim=-1, dtype=torch.int32) - mi
    slot = torch.where(mask & (pos < capacity), pos, capacity).long()
    shape = mask.shape[:-1] + (capacity + 1,)

    def place(values):       # the spare column takes every dropped event
        src = values[..., None, :].expand(mask.shape).contiguous()
        out = torch.zeros(shape, dtype=torch.int32, device=words.device)
        return out.scatter_(-1, slot, src)[..., :capacity]

    return place(words), place(guids), mi.sum(-1, dtype=torch.int32)


def bucket_scatter(words, dests, guids, n_dest: int, capacity: int):
    """Kernel D on CUDA tensors, the plain version on CPU tensors (same
    arguments and results as :func:`bucket_scatter_plain`)."""
    if not dispatch.on_cuda(words, dests, guids):
        return bucket_scatter_plain(words, dests, guids, n_dest, capacity)
    shape = words.shape
    for name, t in (("words", words), ("dests", dests), ("guids", guids)):
        if t.dtype != torch.int32 or t.shape != shape or \
                not t.is_contiguous():
            raise ValueError(f"bucket_scatter: {name} must be a contiguous "
                             f"int32 tensor of shape {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    batch = math.prod(shape[:-1])
    from repro_torch.kernels import _build
    longest = _build.max_window(n_dest, 3)      # key, word, guid per event
    if batch > MAX_BATCH or n_dest > _build.MAX_DEST or \
            shape[-1] > longest or n_dest * capacity >= 2**31:
        raise ValueError(f"bucket_scatter: {batch} rows of {shape[-1]} "
                         f"events to {n_dest} destinations of {capacity} "
                         f"slots; the kernel takes at most {MAX_BATCH} rows "
                         f"of {longest} events, {_build.MAX_DEST} "
                         f"destinations and 2^31 slots a row")
    data = torch.empty(shape[:-1] + (n_dest, capacity), dtype=torch.int32,
                       device=words.device)
    gout = torch.empty_like(data)
    counts = torch.empty(shape[:-1] + (n_dest,), dtype=torch.int32,
                         device=words.device)
    if batch and n_dest:
        dispatch.launch("bucket_scatter", "repro_bucket_scatter",
                        words.data_ptr(), dests.data_ptr(), guids.data_ptr(),
                        data.data_ptr(), gout.data_ptr(), counts.data_ptr(),
                        batch, shape[-1], n_dest, capacity)
    return data, gout, counts
