"""The cycle-level bucket model and the ring-buffer model, kernel G.

No TPU kernel corresponds to it.  The reference replays both models with
``lax.scan``: ``src/repro/core/bucket.py:284 run_trace`` (one scan step per
FPGA clock, each a chain of E event accepts, the flush triggers and the
output port) and ``src/repro/core/flow_control.py:288 run`` (one step per
producer / consumer / delay-line tick).  Ported literally to eager
PyTorch each clock would be dozens of tiny launches with data-dependent
control flow; kernel G replays a whole trace in one launch instead.

* :func:`bucket_trace` -- ``run_trace`` from ``init_state``: one warp with
  all of the state in shared memory; the accepts stay serial (a dependent
  chain), the lanes do the argmin / free-bucket search over the buckets
  and the capacity-wide copies.  On CPU tensors it runs
  ``core.bucket.run_trace_plain``.
* :func:`ring_run` -- ``flow_control.run`` with the producer's wishes as
  input: one thread.  On CPU tensors it runs ``flow_control.run_plain``.

Both count their launches under their own names (``bucket_trace``,
``ring_run``).  Nothing falls back: a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch

MAX_SHARED = 227 * 1024    # bytes of shared memory a block may use
MAX_EVENTS = 32            # arrivals a cycle: one lane holds each's flush


def bucket_shared_bytes(cfg) -> int:
    """Shared memory of one bucket_trace launch: the map table, three
    per-bucket arrays, the storage, and the queue's two arrays and
    payloads (int32)."""
    B, C, Q = cfg.n_buckets, cfg.capacity, cfg.queue
    return 4 * (cfg.n_dest + 3 * B + B * C + 2 * Q + Q * C)


def ring_shared_bytes(cfg) -> int:
    """Shared memory of one ring_run launch: the delay line and the ring."""
    return 4 * (cfg.notify_latency + cfg.size)


def _check(name, t, shape, contiguous):
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) or (
            contiguous and not t.is_contiguous()):
        raise ValueError(f"cycle_models: {name} must be a "
                         f"{'contiguous ' if contiguous else ''}int32 "
                         f"tensor of shape {tuple(shape)}, got a "
                         f"{t.dtype} {tuple(t.shape)}")


def bucket_trace(cfg, words: torch.Tensor, dests: torch.Tensor):
    """Kernel G's bucket form on CUDA tensors, one launch; on CPU tensors
    ``core.bucket.run_trace_plain``.  ``words`` / ``dests``: (T, E) int32.
    Returns (final ``BucketState``, ``CycleOut`` with a leading T axis)."""
    from repro_torch.core import bucket
    cuda = dispatch.on_cuda(words, dests)
    if words.dim() != 2:
        raise ValueError(f"bucket_trace: words must be (T, E), got "
                         f"{tuple(words.shape)}")
    T, E = words.shape
    _check("words", words, (T, E), cuda)
    _check("dests", dests, (T, E), cuda)
    B, C, Q = cfg.n_buckets, cfg.capacity, cfg.queue
    if min(B, C, Q, cfg.n_dest) < 1 or E > MAX_EVENTS:
        raise ValueError(f"bucket_trace: {cfg} with {E} arrivals a cycle; "
                         f"the model needs >= 1 bucket, slot, queue entry "
                         f"and destination, the kernel <= {MAX_EVENTS} "
                         f"arrivals")
    if not cuda:
        return bucket.run_trace_plain(cfg, words, dests)
    smem = bucket_shared_bytes(cfg)
    if smem > MAX_SHARED:
        raise ValueError(f"bucket_trace: {cfg} needs {smem} bytes of shared "
                         f"memory, the kernel has {MAX_SHARED}")
    dev = words.device
    out_scalars = torch.empty((4, T), dtype=torch.int32, device=dev)
    out_events = torch.empty((T, C), dtype=torch.int32, device=dev)
    st = bucket.BucketState(
        map_table=torch.empty((cfg.n_dest,), dtype=torch.int32, device=dev),
        bucket_dest=torch.empty((B,), dtype=torch.int32, device=dev),
        fill=torch.empty((B,), dtype=torch.int32, device=dev),
        deadline=torch.empty((B,), dtype=torch.int32, device=dev),
        storage=torch.empty((B, C), dtype=torch.int32, device=dev),
        q_dest=torch.empty((Q,), dtype=torch.int32, device=dev),
        q_count=torch.empty((Q,), dtype=torch.int32, device=dev),
        q_events=torch.empty((Q, C), dtype=torch.int32, device=dev),
        q_len=torch.empty((), dtype=torch.int32, device=dev),
        port_busy=torch.empty((), dtype=torch.int32, device=dev),
        now=torch.empty((), dtype=torch.int32, device=dev))
    dispatch.launch(
        "bucket_trace", "repro_bucket_trace", words.data_ptr(),
        dests.data_ptr(), out_scalars.data_ptr(), out_events.data_ptr(),
        *(t.data_ptr() for t in st), T, E, cfg.n_dest, B, C, Q,
        cfg.flush_margin)
    dest, count, stalled, miss = out_scalars
    return st, bucket.CycleOut(dest, count, out_events, stalled, miss)


def ring_run(cfg, want: torch.Tensor, consume_rate: int = 1):
    """Kernel G's ring form on a CUDA tensor, one launch; on a CPU tensor
    ``flow_control.run_plain``.  ``want``: (steps,) int32.  Returns (final
    ``RingState``, ``RunStats`` sums)."""
    from repro_torch.core import flow_control as fc
    cuda = dispatch.on_cuda(want)
    if want.dim() != 1:
        raise ValueError(f"ring_run: want must be (steps,), got "
                         f"{tuple(want.shape)}")
    _check("want", want, want.shape, cuda)
    if cfg.notify_latency < 1:
        raise IndexError(f"ring_run: notify_latency {cfg.notify_latency}: "
                         f"the delay line is empty (the reference's "
                         f"pending.at[-1] and pending[0] are out of bounds)")
    if cfg.size < 1 or cfg.notify_batch < 1:
        raise ValueError(f"ring_run: {cfg} needs >= 1 slot and a batch "
                         f">= 1")
    if not cuda:
        return fc.run_plain(cfg, want, consume_rate)
    smem = ring_shared_bytes(cfg)
    if smem > MAX_SHARED:
        raise ValueError(f"ring_run: {cfg} needs {smem} bytes of shared "
                         f"memory, the kernel has {MAX_SHARED}")
    L = cfg.notify_latency
    out = torch.empty((7 + L + cfg.size,), dtype=torch.int32,
                      device=want.device)
    dispatch.launch("ring_run", "repro_ring_run", want.data_ptr(),
                    out.data_ptr(), want.shape[0], cfg.size, L,
                    cfg.notify_batch, consume_rate)
    wr, rd, credits, unnot, produced, consumed, stalls = out[:7]
    state = fc.RingState(wr, rd, credits, out[7:7 + L], unnot, out[7 + L:])
    return state, fc.RunStats(produced, consumed, stalls)
