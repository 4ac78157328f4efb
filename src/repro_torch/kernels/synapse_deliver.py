"""Delivery of received events through a sparse synapse store, in event
order (no reference counterpart: the reference delivers through a dense
weight matrix, ``src/repro/snn/simulator.py:_apply_events``).

:func:`synapse_deliver` launches the hand-written kernel
``csrc/synapse_deliver.cu`` on CUDA tensors and runs
:func:`synapse_deliver_plain` on CPU tensors.  Both compute, bit for bit:

* for each destination shard ``s``, the received events ``words[s, src,
  k]`` are taken in order, row-major over (source shard ``src``, bucket
  slot ``k``), live ones only (``k < counts[s, src]``);
* an event's source is ``src * per + address(w)`` (the source address
  layout of ``snn/network.py``); an address at or past ``per`` carries no
  synapse.  Its ring slot is ``(t + max(slack, 0)) % ring_len``, ``slack``
  the signed 15-bit distance from ``t`` to its timestamp, and an event
  with ``slack < 0`` is a deadline miss of ``s`` (counted as the dense
  delivery counts them);
* each synapse (target ``x``, weight) of the source's list on ``s`` adds
  its weight, as one f32 add, into ``ring_inh`` if the source is
  inhibitory, else ``ring_exc``, at ``[slot, s, x]``.  Each (target, slot)
  sees its adds in the event order above.  No atomics decide the order of
  the float adds, so the rings are a fixed function of the inputs;
* the synapses delivered are added into ``store.count`` (one int64
  element, on the device; the kernel adds to it in its own launch).

The rings are updated in place; returns the (S,) int32 deadline misses.
A list holds at most one synapse per target (the store's contract), so
the adds of one event never meet.  The window's step ``t`` is a Python
int or, for a caller that keeps its step count on the card (the
simulator, whose window loop is replayed as a CUDA graph), an int32
tensor whose first element the kernel reads through its pointer.
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.kernels import dispatch

MAX_RING = 64             # ring slots the kernel stages (kMaxRows / 2)


def _operands(ring_exc, ring_inh, words, counts, store, inh_src, per: int):
    S, n_src, C = words.shape
    L = ring_exc.shape[0]
    want = [("words", words, (S, n_src, C), torch.int32),
            ("ring_exc", ring_exc, (L, S, per), torch.float32),
            ("ring_inh", ring_inh, (L, S, per), torch.float32),
            ("row_ptr", store.row_ptr, (S, n_src * per + 1), torch.int64),
            ("targets", store.targets, tuple(store.targets.shape),
             torch.int32),
            ("weights", store.weights, tuple(store.targets.shape),
             torch.float32),
            ("count", store.count, (1,), torch.int64),
            ("inh_src", inh_src, (n_src * per,), torch.bool)]
    for name, t, shape, dtype in want:
        if t.dtype != dtype or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"synapse_deliver: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (S, n_src):
        raise ValueError(f"synapse_deliver: counts must be an int32 tensor "
                         f"of shape {(S, n_src)}, got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if per > ev.ADDR_MASK + 1:
        raise ValueError(f"synapse_deliver: {per} neurons a shard exceed "
                         f"the {ev.ADDR_BITS}-bit address field")
    return S, n_src, C, L


def synapse_deliver_plain(ring_exc, ring_inh, words, counts, t: int, store,
                          inh_src, per: int):
    """Plain PyTorch delivery: one event slot at a time, in order, each
    vectorised over the destination shards (an event's indices are
    unique, so ``index_put_(..., accumulate=True)`` is one f32 add an
    element)."""
    words = words.contiguous()
    S, n_src, C, L = _operands(ring_exc, ring_inh, words, counts, store,
                               inh_src, per)
    t = dispatch.step_on_host(t)
    dev = words.device
    slot_ix = torch.arange(C, dtype=torch.int32, device=dev)
    live = (slot_ix < counts[..., None]).reshape(S, -1)
    words = words.reshape(S, -1)
    addr = ev.address(words)
    slack = ev.ts_slack(ev.timestamp(words), t & ev.TS_MASK)
    miss = (live & (slack < 0)).sum(1, dtype=torch.int32)
    ring_slot = ((t + torch.clamp(slack, min=0)) % L).long()
    has = live & (addr < per)
    src = (torch.arange(n_src, device=dev).repeat_interleave(C)[None]
           * per + addr).long()                       # (S, n_src * C)
    shard = torch.arange(S, device=dev)
    total = 0
    for p in torch.nonzero(has.any(0)).flatten().tolist():
        g = torch.where(has[:, p], src[:, p], 0)
        start = store.row_ptr[shard, g]
        n = torch.where(has[:, p], store.row_ptr[shard, g + 1] - start, 0)
        m = int(n.sum())
        if m == 0:
            continue
        sh = torch.repeat_interleave(shard, n)
        first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
        j = torch.repeat_interleave(start, n) + torch.arange(m, device=dev) \
            - first
        x = store.targets[j].long()
        w = store.weights[j]
        q = ring_slot[sh, p]
        inh = inh_src[g][sh]
        for ring, sel in ((ring_exc, ~inh), (ring_inh, inh)):
            ring.index_put_((q[sel], sh[sel], x[sel]), w[sel],
                            accumulate=True)
        total += m
    store.count.add_(total)
    return miss


def synapse_deliver(ring_exc, ring_inh, words, counts, t, store,
                    inh_src, per: int):
    """Deliver ``words`` (S, S_src, C) int32 received events with their
    ``counts`` (S, S_src) into the rings (ring_len, S, per) f32 through
    ``store`` (``snn.network.SynapseStore``) at step ``t`` (an int, or an
    int32 tensor on the card) -> (S,) int32 deadline misses.  Kernel on
    CUDA tensors, :func:`synapse_deliver_plain` on CPU tensors (the module
    docstring's semantics)."""
    t_at = t if isinstance(t, torch.Tensor) else None
    if t_at is not None and (t_at.dtype != torch.int32 or t_at.numel() < 1):
        raise ValueError(f"synapse_deliver: a step tensor must be int32 "
                         f"with an element, got {t_at.dtype} "
                         f"{tuple(t_at.shape)}")
    operands = (ring_exc, ring_inh, words, counts, store.row_ptr,
                store.targets, store.weights, store.count, inh_src,
                *(() if t_at is None else (t_at,)))
    if not dispatch.on_cuda(*operands):
        return synapse_deliver_plain(ring_exc, ring_inh, words, counts, t,
                                     store, inh_src, per)
    words = words.contiguous()
    S, n_src, C, L = _operands(ring_exc, ring_inh, words, counts, store,
                               inh_src, per)
    if L > MAX_RING or (t_at is None and t < 0):
        raise ValueError(f"synapse_deliver: the kernel takes rings of at "
                         f"most {MAX_RING} slots and t >= 0, got {L} and "
                         f"{t}")
    miss = torch.empty((S,), dtype=torch.int32, device=words.device)
    if S:
        dispatch.launch("synapse_deliver", "repro_synapse_deliver",
                        words.data_ptr(), counts.data_ptr(),
                        store.row_ptr.data_ptr(), store.targets.data_ptr(),
                        store.weights.data_ptr(), inh_src.data_ptr(),
                        ring_exc.data_ptr(), ring_inh.data_ptr(),
                        miss.data_ptr(), store.count.data_ptr(), S, n_src, C,
                        per, L, 0 if t_at is not None else int(t),
                        None if t_at is None else t_at.data_ptr(),
                        *counts.stride())
    return miss
