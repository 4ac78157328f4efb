"""Cycle-level functional model of the event-aggregation buckets (port of
``src/repro/core/bucket.py``, paper §3.1).

It models, per FPGA: a map table binding network destinations to physical
buckets, a free-bucket list (the lowest-index free bucket), bucket
renaming (an event for an unbound destination with no free bucket flushes
the most urgent bucket and steals its binding), deadline flushing (the
most urgent bucket once its slack reaches the margin), full-bucket
flushing, concurrent flushing and aggregation (a flushed bucket restarts
from zero while its packet waits in the drain queue) and a serial output
port that drains one packet at a time at 16 B a cycle.

The reference is the specification, quirks included:

* stealing an empty victim counts as a flush: it unbinds it and queues
  nothing (``_trigger_flush``'s ``ok``);
* a steal that the full drain queue refuses changes nothing and the event
  stalls;
* ties go to the lowest index (the free bucket, the victim, the deadline
  flush);
* the append is clipped at ``capacity - 1``: a second arrival in one cycle
  to a bucket that just filled overwrites its last slot and ``fill``
  reaches ``capacity + 1``;
* full-bucket flushes run after all of a cycle's arrivals, in arrival
  order, each on the state the one before left;
* a queued packet copies the bucket's whole storage row (words beyond the
  count are stale, never cleared);
* the deadline-miss count reads ``now`` before its increment;
* invalid words (valid bit clear) and ``dest < 0`` change nothing.

:func:`run_trace` replays a (T, E) trace from :func:`init_state`.  On CUDA
tensors it launches kernel G (``csrc/cycle_models.cu``, wrapper
``kernels/cycle_models.py``), one launch per trace; on CPU tensors it runs
:func:`run_trace_plain`, the loop of :func:`cycle`'s body.  The plain
version is a serial state machine over Python integers (the model has no
data parallelism for tensor operations to use; the reference's scan is a
chain of dependent steps), with tensors at its boundary.  Event words are
int32 bit patterns, as everywhere in the port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import events as ev
from repro_torch.kernels import dispatch

NO_BUCKET = -1
NO_DEST = -1
_BIG = 1 << 20
_HALF = ev.TS_MASK >> 1


class BucketConfig(NamedTuple):
    n_buckets: int = 8
    capacity: int = ev.PACKET_MAX_EVENTS       # 124 events / 496 B
    n_dest: int = 64                            # destinations this shard talks to
    flush_margin: int = 64                      # systemtime units of slack kept
    queue: int = 4                              # flush requests the port can hold


class BucketState(NamedTuple):
    """All per-FPGA aggregation state (int32). B=n_buckets, C=capacity."""

    map_table: torch.Tensor   # (n_dest,) dest -> bucket | NO_BUCKET
    bucket_dest: torch.Tensor  # (B,) bucket -> dest | NO_DEST (free)
    fill: torch.Tensor        # (B,) accumulation-side counter
    deadline: torch.Tensor    # (B,) most urgent ts (ring); _BIG if empty
    storage: torch.Tensor     # (B, C) packed events
    q_dest: torch.Tensor      # (Q,) drain queue: destinations
    q_count: torch.Tensor     # (Q,) event counts
    q_events: torch.Tensor    # (Q, C) payloads
    q_len: torch.Tensor       # () queued packets
    port_busy: torch.Tensor   # () cycles until the port is free
    now: torch.Tensor         # () systemtime


class CycleOut(NamedTuple):
    """Per-cycle observable outputs (stacked over T by :func:`run_trace`)."""

    sent_dest: torch.Tensor   # () dest of the packet leaving the port (-1)
    sent_count: torch.Tensor  # () events in that packet
    sent_events: torch.Tensor  # (C,) its payload
    stalled: torch.Tensor     # () input events refused this cycle
    deadline_miss: torch.Tensor  # () events whose deadline passed pre-send


def init_state(cfg: BucketConfig, *, device=None) -> BucketState:
    """Empty buckets and queue (``device=None`` is CUDA)."""
    device = dispatch.resolve_device(device)
    B, C, Q = cfg.n_buckets, cfg.capacity, cfg.queue
    full = lambda shape, v: torch.full(shape, v, dtype=torch.int32,
                                       device=device)
    return BucketState(
        map_table=full((cfg.n_dest,), NO_BUCKET),
        bucket_dest=full((B,), NO_DEST), fill=full((B,), 0),
        deadline=full((B,), _BIG), storage=full((B, C), 0),
        q_dest=full((Q,), NO_DEST), q_count=full((Q,), 0),
        q_events=full((Q, C), 0), q_len=full((), 0), port_busy=full((), 0),
        now=full((), 0))


# ---------------------------------------------------------------------------
# The plain version: the state as Python integers, one cycle at a time.
# ---------------------------------------------------------------------------

def _slack(deadline: int, now: int) -> int:
    """``ev.ts_slack`` on Python integers."""
    d = (deadline - now) & ev.TS_MASK
    return d - (ev.TS_MASK + 1) if d > _HALF else d


def _wire_cycles(n: int) -> int:
    """``ev.wire_cycles`` on a Python integer."""
    if n <= 0:
        return 0
    groups = (n + ev.DESERIAL_GROUP - 1) // ev.DESERIAL_GROUP
    nbytes = groups * ev.DESERIAL_GROUP * ev.EVENT_BYTES + \
        ev.PACKET_HEADER_BYTES
    return (nbytes + ev.DATAPATH_BYTES_PER_CYCLE - 1) // \
        ev.DATAPATH_BYTES_PER_CYCLE


class _Work:
    """A mutable copy of a :class:`BucketState` as Python integers and
    lists; the queue keeps the reference's order (slot 0 leaves next)."""

    __slots__ = ("map_table", "bucket_dest", "fill", "deadline", "storage",
                 "q_dest", "q_count", "q_events", "q_len", "port_busy",
                 "now")

    def __init__(self, state: BucketState):
        for name in self.__slots__:
            setattr(self, name, getattr(state, name).tolist())

    def state(self, device) -> BucketState:
        t = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
        return BucketState(*(t(getattr(self, name))
                             for name in self.__slots__))


def _urgency(w: _Work) -> list[int]:
    """Slack (systemtime units) per bucket; empty buckets -> _BIG."""
    now = w.now & ev.TS_MASK
    return [_slack(d & ev.TS_MASK, now) if f > 0 else _BIG
            for f, d in zip(w.fill, w.deadline)]


def _argmin(xs: list[int]) -> int:
    """Lowest index of the minimum, as ``jnp.argmin``."""
    return min(range(len(xs)), key=xs.__getitem__)


def _trigger_flush(w: _Work, b: int) -> bool:
    """Hand bucket b's accumulation side to the drain queue ('counter
    swap'): the bucket keeps its binding and restarts from fill 0.
    Returns ok: False when the queue is full and the bucket is not empty
    (an empty bucket counts as flushed)."""
    fill = w.fill[b]
    if w.q_len < len(w.q_dest) and fill > 0:
        slot = w.q_len
        w.q_dest[slot] = w.bucket_dest[b]
        w.q_count[slot] = fill
        w.q_events[slot] = list(w.storage[b])
        w.q_len += 1
        w.fill[b] = 0
        w.deadline[b] = _BIG
        return True
    return not fill > 0


def _unbind(w: _Work, b: int) -> None:
    """Release bucket b back to the free list."""
    old = w.bucket_dest[b]
    if old >= 0:
        w.map_table[old] = NO_BUCKET
    w.bucket_dest[b] = NO_DEST


def _accept_event(w: _Work, word: int, dest: int, cfg: BucketConfig):
    """Route one event through map-table lookup / renaming / append.
    Returns (stalled 0 | 1, bucket that just filled or NO_BUCKET)."""
    if not (word & ev.VALID_BIT and dest >= 0):
        return 0, NO_BUCKET
    dest_c = min(dest, cfg.n_dest - 1)
    tgt = w.map_table[dest_c]
    if tgt == NO_BUCKET:
        # renaming: the lowest free bucket, else steal the most urgent
        if NO_DEST in w.bucket_dest:
            tgt = w.bucket_dest.index(NO_DEST)
        else:
            victim = _argmin(_urgency(w))
            if not _trigger_flush(w, victim):
                return 1, NO_BUCKET           # the queue refused: stall
            _unbind(w, victim)
            tgt = victim
        w.map_table[dest_c] = tgt
        w.bucket_dest[tgt] = dest_c
    fill = w.fill[tgt]
    w.storage[tgt][min(fill, cfg.capacity - 1)] = word
    w.fill[tgt] = fill + 1
    ts = word & ev.TS_MASK
    cur = w.deadline[tgt]
    if cur == _BIG or ((ts - (cur & ev.TS_MASK)) & ev.TS_MASK) > _HALF:
        w.deadline[tgt] = ts
    return 0, (tgt if fill + 1 >= cfg.capacity else NO_BUCKET)


def _cycle(w: _Work, words: list[int], dests: list[int], cfg: BucketConfig,
           force: bool):
    """One clock on ``w`` in place.  Returns (sent_dest, sent_count,
    sent_events list or None when idle, stalled, deadline_miss)."""
    stalled, pending_full = 0, []
    for word, dest in zip(words, dests):
        s, fb = _accept_event(w, word, dest, cfg)
        stalled += s
        pending_full.append(fb)
    for fb in pending_full:                 # full buckets, arrival order
        if fb >= 0:
            _trigger_flush(w, fb)
    urg = _urgency(w)
    most = _argmin(urg)
    if urg[most] <= cfg.flush_margin or force:
        _trigger_flush(w, most)
    dest, count, row, miss = NO_DEST, 0, None, 0
    if w.port_busy <= 0 and w.q_len > 0:
        dest, count, row = w.q_dest.pop(0), w.q_count.pop(0), \
            w.q_events.pop(0)
        w.q_dest.append(NO_DEST)
        w.q_count.append(0)
        w.q_events.append([0] * cfg.capacity)
        w.q_len -= 1
        w.port_busy = _wire_cycles(count)
        now = w.now & ev.TS_MASK
        miss = sum(_slack(x & ev.TS_MASK, now) < 0 for x in row[:count])
    w.port_busy = max(w.port_busy - 1, 0)
    w.now += 1
    return dest, count, row, stalled, miss


def cycle(state: BucketState, words: torch.Tensor, dests: torch.Tensor,
          cfg: BucketConfig, force_flush=None):
    """Advance the model by one FPGA clock.

    words / dests: (E,) int32 event words and routed destinations arriving
    this cycle (invalid words are ignored); ``force_flush``: optional bool
    external trigger (flushes the most urgent bucket).  Returns (state,
    :class:`CycleOut`); ``state`` is left as it was.
    """
    w = _Work(state)
    force = False if force_flush is None else bool(force_flush)
    dest, count, row, stalled, miss = _cycle(
        w, words.tolist(), dests.tolist(), cfg, force)
    device = state.fill.device
    t = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
    events = t(row) if row is not None else \
        torch.zeros((cfg.capacity,), dtype=torch.int32, device=device)
    return w.state(device), CycleOut(t(dest), t(count), events, t(stalled),
                                     t(miss))


def run_trace_plain(cfg: BucketConfig, words: torch.Tensor,
                    dests: torch.Tensor):
    """The plain version of kernel G's trace replay: :func:`cycle`'s body
    over a (T, E) trace from :func:`init_state`, on any device.  Returns
    (final state, :class:`CycleOut` with a leading T axis)."""
    device = words.device
    T = words.shape[0]
    w = _Work(init_state(cfg, device="cpu"))
    dest, count, stalled, miss = [], [], [], []
    rows, sent_at = [], []
    for t, (ws, ds) in enumerate(zip(words.tolist(), dests.tolist())):
        d, n, row, s, m = _cycle(w, ws, ds, cfg, False)
        dest.append(d)
        count.append(n)
        stalled.append(s)
        miss.append(m)
        if row is not None:
            rows.append(row)
            sent_at.append(t)
    events = torch.zeros((T, cfg.capacity), dtype=torch.int32)
    if rows:
        events[sent_at] = torch.tensor(rows, dtype=torch.int32)
    t = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
    return w.state(device), CycleOut(t(dest), t(count), events.to(device),
                                     t(stalled), t(miss))


def run_trace(cfg: BucketConfig, words: torch.Tensor, dests: torch.Tensor):
    """Replay a (T, E) int32 trace from :func:`init_state`.  Returns
    (final state, :class:`CycleOut` with a leading T axis).  CUDA tensors
    launch kernel G once; CPU tensors run :func:`run_trace_plain`."""
    from repro_torch.kernels import cycle_models
    return cycle_models.bucket_trace(cfg, words, dests)
