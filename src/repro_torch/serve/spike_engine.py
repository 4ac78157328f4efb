"""Streaming multi-tenant spike serving engine (port of
``src/repro/serve/spike_engine.py``).

A host ingestion thread fills pinned staging buffers; a device thread
copies each filled slot to the card on a side CUDA stream and runs a
segment of ``seg_windows`` flush windows on its own compute stream, so the
host stages segment ``k + 1`` while the card still exchanges segment ``k``.

Per flush window and tenant (every shard at once, the shard axis leading)::

    ingest thread                     device thread (compute stream)
    -------------                     ------------------------------
    loadgen / client                  backlog-first merge -> bucket rows
      |  fill pinned staging slot       | codec.encode_planar (kernel B)
      v                                 v
    staged queue (depth 2) --H2D copy-> TenantTorusTransport.exchange
      ^      (side stream + event)      |  (kernel F's tenant form)
      +-- free slots <-- event done     v  deferred rows -> backlog carry
                                        codec.decode_planar (kernel B)
                                        -> per-tenant latency digests

The engine is loss-accountable end to end: every generated event is
``delivered``, in the ``backlog`` carry, parked ``in_fabric``, or counted
as ``shed`` (fresh arrivals beyond the one-row backlog bound).
``stop(drain=True)`` runs zero-traffic segments until backlog and fabric
are empty, then one final walk (an uncredited flush plus
``drain_fabric``), after which ``injected == delivered + shed`` holds per
tenant.  Latency is attributed on the receiver from the injection window
each event carries in its wire word's meta lane.

Observability is opt-in.  ``recorder`` (an ``obs.RecorderConfig``) puts a
``TelemetryRing`` in the carry as a fifth element: every served window,
drain segments included, records its per-tenant counters, credit slots,
kernel F's per-link stall table and latency histogram
(:meth:`SpikeEngine.recorder_rows`).  ``tracer`` (an ``obs.Tracer``)
records host spans; none synchronizes, reads a tensor or launches work,
so each measures the host's issue or wait, never device time:

* ``spike-ingest`` track: ``ingest/slot_wait``, the wait for a free
  staging slot (ingest's backpressure, one span per filled slot, however
  many 50 ms polls it takes), and ``ingest/fill``, the slot's filling.
* ``spike-device`` track (the device thread): ``device/staged_wait``, the
  wait for a staged segment (ingest starving the card);
  ``device/h2d``, the issue of the slot's copy; ``device/dispatch``, the
  issue of a segment's windows, with ``cpu_us``, the thread's CPU time
  over it (the rest is time off the CPU: the GIL, preemption, blocking
  calls); ``device/stats_wait``, the wait in ``_absorb`` for the previous
  segment's stats copy (the card, not the host, holding the loop back).
* inside each eagerly run window, on the issuing thread's track:
  ``window/exchange``, the tenant torus exchange (F's tenant form, the
  ring phases, the ``LinkStats`` build), and ``window/attribute``, the
  receiver's decode and latency summary, each with ``window``; the rest
  of ``device/dispatch`` is the merge, the encode, the recorder's record
  and queuing the stats copy.  A replayed segment records
  ``segment/replay`` there instead (and its capture
  ``segment/capture``).
* ``device`` track: one ``window`` instant per window, stamped when its
  stats reach the host, with the absolute index the wire words' meta lane
  and the recorder's rows carry.

During ``stop``'s drain the caller's thread runs the segments, so their
``window/*`` and ``device/stats_wait`` spans lie on its track, and
``drain/walk`` on ``spike-device``.

A served segment is one CUDA graph.  A window reads its index from the
card: the meta lane's stamp and the receiver's wait are computed from a
0-d int32 tensor, the segment's first window (filled in before each
replay, no host read) plus the window's offset in the segment.  On a
CUDA device without a fault schedule or a recorder (both index their
tables by window on the host), the engine's first segment runs eagerly
(which builds the kernel library and every lazy table), the second
captures its ``seg_windows`` windows into a graph, and every later
segment, drain segments included, copies the carry and the staged words
and counts into the graph's buffers, fills the stamp, replays
(``dispatch.graph_launch``: holding the GIL, so a profiler stopped on
another thread cannot deadlock with the launch), clones the end carry out
and queues the stats' copy to the host.  Neither a carry passed in nor
one returned is written by a later replay.  :meth:`warmup` runs both the
eager and the capturing segment, so the capture falls in set-up.  A
replayed window makes no host call, so it records no ``window/*`` span;
a capture and a replay record ``segment/capture`` and ``segment/replay``
on the calling thread's track.  The drain walk stays eager.
:data:`SEGMENTS` counts how segments ran; a replay counts its kernel
launches in ``dispatch.LAUNCHES`` as the eager windows would.

Differences from the reference: the shard axis is a tensor dimension (no
mesh; ``n_shards`` and ``device`` instead), event words are int32 bit
patterns, and a segment is a loop of windows, eager or replayed as a CUDA
graph (the reference scans them in one jit).
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.fabric import faults as fabric_faults
from repro_torch.kernels import dispatch
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs import spans as obs_spans
from repro_torch.serve import tenancy
from repro_torch.wire import codec
from repro_torch.wire import latency as wire_latency


class EngineConfig(NamedTuple):
    """Static engine parameters.

    capacity:      C, max events per (tenant, dst) bucket row per window;
                   also the per-row backlog bound (one deferred row)
    link_credits:  per-link credit budget split by the tenant partition
    notify_latency: windows before a spent credit re-arms
    window_us:     modeled wall-clock per flush window (latency unit)
    seg_windows:   windows per device segment
    queue_depth:   staging slots (2 = double buffer)
    max_drain_segments: zero-traffic segments allowed before the final
                   uncredited walk
    """

    capacity: int = 128
    link_credits: int = 64
    notify_latency: int = 2
    window_us: float = 100.0
    seg_windows: int = 8
    nx: int = 0
    ny: int = 0
    nz: int = 0
    wire_format: str = "extoll"
    queue_depth: int = 2
    max_drain_segments: int = 64


class WindowServeStats(NamedTuple):
    """Per-window, per-shard, per-tenant serving stats: (S, T) each, the
    latency summary's fields (S, T) and its histogram (S, T, bins)."""

    offered: torch.Tensor
    sent: torch.Tensor
    deferred: torch.Tensor
    parked: torch.Tensor
    unparked: torch.Tensor
    delivered: torch.Tensor
    shed: torch.Tensor
    latency: wire_latency.LatencySummary


class EngineReport(NamedTuple):
    """What a bounded run (or a stop) hands back."""

    tenants: list                 # list[tenancy.TenantDigest]
    injected: np.ndarray          # (T,) events staged to the device
    delivered: np.ndarray         # (T,) events that reached their owners
    shed: np.ndarray              # (T,) fresh events beyond backlog bound
    clipped: np.ndarray           # (T,) generator-side over-capacity drop
    windows: int                  # served windows (excl. drain)
    drain_windows: int            # zero-traffic windows run to quiesce
    wall_s: float                 # ingest start -> last absorb
    events_per_s: float           # delivered.sum() / wall_s
    conservation_checked: bool    # True iff drained and ledger verified


SEGMENTS: dict[str, int] = {"eager": 0, "replayed": 0, "captured": 0}
"""Segments run by every engine's ``_segment``: ``eager`` window by window
from Python, ``replayed`` by replaying a captured CUDA graph; ``captured``
counts the graphs captured (one per engine)."""


def reset_segments() -> None:
    for k in SEGMENTS:
        SEGMENTS[k] = 0


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tree of (named) tuples; None stays."""
    if tree is None:
        return None
    if not isinstance(tree, tuple):
        return fn(tree)
    items = [_tree_map(fn, x) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def _leaves(tree) -> list:
    """The tensors of a tree of (named) tuples, in order; None skipped."""
    if tree is None:
        return []
    if not isinstance(tree, tuple):
        return [tree]
    return [x for sub in tree for x in _leaves(sub)]


def _tree_stack(trees):
    """Stack a list of equal trees of named tuples leaf by leaf."""
    if not isinstance(trees[0], tuple):
        return torch.stack(trees)
    return type(trees[0])(*(_tree_stack(list(x)) for x in zip(*trees)))


def _flatten(leaves) -> torch.Tensor:
    """Equal-dtype tensors as one flat tensor (one call, one kernel)."""
    return torch._utils._flatten_dense_tensors(leaves)


def _unflatten(flat: torch.Tensor, tree):
    """A tree shaped as ``tree`` of views of ``flat`` (:func:`_flatten` of
    ``tree``'s leaves, in order, on any device), each leaf in its own
    dtype of the element size of ``flat``'s."""
    leaves = _leaves(tree)
    it = iter(v if v.dtype == x.dtype else v.view(x.dtype) for v, x in zip(
        torch._utils._unflatten_dense_tensors(flat, leaves), leaves))
    return _tree_map(lambda _: next(it), tree)


class _Packed(NamedTuple):
    """A host copy of one packed tensor and the tree it unpacks to."""

    flat: torch.Tensor
    like: tuple

    def unpack(self):
        """``like``'s tree of host tensors, views of ``flat`` cut with
        numpy: no call that releases the GIL (the ingest thread's)."""
        buf, off, out = self.flat.numpy(), 0, []
        for x in _leaves(self.like):
            n = x.numel()
            out.append(torch.from_numpy(buf[off:off + n].view(
                _NUMPY[x.dtype]).reshape(x.shape)))
            off += n
        it = iter(out)
        return _tree_map(lambda _: next(it), self.like)


_NUMPY = {torch.int32: np.int32, torch.float32: np.float32}


class _SegmentGraph(NamedTuple):
    """A captured segment: its graph; the tensors it reads (the carry's
    leaves packed in ``carry_in``, the carry as views of it, the staged
    words and counts, the first window's stamp); what it writes (the
    stacked stats, ``stats``, and the end carry and the stats each packed
    into one int32 tensor, so a replay moves each with one copy); and the
    kernel launches its capture counted (``dispatch.take_launches``)."""

    graph: torch.cuda.CUDAGraph
    carry_in: torch.Tensor          # holds the end carry after a replay
    carry_views: tuple              # shaped as every carry of the engine
    fw: torch.Tensor
    fc: torch.Tensor
    stamp: torch.Tensor
    stats: WindowServeStats
    carry_out: torch.Tensor
    stats_out: torch.Tensor
    launched: tuple


class SpikeEngine:
    """Multi-tenant streaming engine over one credit-partitioned fabric.

    ``source`` provides ``next_window(window) -> WindowTraffic``
    (``serve.loadgen.PoissonLoadGen``); tenants and QoS come from
    ``tenancy.TenantSpec``.  :meth:`run` serves a bounded number of
    segments, :meth:`start` / :meth:`stop` serve continuously.  The engine
    runs on ``device`` (default CUDA; ``"cpu"`` runs the kernels' plain
    versions).  Host copies of every served window's stats are kept in
    :attr:`window_stats`, one stacked ``WindowServeStats`` of numpy arrays
    (leading axis: the windows) per segment.
    """

    def __init__(self, n_shards: int, tenants: Sequence[tenancy.TenantSpec],
                 cfg: EngineConfig, source,
                 fault_schedule: fabric_faults.FaultSchedule | None = None,
                 recorder: obs_recorder.RecorderConfig | None = None,
                 tracer: obs_spans.Tracer | None = None, *, device=None):
        self.device = dispatch.resolve_device(device)
        self.recorder = recorder
        self.tracer = tracer if tracer is not None else obs_spans.NULL
        self.tenants = tuple(tenants)
        self.cfg = cfg
        self.source = source
        S, T = int(n_shards), len(self.tenants)
        if getattr(source, "n_tenants", T) != T:
            raise ValueError(f"source generates {source.n_tenants} "
                             f"tenants, engine serves {T}")
        if getattr(source, "capacity", cfg.capacity) != cfg.capacity:
            raise ValueError("source row capacity != engine capacity")
        if getattr(source, "n_shards", S) != S:
            raise ValueError("source n_shards != engine n_shards")
        self.n_shards, self.n_tenants = S, T
        self.transport = tenancy.build_fabric(
            S, self.tenants, link_credits=cfg.link_credits,
            notify_latency=cfg.notify_latency, nx=cfg.nx, ny=cfg.ny,
            nz=cfg.nz, max_row_events=cfg.capacity,
            wire_format=cfg.wire_format,
            stall_attribution=recorder is not None)
        self.fault_schedule = None if fault_schedule is None else \
            fabric_faults.FaultSchedule(fault_schedule.link_down.to(
                self.device))
        self.ledger = tenancy.TenantLedger([t.name for t in self.tenants])
        self._hops_rx = self.transport.route_hops(
            device=self.device).T[:, None, :]          # (dst, 1, src)
        self._pos = torch.arange(cfg.capacity, device=self.device)
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        # a segment is replayed as a CUDA graph where nothing is indexed by
        # window on the host: the fault mask and the recorder's row are
        self._graphable = (cuda and self.fault_schedule is None
                           and recorder is None)
        self._warm = False               # a segment has run eagerly
        self._graph: _SegmentGraph | None = None
        self._replayed = None            # the carry the last replay returned
        self._reset_runtime()

    # -- device functions --------------------------------------------------
    def _on_stream(self):
        """The engine's compute stream for the calling thread (the kernel
        wrappers launch on the current stream)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _attribute(self, out, win_abs):
        """Receiver-side per-event latency of one window's arrivals: the
        whole windows waited since injection (the meta lane: deferral,
        backlog dwell and park windows) + per-row wire time + queueing
        dwell behind parked traffic on the route; under faults a row is
        charged the links it actually crossed, detours included.
        ``win_abs`` is the window's index, an int or a 0-d int32 tensor.
        -> ((S, T) latency summary, (S, T) delivered events)."""
        S, T = self.n_shards, self.n_tenants
        _, r_meta = codec.decode_planar(out.recv_payload)  # (dst, T, src, C)
        live = self._pos < out.recv_counts[..., None]
        wait = (win_abs - r_meta).to(torch.float32) * self.cfg.window_us
        hops_row = (self._hops_rx if out.links_used is None
                    else out.links_used.permute(2, 0, 1))  # (dst, T, src)
        row_us = (wire_latency.hop_latency_us(
            self.transport.wire_fmt, out.recv_counts, hops_row)
            + out.queue_us.permute(2, 0, 1))
        lat = wait + row_us[..., None]
        summary = wire_latency.summarize_latency(
            lat.reshape(S, T, -1), live.reshape(S, T, -1).to(torch.int32),
            batch_dims=2)
        return summary, out.recv_counts.sum(-1, dtype=torch.int32)

    def _window_span(self, name: str, win_abs):
        """A ``window/*`` span of an eager window; a captured window makes
        no host call when it is replayed, so it has none."""
        if isinstance(win_abs, torch.Tensor):
            return contextlib.nullcontext()
        return self.tracer.span(name, window=win_abs)

    def _window(self, carry, fw_w, fc_w, win_abs):
        """One flush window: FIFO merge (the backlog row first, fresh
        arrivals behind it, overflow beyond C shed), encode, exchange,
        attribution (and the flight recorder's record) -> (carry,
        WindowServeStats).  ``win_abs`` is the window's index: an int, or
        in a captured segment a 0-d int32 tensor on the device (then
        without a fault schedule or a recorder, which take it on the
        host)."""
        on_host = not isinstance(win_abs, torch.Tensor)
        if not on_host and (self.fault_schedule is not None
                            or self.recorder is not None):
            raise ValueError("a fault schedule or a recorder needs the "
                             "window's index on the host")
        state, bw, bm, bc = carry[:4]
        C, pos = self.cfg.capacity, self._pos
        b = bc[..., None]
        sel_b = pos < b
        fw_g = torch.gather(fw_w, -1, torch.clamp(pos - b, 0, C - 1))
        take_f = ~sel_b & (pos - b < fc_w[..., None])
        words = torch.where(sel_b, bw, torch.where(take_f, fw_g, 0))
        stamp = (torch.full((), win_abs, dtype=torch.int32,
                            device=self.device) if on_host else win_abs)
        meta = torch.where(sel_b, bm, torch.where(take_f, stamp, 0))
        cnt = torch.clamp(bc + fc_w, max=C)
        shed = bc + fc_w - cnt
        payload = codec.encode_planar(words.contiguous(), meta.contiguous())
        if self.fault_schedule is not None:
            state = state._replace(link_down=fabric_faults.mask_at(
                self.fault_schedule, win_abs))
        with self._window_span("window/exchange", win_abs):
            out = self.transport.exchange(state, payload, cnt)
        keep = ~out.sent_mask
        ring = carry[4:]
        carry = (out.state, torch.where(keep[..., None], words, 0),
                 torch.where(keep[..., None], meta, 0),
                 torch.where(keep, cnt, 0))
        with self._window_span("window/attribute", win_abs):
            summary, delivered = self._attribute(out, win_abs)
        st = out.stats
        if ring:
            carry += (obs_recorder.record(ring[0], win_abs, st, out.state,
                                          summary.hist),)
        return carry, WindowServeStats(
            offered=st.offered_events, sent=st.sent_events,
            deferred=st.deferred_events, parked=st.parked_events,
            unparked=st.unparked_events, delivered=delivered,
            shed=shed.sum(-1, dtype=torch.int32), latency=summary)

    def _segment_windows(self, carry, fw, fc_, win0):
        """``seg_windows`` windows from ``fw`` (nw, S, T, S, C) and ``fc_``
        (nw, S, T, S), the first numbered ``win0`` (an int, or a 0-d int32
        tensor on the device) -> (carry, stacked stats on the device)."""
        out = []
        for i in range(self.cfg.seg_windows):
            carry, ws = self._window(carry, fw[i], fc_[i], win0 + i)
            out.append(ws)
        return carry, _tree_stack(out)

    def _segment(self, carry, fw, fc_, win0: int):
        """``seg_windows`` windows from ``fw`` (nw, S, T, S, C) and ``fc_``
        (nw, S, T, S) -> (carry, (stacked stats on the host, an event
        recorded behind their copy)).  Eager, or replayed as a CUDA graph
        (the module docstring); no later segment writes ``carry`` or the
        carry returned."""
        if self._graphable and self._warm:
            return self._replay(carry, fw, fc_, win0)
        self._warm = True
        SEGMENTS["eager"] += 1
        carry, stats = self._segment_windows(carry, fw, fc_, win0)
        return carry, self._to_host(stats)

    def _capture(self, carry) -> _SegmentGraph:
        """Capture a segment into a graph whose inputs are a copy of
        ``carry``'s tensors (int32, packed), word and count buffers and
        the stamp."""
        nw = self.cfg.seg_windows
        carry_in = _flatten(_leaves(carry))
        carry_views = _unflatten(carry_in, carry)
        fw = torch.zeros_like(self._zero_fw)
        fc_ = torch.zeros_like(self._zero_fc)
        stamp = torch.zeros((), dtype=torch.int32, device=self.device)
        graph = torch.cuda.CUDAGraph()
        before = dispatch.launch_counts()
        with self.tracer.span("segment/capture", windows=nw):
            # thread-local: the ingest thread may run beside a capture on
            # the device thread (an engine started without ``warmup``)
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                stats, carry_out, stats_out = self._graph_body(
                    carry_in, carry_views, fw, fc_, stamp)
        launched = dispatch.take_launches(before)
        SEGMENTS["captured"] += 1
        return _SegmentGraph(graph, carry_in, carry_views, fw, fc_, stamp,
                             stats, carry_out, stats_out, launched)

    def _graph_body(self, carry_in, carry_views, fw, fc_, stamp):
        """What a segment's graph runs: the windows from ``carry_views``
        (views of ``carry_in``), then the end carry packed and written
        back into ``carry_in`` -> (stacked stats, the end carry packed,
        the stats packed into one int32 tensor)."""
        end, stats = self._segment_windows(carry_views, fw, fc_, stamp)
        carry_out = _flatten(_leaves(end))
        carry_in.copy_(carry_out)
        return stats, carry_out, _flatten(
            [x.view(torch.int32) for x in _leaves(stats)])

    def _replay(self, carry, fw, fc_, win0: int):
        """The segment as a replay of the engine's graph (captured by the
        first call): the carry, words and counts copied in on the compute
        stream, the stamp filled on the card, the end carry cloned out and
        returned as views of its one clone; the host copy of the stats is
        one copy of their packed tensor (:meth:`_ready` unpacks it).  Few
        host calls a segment matter beyond their own cost: each releases
        the GIL, which the ingest thread then holds."""
        g = self._graph
        if g is None:
            g = self._graph = self._capture(carry)
        if carry is not self._replayed:    # else its values are in carry_in
            g.carry_in.copy_(_flatten(_leaves(carry)))
        g.fw.copy_(fw)
        g.fc.copy_(fc_)
        g.stamp.fill_(win0)
        with self.tracer.span("segment/replay", win0=win0,
                              windows=self.cfg.seg_windows):
            dispatch.graph_launch(g.graph)
        dispatch.count_launches(g.launched)
        SEGMENTS["replayed"] += 1
        self._replayed = _unflatten(g.carry_out.clone(), g.carry_views)
        # the stats' copy to the host is queued on this stream, so it reads
        # the graph's buffers before the next replay writes them
        return self._replayed, self._to_host(g.stats_out, like=g.stats)

    def _to_host(self, tree, like=None):
        """Queue the copy of ``tree``'s tensors to the host behind the work
        that makes them -> (host tree, event or None); read it only after
        :meth:`_ready`.  With ``like``, ``tree`` is the packed tensor of
        ``like``'s leaves, unpacked to its shape on the host."""
        host = _tree_map(lambda x: x.to("cpu", non_blocking=True), tree)
        if like is not None:
            host = _Packed(host, like)
        if self._stream is None:
            return host, None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream())
        return host, event

    @staticmethod
    def _ready(item):
        host, event = item
        if event is not None:
            event.synchronize()
        return host.unpack() if isinstance(host, _Packed) else host

    def _drain_walk(self, carry, win0: int):
        """Final walk: one uncredited flush of the backlog plus the
        transit-buffer drain (``drain_fabric``), so nothing the fabric
        still holds is lost across engine stop."""
        state, bw, bm, bc = carry[:4]
        payload = codec.encode_planar(bw.contiguous(), bm.contiguous())
        out1 = self.transport.exchange(state, payload, bc,
                                       enforce_credits=False)
        s1, d1 = self._attribute(out1, win0)
        out2 = self.transport.drain_fabric(out1.state)
        s2, d2 = self._attribute(out2, win0)
        return out2.state, self._to_host((s1, d1, s2, d2))

    # -- runtime state -----------------------------------------------------
    def _reset_runtime(self):
        S, T, C = self.n_shards, self.n_tenants, self.cfg.capacity
        nw, depth = self.cfg.seg_windows, self.cfg.queue_depth
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                       device=self.device)
        state0 = self.transport.init_state(2 * C, device=self.device)
        self._carry = (state0, z(S, T, S, C), z(S, T, S, C), z(S, T, S))
        if self.recorder is not None:
            # the credit lanes hold the (T+1)*K partition slots, the stall
            # lane the K physical links
            self._carry += (obs_recorder.ring_init(
                self.recorder.depth, state0, (T,),
                (T, wire_latency.N_LATENCY_BINS),
                S * self.transport.n_links, n_shards=S),)
        self._zero_fw = z(nw, S, T, S, C)
        self._zero_fc = z(nw, S, T, S)
        # the staging slots: a segment's words and counts packed in one
        # row, filled in place by the ingest thread through numpy views,
        # pinned for the card so one copy can run on the side stream
        pin = self.device.type == "cuda"
        slots = torch.zeros((depth, self._zero_fw.numel()
                             + self._zero_fc.numel()), dtype=torch.int32,
                            pin_memory=pin)
        self._slots = slots.unbind(0)
        self._slot_np = [tuple(x.numpy() for x in _unflatten(
            row, (self._zero_fw, self._zero_fc))) for row in self._slots]
        self._free_q: queue.Queue = queue.Queue()
        for i in range(depth):
            self._free_q.put(i)
        self._staged_q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop_evt = threading.Event()
        self._ingest_t = self._device_t = None
        self._device_error = None
        self._max_segments = None
        self._win = 0
        self._windows = 0
        self._drain_windows = 0
        self._t0 = self._t1 = 0.0
        self.window_stats: list[WindowServeStats] = []

    # -- host threads ------------------------------------------------------
    def _fill_segment(self, slot: int, seg: int):
        nw = self.cfg.seg_windows
        wbuf, cbuf = self._slot_np[slot]
        wbuf = wbuf.view(np.uint32)
        inj = np.zeros((self.n_tenants,), np.int64)
        clip = np.zeros((self.n_tenants,), np.int64)
        with self.tracer.span("ingest/fill", track="spike-ingest",
                              seg=seg, win0=seg * nw):
            for i in range(nw):
                tr = self.source.next_window(seg * nw + i)
                # shard s offers rows (tenant, dst) = traffic[:, s, :]
                cbuf[i] = tr.counts.transpose(1, 0, 2)
                wbuf[i] = tr.words.transpose(1, 0, 2, 3)
                inj += tr.counts.astype(np.int64).sum((1, 2))
                clip += tr.clipped
        return inj, clip

    def _ingest_loop(self):
        seg = 0
        t0 = None                   # when the wait for the next slot began
        try:
            while not self._stop_evt.is_set():
                if (self._max_segments is not None
                        and seg >= self._max_segments):
                    break
                if t0 is None:
                    t0 = self.tracer.now_us()
                try:
                    slot = self._free_q.get(timeout=0.05)
                except queue.Empty:
                    continue
                self.tracer.complete("ingest/slot_wait", t0,
                                     self.tracer.now_us() - t0,
                                     track="spike-ingest", cat="host",
                                     slot=slot)
                t0 = None
                inj, clip = self._fill_segment(slot, seg)
                self._staged_q.put((slot, inj, clip))
                seg += 1
        finally:
            self._staged_q.put(None)

    def _stage(self, slot: int):
        """The slot's words and counts on the device -> (fw, fc_, event).
        On the card the copy runs on the side stream and the compute
        stream waits for it; the slot may be refilled only once the event
        recorded behind the copy has completed."""
        like = (self._zero_fw, self._zero_fc)
        if self._copy_stream is None:
            return (*_unflatten(self._slots[slot].clone(), like), None)
        with torch.cuda.stream(self._copy_stream):
            flat = self._slots[slot].to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        self._stream.wait_event(copied)
        flat.record_stream(self._stream)
        return (*_unflatten(flat, like), copied)

    def _device_loop(self):
        prev = None
        try:
            with self._on_stream():
                while True:
                    with self.tracer.span("device/staged_wait",
                                          track="spike-device"):
                        item = self._staged_q.get()
                    if item is None:
                        break
                    slot, inj, clip = item
                    with self.tracer.span("device/h2d", track="spike-device",
                                          slot=slot):
                        fw, fc_, copied = self._stage(slot)
                    win0 = self._win
                    with self.tracer.span("device/dispatch",
                                          track="spike-device", win0=win0,
                                          cpu_time=True):
                        self._carry, ws = self._segment(self._carry, fw,
                                                        fc_, win0)
                    if copied is not None:
                        copied.synchronize()
                    self._free_q.put(slot)    # the copy is done: reusable
                    self._win += self.cfg.seg_windows
                    self._windows += self.cfg.seg_windows
                    self.ledger.add_injected(inj, clip)
                    if prev is not None:      # absorb k-1 while k runs
                        self._absorb(*prev)
                    prev = (ws, win0)
                if prev is not None:
                    self._absorb(*prev)
        except BaseException as exc:         # re-raised by stop()
            self._device_error = exc
            self._stop_evt.set()
            while True:                       # unblock the ingest thread
                try:
                    self._staged_q.get_nowait()
                except queue.Empty:
                    break
        self._t1 = time.perf_counter()

    def _absorb(self, item, win0: int):
        nw = self.cfg.seg_windows
        with self.tracer.span("device/stats_wait", win0=win0, windows=nw):
            host = self._ready(item)
        ws = _tree_map(lambda x: x.numpy(), host)
        self.window_stats.append(ws)
        self.ledger.add_windows(ws.delivered, ws.shed, ws.latency.hist,
                                ws.latency.max_us, ws.latency.mean_us)
        if self.tracer.enabled:
            # the window instants carry the absolute indices the wire
            # words' meta lane and the recorder's rows are stamped with
            delivered = ws.delivered.sum(axis=(1, 2))      # (nw,)
            for i in range(nw):
                self.tracer.instant("window", track="device", cat="device",
                                    window=win0 + i,
                                    delivered=int(delivered[i]))

    # -- lifecycle ---------------------------------------------------------
    def start(self, max_segments: int | None = None):
        """Spawn the ingestion and device threads (continuous serving when
        ``max_segments`` is None)."""
        if self._ingest_t is not None:
            raise RuntimeError("engine already started")
        self._max_segments = max_segments
        self._t0 = time.perf_counter()
        self._ingest_t = threading.Thread(target=self._ingest_loop,
                                          name="spike-ingest", daemon=True)
        self._device_t = threading.Thread(target=self._device_loop,
                                          name="spike-device", daemon=True)
        self._ingest_t.start()
        self._device_t.start()

    def warmup(self) -> None:
        """A zero-traffic segment and drain walk on the current state,
        results discarded (engine state is not changed): builds the kernel
        library and warms the allocator, and where segments are replayed
        as a CUDA graph a second segment captures and replays it, so a
        timed run excludes them."""
        with self._on_stream():
            carry = self._carry[:4] + tuple(
                obs_recorder.ring_clone(r) for r in self._carry[4:])
            for _ in range(2 if self._graphable else 1):
                _, ws = self._segment(carry, self._zero_fw, self._zero_fc,
                                      0)
                self._ready(ws)
            _, walk = self._drain_walk(self._carry, 0)
            self._ready(walk)

    def backlog_events(self) -> int:
        with self._on_stream():
            return int(self._carry[3].sum())

    def in_fabric_events(self) -> int:
        with self._on_stream():
            return int(self._carry[0].parked_count.sum())

    def recorder_rows(self, shard: int | None = None) -> list[dict]:
        """Decode the flight recorder's ring (needs ``recorder=``):
        ``shard=None`` gives the global per-window rows (counter and
        histogram lanes summed over the shards), an int that shard's
        view."""
        if self.recorder is None:
            raise RuntimeError("engine was built without a flight "
                               "recorder (pass recorder=RecorderConfig())")
        ring = self._carry[4]
        with self._on_stream():          # behind the windows that wrote it
            if shard is None:
                return obs_recorder.global_rows(ring, self.n_shards)
            return obs_recorder.ring_rows(obs_recorder.ring_shard(ring,
                                                                  shard))

    def _drain(self):
        """Quiesce: zero-traffic segments until backlog and fabric are
        empty (bounded), then the final uncredited walk."""
        nw = self.cfg.seg_windows
        with self._on_stream():
            for _ in range(self.cfg.max_drain_segments):
                if (self.backlog_events() == 0
                        and self.in_fabric_events() == 0):
                    break
                win0 = self._win
                self._carry, ws = self._segment(self._carry, self._zero_fw,
                                                self._zero_fc, win0)
                self._win += nw
                self._drain_windows += nw
                self._absorb(ws, win0)
            with self.tracer.span("drain/walk", track="spike-device",
                                  win0=self._win):
                state, walk = self._drain_walk(self._carry, self._win)
                s1, d1, s2, d2 = self._ready(walk)
                zero = np.zeros(tuple(d1.shape), np.int64)
                for s, d in ((s1, d1), (s2, d2)):
                    self.ledger.add_windows(d.numpy(), zero, s.hist.numpy(),
                                            s.max_us.numpy(),
                                            s.mean_us.numpy())
            S, T, C = self.n_shards, self.n_tenants, self.cfg.capacity
            z = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                           device=self.device)
            # the ring (carry[4:]) survives, so the rows cover the run
            self._carry = (state, z(S, T, S, C), z(S, T, S, C),
                           z(S, T, S)) + self._carry[4:]
            if self._stream is not None:
                self._stream.synchronize()

    def stop(self, drain: bool = True, timeout: float = 120.0
             ) -> EngineReport:
        """Graceful shutdown: stop ingestion, finish staged segments,
        drain the fabric, verify per-tenant conservation, report."""
        if self._ingest_t is None:
            raise RuntimeError("engine not started")
        self._stop_evt.set()
        self._ingest_t.join(timeout)
        self._device_t.join(timeout)
        if self._ingest_t.is_alive() or self._device_t.is_alive():
            raise RuntimeError("engine threads failed to stop in time "
                               "(ingest alive=%s device alive=%s)" % (
                                   self._ingest_t.is_alive(),
                                   self._device_t.is_alive()))
        self._ingest_t = self._device_t = None
        if self._device_error is not None:
            raise RuntimeError("the engine's device thread failed") \
                from self._device_error
        if drain:
            self._drain()
            self.ledger.check_conservation()
        wall = max(self._t1 - self._t0, 1e-9)
        return EngineReport(
            tenants=self.ledger.digests(),
            injected=self.ledger.injected.copy(),
            delivered=self.ledger.delivered.copy(),
            shed=self.ledger.shed.copy(),
            clipped=self.ledger.clipped.copy(),
            windows=self._windows,
            drain_windows=self._drain_windows,
            wall_s=wall,
            events_per_s=float(self.ledger.delivered.sum()) / wall,
            conservation_checked=bool(drain),
        )

    def run(self, n_segments: int, drain: bool = True,
            timeout: float = 300.0) -> EngineReport:
        """Bounded serving run: ``n_segments`` segments, then stop."""
        self.start(max_segments=n_segments)
        self._device_t.join(timeout)
        return self.stop(drain=drain, timeout=timeout)
