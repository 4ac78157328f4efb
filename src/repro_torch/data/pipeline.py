"""Data pipeline: deterministic synthetic LM batches behind a ring-buffer
prefetcher with credit-based flow control (port of
``src/repro/data/pipeline.py``), the paper's §2.1 host <-> device
discipline applied to input feeding.

The producer thread fills a bounded ring of prepared batches; the consumer
(the training loop) drains it and returns credits.  A batch is a pure
function of ``(seed, step)``, drawn with the reference's numpy calls, so
the tokens equal the reference's bit for bit and the pipeline's cursor in
a checkpoint is the step counter.  Batches are CPU ``int32`` tensors; the
trainer moves them to its device, through :func:`shard_batch` when it has
a mesh.
"""
from __future__ import annotations

import dataclasses
import queue as _q
import threading

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    ring_slots: int = 4          # prefetch depth (credits)


def synthetic_batch(cfg: DataConfig, step: int) -> dict:
    """Deterministic (seed, step) -> batch: Zipf(1.3) ranks folded into the
    vocabulary (a realistic skew for MoE routing and vocab gathers) and
    the shifted next-token labels, both (global_batch, seq_len) int32."""
    rng = np.random.default_rng(np.uint64(cfg.seed) + np.uint64(step) * 9973)
    z = rng.zipf(1.3, size=(cfg.global_batch, cfg.seq_len + 1))
    tokens = (z % (cfg.vocab - 2)).astype(np.int32) + 1
    return {"tokens": torch.from_numpy(np.ascontiguousarray(tokens[:, :-1])),
            "labels": torch.from_numpy(np.ascontiguousarray(tokens[:, 1:]))}


class RingPrefetcher:
    """Bounded prefetch ring with explicit credit accounting.

    The producer thread may only produce while it holds credits (free
    slots); the consumer returns a credit per batch taken.  ``stats()``
    exposes the producer's stalls, so a run shows the throughput / slots
    trade-off.
    """

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 make=synthetic_batch):
        self.cfg = cfg
        self.step = start_step
        self.make = make
        self.ring: _q.Queue = _q.Queue(maxsize=cfg.ring_slots)
        self.produced = 0
        self.consumed = 0
        self.producer_stalls = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.make(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self.ring.put((step, batch), timeout=0.05)
                    break
                except _q.Full:
                    self.producer_stalls += 1
            self.produced += 1
            step += 1

    def next(self):
        step, batch = self.ring.get()
        self.consumed += 1
        return step, batch

    def stats(self) -> dict:
        return {"produced": self.produced, "consumed": self.consumed,
                "producer_stalls": self.producer_stalls,
                "in_flight": self.ring.qsize()}

    def close(self):
        self._stop.set()
        try:
            while True:
                self.ring.get_nowait()
        except _q.Empty:
            pass
        self._thread.join(timeout=1.0)


def shard_batch(batch: dict, mesh, batch_axes=("data",), device=None):
    """Place a host batch whole on the device (``None`` is CUDA).  The
    reference splits its leading (batch) dimension over ``batch_axes``;
    on the virtual ``mesh`` nothing is split, and only the division is
    checked: ``ValueError`` where the reference's ``device_put`` would
    raise, a batch the data axes do not divide.  Changes no value."""
    from repro_torch.kernels import dispatch
    n = mesh.axis_size(tuple(batch_axes))
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"divide over the {n} ranks of {batch_axes} "
                             f"on mesh {mesh}")
    device = dispatch.resolve_device(device)
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}
