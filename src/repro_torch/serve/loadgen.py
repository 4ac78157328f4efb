"""Seeded open-loop traffic generation (port of
``src/repro/serve/loadgen.py``; host numpy, unchanged in behaviour).

Open loop: window ``k``'s traffic is a pure function of ``(seed, tenant,
k)``, drawn whether or not the fabric kept up, so overload shows as
deferred, parked or shed rows and never as a slowed generator.

:func:`traffic_rng` / :func:`draw_counts` / :func:`draw_payload` are the
one seeded source of random traffic, shared by the load generator, the
fault schedules (``fabric.faults.chaos``) and the fabric tests: the same
seed gives the reference's draws bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from repro_torch.core import events as ev


def traffic_rng(seed: int, *stream: int) -> np.random.Generator:
    """The one seeding path for generated traffic.

    ``stream`` keys substreams — e.g. ``traffic_rng(seed, tenant,
    window)`` — so a tenant's window-``k`` traffic is identical across
    runs regardless of what other tenants or windows were drawn (this is
    what lets the QoS tests compare a quiet tenant solo against the same
    quiet tenant next to a saturating co-tenant, event for event).
    """
    return np.random.default_rng((int(seed) * 7919 + 13,
                                  *(int(s) for s in stream)))


def draw_counts(rng: np.random.Generator, shape, hi: int,
                lo: int = 0) -> np.ndarray:
    """Uniform bucket-row event counts in ``[lo, hi]`` (i32)."""
    return rng.integers(lo, hi + 1, size=shape).astype(np.int32)


def draw_payload(rng: np.random.Generator, shape) -> np.ndarray:
    """Opaque u32 payload words (any bit pattern is legal on the wire)."""
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def draw_events(rng: np.random.Generator, shape) -> np.ndarray:
    """Valid spike event words: random address + timestamp, valid bit set
    (the numpy mirror of ``core.events.pack``)."""
    addr = rng.integers(0, ev.ADDR_MASK + 1, size=shape,
                        dtype=np.uint64).astype(np.uint32)
    ts = rng.integers(0, ev.TS_MASK + 1, size=shape,
                      dtype=np.uint64).astype(np.uint32)
    word = ((addr & ev.ADDR_MASK) << ev.TS_BITS) | (ts & ev.TS_MASK)
    return (word | np.uint32(ev.VALID_BIT)).astype(np.uint32)


class TenantProfile(NamedTuple):
    """Open-loop rate/burst profile of one tenant's arrival process.

    rate_epw:     mean events per window across the whole fabric
                  (split evenly over the off-diagonal (src, dst) pairs)
    burst_factor: rate multiplier during a burst window
    burst_prob:   per-window probability of bursting (Bernoulli, from the
                  tenant's own substream)
    """

    name: str
    rate_epw: float
    burst_factor: float = 1.0
    burst_prob: float = 0.0


class WindowTraffic(NamedTuple):
    """One window of generated traffic for all tenants.

    counts:  (T, S, S) i32 events per (tenant, src, dst) bucket row,
             clipped to the row capacity
    words:   (T, S, S, C) u32 event words (slots >= count are invalid)
    clipped: (T,) i64 events beyond row capacity discarded at GENERATION
             (over-offered load the engine never saw; reported separately
             from engine-side shed so neither hides the other)
    """

    counts: np.ndarray
    words: np.ndarray
    clipped: np.ndarray


class PoissonLoadGen:
    """Seeded open-loop Poisson generator with per-tenant profiles.

    Each tenant's per-window fabric-wide rate ``rate_epw`` (optionally
    burst-modulated) is split evenly across the ``S*(S-1)`` off-diagonal
    (src, dst) pairs and drawn per pair as an independent Poisson count —
    the superposition of many sparse spike streams.  Rows are clipped to
    the bucket capacity ``C`` with the clipped remainder *counted*, so
    offered load is exact even at absurd over-subscription.
    """

    def __init__(self, seed: int, profiles: Sequence[TenantProfile],
                 n_shards: int, capacity: int):
        if not profiles:
            raise ValueError("need at least one tenant profile")
        self.seed = int(seed)
        self.profiles = tuple(profiles)
        self.n_shards = int(n_shards)
        self.capacity = int(capacity)

    @property
    def n_tenants(self) -> int:
        return len(self.profiles)

    def next_window(self, window: int) -> WindowTraffic:
        T, S, C = self.n_tenants, self.n_shards, self.capacity
        counts = np.zeros((T, S, S), np.int32)
        words = np.zeros((T, S, S, C), np.uint32)
        clipped = np.zeros((T,), np.int64)
        n_pairs = max(S * (S - 1), 1)
        for t, prof in enumerate(self.profiles):
            rng = traffic_rng(self.seed, t, window)
            lam = prof.rate_epw
            if prof.burst_prob > 0 and rng.random() < prof.burst_prob:
                lam *= prof.burst_factor
            raw = rng.poisson(lam / n_pairs, size=(S, S)).astype(np.int64)
            if S > 1:
                np.fill_diagonal(raw, 0)
            clip = np.minimum(raw, C)
            clipped[t] = int((raw - clip).sum())
            counts[t] = clip.astype(np.int32)
            row_words = draw_events(rng, (S, S, C))
            slot = np.arange(C)[None, None, :]
            words[t] = np.where(slot < clip[..., None], row_words, 0)
        return WindowTraffic(counts=counts, words=words, clipped=clipped)
