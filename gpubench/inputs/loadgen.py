"""Seeded open-loop spike traffic for the serving cells (the benchmark's
copy of the port's ``serve/loadgen.py``: ``PoissonLoadGen`` and its draws,
unchanged in behaviour).

Open loop: window ``k``'s traffic is a pure function of ``(seed, tenant,
k)``, drawn whether or not the fabric kept up, so a quiet tenant sees the
same arrivals beside a saturating co-tenant as alone.  Each tenant's
fabric-wide rate (events a window, times ``burst_factor`` in a window that
bursts with probability ``burst_prob``) is split evenly over the ``S(S-1)``
off-diagonal (src, dst) pairs, drawn per pair as a Poisson count and
clipped to the row capacity, the clipped remainder counted.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

# the 30-bit spike event word: 15-bit timestamp, 14-bit address, valid bit
TS_BITS, ADDR_BITS = 15, 14
TS_MASK, ADDR_MASK = (1 << TS_BITS) - 1, (1 << ADDR_BITS) - 1
VALID_BIT = 1 << (TS_BITS + ADDR_BITS)


def traffic_rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of substream ``stream`` (e.g. ``(tenant, window)``)."""
    return np.random.default_rng((int(seed) * 7919 + 13,
                                  *(int(s) for s in stream)))


def draw_events(rng: np.random.Generator, shape) -> np.ndarray:
    """Valid spike event words: random address and timestamp, valid bit."""
    addr = rng.integers(0, ADDR_MASK + 1, size=shape,
                        dtype=np.uint64).astype(np.uint32)
    ts = rng.integers(0, TS_MASK + 1, size=shape,
                      dtype=np.uint64).astype(np.uint32)
    word = ((addr & ADDR_MASK) << TS_BITS) | (ts & TS_MASK)
    return (word | np.uint32(VALID_BIT)).astype(np.uint32)


class TenantProfile(NamedTuple):
    name: str
    rate_epw: float
    burst_factor: float = 1.0
    burst_prob: float = 0.0


class WindowTraffic(NamedTuple):
    counts: np.ndarray    # (T, S, S) int32 events per (tenant, src, dst)
    words: np.ndarray     # (T, S, S, C) uint32 event words
    clipped: np.ndarray   # (T,) int64 events beyond the row capacity


class PoissonLoadGen:
    """``next_window(k)`` -> :class:`WindowTraffic` of window ``k``."""

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
