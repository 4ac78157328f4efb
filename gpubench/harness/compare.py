"""Holding what the program produced to what the reference produced.

A :class:`Tally` walks two trees of (named) tuples of tensors field by
field, by the reference's field names, and keeps two numbers: the integer
and boolean elements that differ, and the widest gap of a floating-point
field, ``max |a - b|`` over the larger of the two tensors' largest
magnitudes (so every field is read on its own scale).
"""
from __future__ import annotations

import math

import torch


class Reservoir:
    """Segment 0 and a uniform sample of ``k`` of the later segments, drawn
    from ``rng`` as the segments come (algorithm R), so what is held stays
    flat however many segments a window runs.  ``kept`` maps a segment's
    index to what was offered with it."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.kept, self.seen = k, rng, {}, 0

    def offer(self, j: int, item) -> None:
        if j == 0:
            self.kept[0] = item
            return
        self.seen += 1
        if self.seen <= self.k:
            self.kept[j] = item
        elif self.rng.random() < self.k / self.seen:
            later = sorted(x for x in self.kept if x != 0)
            del self.kept[later[int(self.rng.integers(self.k))]]
            self.kept[j] = item


class Tally:
    def __init__(self):
        self.mismatched = 0
        self.float_gap = 0.0

    def tensor(self, a, b) -> int:
        """Add one pair; -> the integer elements that differ in it."""
        if a is None or b is None:
            bad = int(a is not b)
            self.mismatched += bad
            return bad
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        if a.shape != b.shape:
            bad = max(a.numel(), b.numel(), 1)
            self.mismatched += bad
            return bad
        if a.numel() == 0:
            return 0
        if b.dtype.is_floating_point or a.dtype.is_floating_point:
            a64, b64 = a.to(torch.float64).cpu(), b.to(torch.float64).cpu()
            d = float((a64 - b64).abs().max())
            scale = max(float(a64.abs().max()), float(b64.abs().max()),
                        1e-30)
            gap = math.inf if math.isnan(d) else d / scale
            self.float_gap = max(self.float_gap, gap)
            return 0
        bad = int((a.cpu().to(torch.int64) != b.cpu().to(torch.int64)).sum())
        self.mismatched += bad
        return bad

    def tree(self, a, b) -> int:
        """Add every field of the reference tree ``b`` against the same
        field of ``a``; -> the integer elements that differ."""
        if isinstance(b, tuple) and hasattr(b, "_fields"):
            return sum(self.tree(getattr(a, f, None), getattr(b, f))
                       for f in b._fields)
        if isinstance(b, (tuple, list)):
            if not isinstance(a, (tuple, list)) or len(a) != len(b):
                self.mismatched += 1
                return 1
            return sum(self.tree(x, y) for x, y in zip(a, b))
        return self.tensor(a, b)


def window_of(stacked, i: int, axis: int = 1):
    """Window ``i`` of a tree stacked along dimension ``axis``."""
    if stacked is None:
        return None
    if isinstance(stacked, tuple):
        return type(stacked)(*(window_of(x, i, axis) for x in stacked))
    return stacked[(slice(None),) * axis + (i,)]


def cat_windows(trees):
    """Concatenate trees stacked as ``(S, n, ...)`` along the windows."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(cat_windows(list(x)) for x in zip(*trees)))
    return torch.cat(trees, dim=1)
