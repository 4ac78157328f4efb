"""Fault schedules: link and node failures at flush-window granularity
(port of ``src/repro/fabric/faults.py``).

A :class:`FaultSchedule` is an ``(n_windows, K)`` bool table over the
fabric's ``K = n_shards * 2 * ndim`` directed egress links (node-major,
directions ``x+, x-, y+, y-, z+, z-``: the link ids of
``core.flow_control`` and ``core.torus``).  Row ``w`` is the set of dead
links during flush window ``w``; :func:`mask_at` reads it, clamped to the
table.

The caller stamps the window's mask on the fabric state
(``state._replace(link_down=mask_at(sched, w))``) before ``exchange``; the
credited torus transport then spends nothing on a dead link, evicts parked
rows whose remaining route or held arrival link died, and walks each ring
the long way around a dead link (``transport.torus``).

The constructors are host numpy; a directed link dies with its physical
cable: killing ``(u, x+)`` also kills the neighbour's reverse channel
``(v, x-)`` (:func:`cable_links`).  The table lands on ``device``
(``None`` is CUDA, as everywhere in the port).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import dispatch


class FaultSchedule(NamedTuple):
    """Window-granular link-down table, ``(n_windows, K)`` bool; windows
    beyond the table clamp to its last row (a permanent fault stays dead,
    a healed fabric stays healed)."""

    link_down: torch.Tensor

    @property
    def n_windows(self) -> int:
        return int(self.link_down.shape[0])

    @property
    def n_links(self) -> int:
        return int(self.link_down.shape[1])

    def at(self, window) -> torch.Tensor:
        return mask_at(self, window)


def mask_at(schedule: FaultSchedule, window) -> torch.Tensor:
    """(K,) bool link-down mask of ``window`` (an int or an int tensor),
    clamped to the table."""
    last = schedule.link_down.shape[0] - 1
    if isinstance(window, torch.Tensor):
        w = torch.clamp(window.to(schedule.link_down.device).long(), 0, last)
        return schedule.link_down.index_select(0, w.reshape(1))[0]
    return schedule.link_down[min(max(int(window), 0), last)]


def _schedule(down: np.ndarray, device) -> FaultSchedule:
    return FaultSchedule(torch.from_numpy(down).to(
        dispatch.resolve_device(device)))


# -- link-id math (host) ----------------------------------------------------

def n_fabric_links(dims) -> int:
    """K: directed egress links of a ``dims`` torus fabric."""
    dims = tuple(int(d) for d in dims)
    return math.prod(dims) * 2 * len(dims)


def link_id(dims, node: int, direction: int) -> int:
    """Directed egress link id: ``node * 2 * ndim + direction``."""
    dims = tuple(int(d) for d in dims)
    nl = 2 * len(dims)
    if not 0 <= direction < nl:
        raise ValueError(f"direction {direction} out of range for {dims}")
    if not 0 <= node < math.prod(dims):
        raise ValueError(f"node {node} out of range for {dims}")
    return node * nl + direction


def _coords(dims, node: int):
    out = []
    for d in dims:
        out.append(node % d)
        node //= d
    return out


def _node_id(dims, coords) -> int:
    node, stride = 0, 1
    for c, d in zip(coords, dims):
        node += (c % d) * stride
        stride *= d
    return node


def cable_links(dims, node: int, direction: int) -> tuple[int, int]:
    """The two directed link ids of one physical cable: ``(node, axis±)``
    and the neighbour's reverse channel ``(v, axis∓)``.  On a 2-ring the +
    and - cables of a node pair are still distinct (the ring wraps), which
    is why detours work even there."""
    dims = tuple(int(d) for d in dims)
    axis, sign = direction // 2, direction % 2
    c = _coords(dims, node)
    c[axis] = (c[axis] + (1 if sign == 0 else -1)) % dims[axis]
    v = _node_id(dims, c)
    reverse = axis * 2 + (1 - sign)
    return (link_id(dims, node, direction), link_id(dims, v, reverse))


# -- constructors -----------------------------------------------------------

def _empty(dims, n_windows: int) -> np.ndarray:
    return np.zeros((max(int(n_windows), 1), n_fabric_links(dims)), bool)


def _window_range(n_windows: int, start: int, stop: int | None):
    stop = n_windows if stop is None else min(int(stop), n_windows)
    return max(int(start), 0), stop


def healthy(dims, n_windows: int, *, device=None) -> FaultSchedule:
    """No faults, ever."""
    return _schedule(_empty(dims, n_windows), device)


def link_fault(dims, n_windows: int, node: int, direction: int, *,
               start: int = 0, stop: int | None = None,
               device=None) -> FaultSchedule:
    """One cable dead over windows ``[start, stop)`` (default: forever)."""
    down = _empty(dims, n_windows)
    lo, hi = _window_range(down.shape[0], start, stop)
    for l in cable_links(dims, node, direction):
        down[lo:hi, l] = True
    return _schedule(down, device)


def link_flap(dims, n_windows: int, node: int, direction: int, *,
              period: int = 2, start: int = 0,
              device=None) -> FaultSchedule:
    """A flapping cable: dead for ``period`` windows, alive for
    ``period``, repeating from ``start``."""
    period = max(int(period), 1)
    down = _empty(dims, n_windows)
    links = cable_links(dims, node, direction)
    for w in range(max(int(start), 0), down.shape[0]):
        if ((w - start) // period) % 2 == 0:
            for l in links:
                down[w, l] = True
    return _schedule(down, device)


def node_fault(dims, n_windows: int, node: int, *, start: int = 0,
               stop: int | None = None, device=None) -> FaultSchedule:
    """A dropped node: every cable incident to ``node`` (its egress links
    and every neighbour's channel into it) dead over ``[start, stop)``."""
    dims = tuple(int(d) for d in dims)
    down = _empty(dims, n_windows)
    lo, hi = _window_range(down.shape[0], start, stop)
    for direction in range(2 * len(dims)):
        for l in cable_links(dims, node, direction):
            down[lo:hi, l] = True
    return _schedule(down, device)


AXIS_NAMES = "xyz"


def link_label(dims, lid: int) -> str:
    """Human label of a directed link id, e.g. ``"n3:x+"``."""
    dims = tuple(int(d) for d in dims)
    nl = 2 * len(dims)
    node, direction = divmod(int(lid), nl)
    axis, sign = divmod(direction, 2)
    return f"n{node}:{AXIS_NAMES[axis]}{'+' if sign == 0 else '-'}"


def transitions(schedule: FaultSchedule) -> list[dict]:
    """Host fault timeline: one event per link state change, window 0
    diffed against a healthy fabric: ``{"window": w, "event": "link_down"
    | "link_up", "links": [lid, ...]}``."""
    down = schedule.link_down.detach().cpu().numpy().astype(bool)
    prev = np.zeros((down.shape[1],), bool)
    events: list[dict] = []
    for w in range(down.shape[0]):
        died = np.flatnonzero(down[w] & ~prev)
        healed = np.flatnonzero(~down[w] & prev)
        if died.size:
            events.append({"window": int(w), "event": "link_down",
                           "links": died.astype(int).tolist()})
        if healed.size:
            events.append({"window": int(w), "event": "link_up",
                           "links": healed.astype(int).tolist()})
        prev = down[w]
    return events


def chaos(dims, n_windows: int, seed: int, *, revive_p: float = 0.5,
          device=None) -> FaultSchedule:
    """Seeded chaos: every window each dead cable revives with probability
    ``revive_p``, then one uniformly random cable dies.  Draws come from
    ``serve.loadgen.traffic_rng(seed, 0xFA)``, so a run is reproducible
    from ``(dims, n_windows, seed)`` and equals the reference's."""
    from repro_torch.serve.loadgen import traffic_rng
    dims = tuple(int(d) for d in dims)
    n_nodes, nl = math.prod(dims), 2 * len(dims)
    rng = traffic_rng(seed, 0xFA)
    down = _empty(dims, n_windows)
    dead: dict[tuple[int, int], None] = {}
    for w in range(down.shape[0]):
        dead = {cab: None for cab in dead if rng.random() >= revive_p}
        node = int(rng.integers(0, n_nodes))
        direction = int(rng.integers(0, nl))
        dead[cable_links(dims, node, direction)] = None
        for cab in dead:
            for l in cab:
                down[w, l] = True
    return _schedule(down, device)
