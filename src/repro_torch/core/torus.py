"""3-D torus topology model (port of ``src/repro/core/torus.py``, paper §1).

Extoll nodes are connected as a 3-D torus with dimension-ordered routing;
the BrainScaleS arrangement gathers 6 FPGAs at each of 8 concentrator
nodes per wafer, and the concentrators are the torus nodes.  Host-side
numpy analysis: address <-> coordinate mapping, dimension-ordered route
enumeration (the routes ``transport.torus`` spends credits on), hop
counts, per-link loads of a traffic matrix, and the fault detours: each
axis segment walked the short or the long way around its ring
(``axis_segment_links``, ``route_links_detour``, ``route_links_avoiding``),
from which the credited torus builds its detour tables.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

# paper constants
FPGAS_PER_WAFER = 48
CONCENTRATORS_PER_WAFER = 8
FPGAS_PER_CONCENTRATOR = 6
HICANNS_PER_FPGA = 8
LANES_PER_LINK = 12
GBIT_PER_LANE = 8.4
LINK_GBYTES = LANES_PER_LINK * GBIT_PER_LANE / 8.0   # 12.6 GB/s per link
LINKS_PER_NODE = 7                                    # Tourmalet: 7 links


@dataclasses.dataclass(frozen=True)
class Torus:
    """A (nx, ny, nz) 3-D torus of Extoll nodes; node id
    ``(z * ny + y) * nx + x``."""

    nx: int
    ny: int
    nz: int

    @property
    def n_nodes(self) -> int:
        return self.nx * self.ny * self.nz

    def coords(self, node):
        node = np.asarray(node)
        return (node % self.nx, (node // self.nx) % self.ny,
                node // (self.nx * self.ny))

    def node_id(self, x, y, z) -> np.ndarray:
        return ((np.asarray(z) * self.ny + np.asarray(y)) * self.nx
                + np.asarray(x))

    # -- dimension-ordered routing ---------------------------------------
    def _axis_steps(self, a: int, b: int, n: int):
        """Shortest signed ring walk a -> b on an n-ring (ties go +)."""
        fwd = (b - a) % n
        bwd = (a - b) % n
        step = 1 if fwd <= bwd else -1
        return [(a + step * i) % n for i in range(1, min(fwd, bwd) + 1)]

    def route(self, src: int, dst: int) -> list:
        """Dimension-ordered (X, then Y, then Z) route as node ids."""
        sx, sy, sz = (int(v) for v in self.coords(src))
        dx, dy, dz = (int(v) for v in self.coords(dst))
        path = [src]
        path += [int(self.node_id(x, sy, sz))
                 for x in self._axis_steps(sx, dx, self.nx)]
        path += [int(self.node_id(dx, y, sz))
                 for y in self._axis_steps(sy, dy, self.ny)]
        path += [int(self.node_id(dx, dy, z))
                 for z in self._axis_steps(sz, dz, self.nz)]
        return path

    def link_dir(self, u: int, v: int) -> int:
        """Direction 0..5 (x+, x-, y+, y-, z+, z-) of the ring hop u -> v;
        raises if the nodes are not ring neighbours."""
        ux, uy, uz = (int(c) for c in self.coords(u))
        vx, vy, vz = (int(c) for c in self.coords(v))
        if (uy, uz) == (vy, vz) and ux != vx:
            return 0 if (vx - ux) % self.nx == 1 else 1
        if (ux, uz) == (vx, vz) and uy != vy:
            return 2 if (vy - uy) % self.ny == 1 else 3
        if (ux, uy) == (vx, vy) and uz != vz:
            return 4 if (vz - uz) % self.nz == 1 else 5
        raise ValueError(f"{u} -> {v} is not a single ring hop")

    def route_links(self, src: int, dst: int) -> list:
        """The route as ordered (node, direction) egress links: the
        credit unit of the torus transports."""
        path = self.route(src, dst)
        return [(u, self.link_dir(u, v)) for u, v in zip(path[:-1], path[1:])]

    # -- fault-aware detours ----------------------------------------------
    def _ring_walk(self, a: int, b: int, n: int, longway: bool = False):
        """Signed ring walk a -> b: (step, dist); ``longway`` reverses the
        shortest direction and walks the other ``n - dist`` hops."""
        fwd = (b - a) % n
        bwd = (a - b) % n
        step = 1 if fwd <= bwd else -1            # same tie-break as route
        dist = min(fwd, bwd)
        if longway and dist > 0:
            step, dist = -step, n - dist
        return step, dist

    def axis_segment_links(self, src: int, dst: int, axis: int,
                           longway: bool = False) -> list:
        """The (node, direction) links of the ``axis`` segment of the
        dimension-ordered route src -> dst, short arc or the long way
        around.  The direction follows the walk's step sign, not the
        coordinate delta: on a 2-ring both neighbours are one hop away and
        the + and - cables are distinct.  Axis ``a`` starts at coordinates
        ``(d_0..d_{a-1}, s_a, .., s_2)`` whichever arcs earlier axes took."""
        sc = [int(v) for v in self.coords(src)]
        dc = [int(v) for v in self.coords(dst)]
        dims = (self.nx, self.ny, self.nz)
        at = list(dc[:axis]) + list(sc[axis:])    # segment start coords
        step, dist = self._ring_walk(sc[axis], dc[axis], dims[axis], longway)
        direction = 2 * axis + (0 if step > 0 else 1)
        links = []
        c = sc[axis]
        for _ in range(dist):
            at[axis] = c
            links.append((int(self.node_id(*at)), direction))
            c = (c + step) % dims[axis]
        return links

    def route_links_detour(self, src: int, dst: int,
                           flips=(False, False, False)) -> list:
        """The route as (node, direction) links with each flipped axis
        walking its ring the long way; no flips is :meth:`route_links`."""
        return [l for a in range(3)
                for l in self.axis_segment_links(src, dst, a, flips[a])]

    def route_links_avoiding(self, src: int, dst: int, down):
        """Per axis, the long way around when the short arc crosses a link
        in ``down`` (a set of (node, direction) pairs) and the long arc is
        clean -> ``(links, flips)``, or ``None`` when some axis is dead both
        ways: the host oracle of the transport's reroute decision."""
        down = set(down)
        flips = []
        for a in range(3):
            short = self.axis_segment_links(src, dst, a, longway=False)
            if not any(l in down for l in short):
                flips.append(False)
                continue
            if any(l in down
                   for l in self.axis_segment_links(src, dst, a, True)):
                return None
            flips.append(True)
        flips = tuple(flips)
        return self.route_links_detour(src, dst, flips), flips

    def hops(self, src, dst) -> np.ndarray:
        """Vectorized hop count (sum of shortest ring distances per axis)."""
        sx, sy, sz = self.coords(np.asarray(src))
        dx, dy, dz = self.coords(np.asarray(dst))

        def ring(a, b, n):
            f = (b - a) % n
            return np.minimum(f, n - f)

        return (ring(sx, dx, self.nx) + ring(sy, dy, self.ny)
                + ring(sz, dz, self.nz))

    # -- link loads -------------------------------------------------------
    def link_loads_scalar(self, traffic: np.ndarray) -> dict:
        """Oracle of :meth:`link_loads`: route every pair with
        :meth:`route` (O(n²) Python)."""
        loads: dict = {}
        n = self.n_nodes
        for s, d in itertools.product(range(n), range(n)):
            b = float(traffic[s, d])
            if b <= 0 or s == d:
                continue
            path = self.route(s, d)
            for u, v in zip(path[:-1], path[1:]):
                loads[(u, v)] = loads.get((u, v), 0.0) + b
        return loads

    def _ring_segment(self, loads, a, target, n_ring, bytes_, node_of,
                      dir_base: int):
        """Accumulate one dimension-ordered ring walk of every pair into
        the (n_nodes, 6) ``loads``."""
        fwd = (target - a) % n_ring
        bwd = (a - target) % n_ring
        step = np.where(fwd <= bwd, 1, -1)          # same tie-break as route
        dist = np.minimum(fwd, bwd)
        for i in range(int(dist.max(initial=0))):
            m = dist > i
            u = (a[m] + step[m] * i) % n_ring
            np.add.at(loads, (node_of(u, m), dir_base + (step[m] < 0)),
                      bytes_[m])

    def link_loads(self, traffic: np.ndarray) -> dict:
        """Route a (n_nodes, n_nodes) byte traffic matrix; returns
        {(u, v): bytes} for every directed link used (vectorized over
        pairs, equal to :meth:`link_loads_scalar`)."""
        t = np.asarray(traffic, dtype=float)
        n = self.n_nodes
        mask = t > 0
        np.fill_diagonal(mask, False)
        src, dst = np.nonzero(mask)
        bytes_ = t[src, dst]
        sx, sy, sz = self.coords(src)
        dx, dy, dz = self.coords(dst)
        loads = np.zeros((n, 6))
        self._ring_segment(loads, sx, dx, self.nx, bytes_,
                           lambda u, m: self.node_id(u, sy[m], sz[m]), 0)
        self._ring_segment(loads, sy, dy, self.ny, bytes_,
                           lambda u, m: self.node_id(dx[m], u, sz[m]), 2)
        self._ring_segment(loads, sz, dz, self.nz, bytes_,
                           lambda u, m: self.node_id(dx[m], dy[m], u), 4)
        ids = np.arange(n)
        x, y, z = self.coords(ids)
        neighbor = [
            self.node_id((x + 1) % self.nx, y, z),
            self.node_id((x - 1) % self.nx, y, z),
            self.node_id(x, (y + 1) % self.ny, z),
            self.node_id(x, (y - 1) % self.ny, z),
            self.node_id(x, y, (z + 1) % self.nz),
            self.node_id(x, y, (z - 1) % self.nz),
        ]
        out: dict = {}
        for d in range(6):
            for u in np.nonzero(loads[:, d])[0]:
                key = (int(u), int(neighbor[d][u]))
                out[key] = out.get(key, 0.0) + loads[u, d]
        return out


def wafer_topology(n_wafers: int) -> Torus:
    """The paper's arrangement: each wafer's 8 concentrators form a 2x4
    XY face, wafers stacked along Z."""
    return Torus(nx=2, ny=4, nz=max(n_wafers, 1))


def microcircuit_traffic(n_nodes: int, events_per_s: float,
                         locality: float = 0.7) -> np.ndarray:
    """Synthetic traffic matrix (bytes/s): ``locality`` stays on the node,
    the rest is uniform over the others."""
    m = np.full((n_nodes, n_nodes), (1 - locality) / max(n_nodes - 1, 1))
    np.fill_diagonal(m, 0.0)
    return m / max(m.sum(), 1e-9) * events_per_s * 4.0   # 4 B/event payload
