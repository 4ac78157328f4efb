"""3-D torus topology model (frozen from the port's version of ``src/repro/core/torus.py``, paper §1).

Extoll nodes are connected as a 3-D torus with dimension-ordered routing;
the BrainScaleS arrangement gathers 6 FPGAs at each of 8 concentrator
nodes per wafer, and the concentrators are the torus nodes.  Host-side
numpy analysis: address <-> coordinate mapping, dimension-ordered route
enumeration (the routes ``transport.torus`` spends credits on), hop
counts and per-link loads of a traffic matrix.
"""
from __future__ import annotations

import dataclasses

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

    def hops(self, src, dst) -> np.ndarray:
        """Vectorized hop count (sum of shortest ring distances per axis)."""
        sx, sy, sz = self.coords(np.asarray(src))
        dx, dy, dz = self.coords(np.asarray(dst))

        def ring(a, b, n):
            f = (b - a) % n
            return np.minimum(f, n - f)

        return (ring(sx, dx, self.nx) + ring(sy, dy, self.ny)
                + ring(sz, dz, self.nz))
