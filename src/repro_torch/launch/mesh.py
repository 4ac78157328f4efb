"""Mesh construction (port of ``src/repro/launch/mesh.py``).

On one card every mesh is virtual: :class:`Mesh` is only the axis names
and sizes, with no device behind them.  The port's sharded paths read it
to lay a mesh axis out as a leading tensor dimension (the rule the port
has followed since the exchange: ``all_to_all`` becomes a transpose,
``psum`` / ``pmax`` / ``pmean`` a sum, max or mean over that dimension,
and ``with_sharding_constraint`` changes no value), and the dry run reads
it to count each device's share of a sharded state.

The reference's layouts are kept: ``("data", "model")`` puts data / FSDP
parallelism on the long torus dimension and tensor / expert parallelism
on the short one, ``pod`` is the inter-pod hop, and the spike fabric runs
on a 1-D ``"wafer"`` axis whose torus folding is
:func:`wafer_torus_shape`.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A virtual device mesh: named axes and their sizes."""

    shape: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")

    @property
    def sizes(self) -> dict:
        """{axis name: size}."""
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        """The number of (virtual) devices."""
        return math.prod(self.shape)

    def axis_size(self, axes) -> int:
        """The product of the sizes of ``axes`` (a name, a tuple of names
        or None); axes the mesh lacks count 1."""
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.sizes.get(a, 1) for a in axes)

    def __str__(self) -> str:
        return "x".join(map(str, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 (data, model), or 2 x 16 x 16 (pod, data, model)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_test_mesh(n_data: int = 2, n_model: int = 4,
                   pods: int = 0) -> Mesh:
    """A small (data, model) mesh, with a leading pod axis if ``pods``."""
    if pods:
        return Mesh((pods, n_data, n_model), ("pod", "data", "model"))
    return Mesh((n_data, n_model), ("data", "model"))


def batch_axes(mesh: Mesh) -> tuple:
    """The mesh axes the batch is split over: pod and data, where present."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def make_wafer_mesh(n_shards: int, axis: str = "wafer") -> Mesh:
    """1-D mesh of the spike-exchange fabric (one shard per position)."""
    return Mesh((n_shards,), (axis,))


def wafer_torus_shape(n_shards: int, ndim: int = 2) -> tuple:
    """The rings a torus transport folds ``n_shards`` onto: ``ndim=2``
    most-square (nx, ny), 8 -> (2, 4), the paper's per-wafer concentrator
    face; ``ndim=3`` most-cubic (nx, ny, nz), 8 -> (2, 2, 2)."""
    from repro_torch.transport.torus import default_shape, default_shape3d
    if ndim == 3:
        return default_shape3d(n_shards)
    return default_shape(n_shards)


def wafer_wire_format(profile: str = "extoll"):
    """The wire profile of the wafer fabric's links (``"extoll"`` or
    ``"ethernet"``), as ``repro_torch.wire.framing.WireFormat``."""
    from repro_torch.wire import get_profile
    return get_profile(profile)
