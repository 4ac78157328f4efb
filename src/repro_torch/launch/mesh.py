"""Analytic helpers of the wafer fabric's layout (port of the parts of
``src/repro/launch/mesh.py`` that need no device mesh: on one card the
shard axis is a tensor dimension)."""
from __future__ import annotations


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
