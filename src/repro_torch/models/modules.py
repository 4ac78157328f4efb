"""Parameter specs and their materialisation (port of
``src/repro/models/modules.py``).

An architecture's parameters are a nested dict of :class:`ParamSpec`
(shape, logical axes, dtype, initializer); :func:`init_params` turns it
into a nested dict of tensors, :func:`abstract_params` into one of
``meta`` tensors (shapes and dtypes, nothing allocated).  The logical axis
names are what ``distributed.sharding`` maps onto a mesh.

Random draws: the reference folds Python's salted ``hash()`` of each
leaf's path into its key, so its parameters differ from process to
process and cannot be reproduced.  Here each leaf draws from its own
``torch.Generator`` seeded from the caller's generator seed and the
``zlib.crc32`` of the leaf's path, so a leaf's values depend only on the
seed and its path.  Parity with the reference goes through
``repro_torch.convert.params_from_reference``.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any

import torch

from repro_torch.kernels import dispatch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                    # logical axis name per dim (None ok)
    dtype: Any = torch.float32
    init: str = "normal"           # normal | zeros | ones | embed | small
    scale: float | None = None     # stddev override

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in length")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_paths(tree, prefix=()):
    """Yield (path_tuple, ParamSpec) leaves of a nested-dict spec tree."""
    if is_spec(tree):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from tree_paths(tree[k], prefix + (k,))


def tree_map_specs(fn, tree):
    """``fn`` applied to every ParamSpec leaf; the same nesting."""
    if is_spec(tree):
        return fn(tree)
    return {k: tree_map_specs(fn, v) for k, v in tree.items()}


def _fan_in(spec: ParamSpec) -> int:
    """Fan-in = product of input dims; leading stack axes (layers/expert)
    don't contribute.  Convention: last axis is the output dim."""
    dims = [d for d, a in zip(spec.shape[:-1], spec.axes[:-1])
            if a not in ("layers", "expert")]
    return math.prod(dims) if dims else max(spec.shape[-1], 1)


def _std(spec: ParamSpec) -> float:
    if spec.scale is not None:
        return spec.scale
    if spec.init == "embed":
        return 1.0
    if spec.init == "small":
        return 0.02
    return 1.0 / math.sqrt(max(_fan_in(spec), 1))


def _leaf_seed(seed: int, path: tuple) -> int:
    """Seed of one leaf: the caller's seed and the crc32 of its path."""
    return (seed * 0x9E3779B1 + zlib.crc32("/".join(map(str, path)).encode())
            ) % (2**63 - 1)


def _initializer(spec: ParamSpec, seed: int, dtype, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init not in ("normal", "embed", "small"):
        raise ValueError(f"unknown init {spec.init!r}")
    gen = torch.Generator(device=device).manual_seed(seed)
    # drawn in f32 and rounded once, as the reference does
    out = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                      device=device)
    return out.mul_(_std(spec)).to(dtype)


def init_params(spec_tree, generator: torch.Generator, param_dtype=None,
                device=None) -> dict:
    """Materialise parameters on ``device`` (``None`` is CUDA).  Each leaf
    draws from its own generator, seeded from ``generator.initial_seed()``
    and its path, so adding or removing a leaf never changes another."""
    device = dispatch.resolve_device(device)
    seed = generator.initial_seed()

    def rec(tree, prefix=()):
        if is_spec(tree):
            return _initializer(tree, _leaf_seed(seed, prefix),
                                param_dtype or tree.dtype, device)
        return {k: rec(v, prefix + (k,)) for k, v in tree.items()}

    return rec(spec_tree)


def abstract_params(spec_tree, param_dtype=None) -> dict:
    """The parameter tree as ``meta`` tensors (the reference's
    ``ShapeDtypeStruct`` tree)."""
    return tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=param_dtype or s.dtype,
                              device="meta"), spec_tree)


def param_count(spec_tree) -> int:
    return sum(math.prod(s.shape) for _, s in tree_paths(spec_tree))


def param_bytes(spec_tree, param_dtype=None) -> int:
    def nbytes(s: ParamSpec):
        dtype = param_dtype or s.dtype
        return math.prod(s.shape) * torch.empty((), dtype=dtype).element_size()
    return sum(nbytes(s) for _, s in tree_paths(spec_tree))
