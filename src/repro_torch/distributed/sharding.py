"""Logical-axis sharding rules -> partition specs (port of
``src/repro/distributed/sharding.py``).

One rules table maps logical parameter axes to (tuples of) mesh axes; a
fallback pass hands unused mesh axes to alternative dims (e.g. when
``n_kv_heads`` isn't divisible by the model axis, a KV cache shards its
sequence instead of replicating).  The divisibility logic lives here and
nowhere else.

A partition spec is a tuple with one entry per dimension: ``None``
(replicated), a mesh axis name, or a tuple of names (the dimension split
over their product), the reference's ``PartitionSpec`` as plain data.
:class:`Sharding` pairs one with a (virtual) :class:`launch.mesh.Mesh`,
as ``NamedSharding`` does.  The same machinery lays out parameters,
optimizer moments (the same tree), inputs and decode caches; on one card
nothing is moved by it: the dry run reads it to count each device's
bytes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models.modules import ParamSpec, tree_map_specs

# default parallelism plan: FSDP over "data", TP/EP over "model",
# pure DP over "pod" (params replicated across pods).
DEFAULT_RULES: dict = {
    "vocab": ("model",),
    "embed": ("data",),          # ZeRO-3: shard params over the data axis
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),              # only via fallback
    "mlp": ("model",),
    "expert": ("model",),
    "layers": (),                # scan dim, never sharded
    "batch": ("pod", "data"),
    "seq": (),
    "state": (),
    None: (),
}

# when a mesh axis goes unused in a param, try these logical dims (in order).
# NOTE deliberately NO "head_dim" fallback: sharding a QKV projection's
# head_dim while Q is head-sharded forces GSPMD to all-gather K/V inside
# the attention loop (the reference measured +0.5 GB a chunk step on
# qwen3) -- kv projections with n_kv % model != 0 stay replicated over
# "model" instead (they are small), and attention still shards via Q
# heads / Q sequence.
# "seq" fallback on the model axis: KV caches whose head counts don't
# divide the model axis (gemma2 kv=8, minicpm kv=36, whisper kv=20, ...)
# shard their sequence dim instead -- decode attention then runs split-KV
# (each rank scans its cache slice; one combine) and a 32k x 128 cache
# drops to a sixteenth a device.
FALLBACKS: dict = {
    "model": ("mlp", "vocab", "seq"),
    "data": ("mlp", "vocab", "seq"),
    "pod": (),
}

# Inference layout: weights stay resident -- no ZeRO over "data" (training
# amortizes the per-layer weight all-gather over a large batch; decode
# re-pays it every token).  Weights replicate over "data" unless they are
# too big (MoE experts pick up "data" on the ff dim via the fallback).
SERVE_RULES: dict = dict(DEFAULT_RULES)
SERVE_RULES["embed"] = ()


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A partition spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Mesh
    spec: tuple

    def shards(self) -> int:
        """How many pieces the spec cuts an array into."""
        return math.prod(self.mesh.axis_size(e) for e in self.spec)


def spec_to_pspec(spec: ParamSpec, mesh: Mesh,
                  rules: Mapping | None = None) -> tuple:
    return axes_to_pspec(spec.axes, spec.shape, mesh, rules)


def axes_to_pspec(axes: Sequence, shape: Sequence[int], mesh: Mesh,
                  rules: Mapping | None = None) -> tuple:
    """The partition spec of an array with logical ``axes`` and ``shape``.

    Pass 1 gives each dimension the mesh axes its rule names, in order,
    while the remaining extent (``cap``, shrunk by each axis taken)
    divides by the axis and no other dimension took it.  Pass 2 offers
    each mesh axis still unused, in ``FALLBACKS``' order, to the first
    unassigned dimension of each of its fallback names that divides.
    """
    rules = rules or DEFAULT_RULES
    msize = mesh.sizes
    used: set = set()
    out: list = [None] * len(shape)

    def try_assign(i: int, mesh_axes) -> None:
        take = []
        cap = shape[i]
        for m in mesh_axes:
            if m not in msize or m in used:
                continue
            if cap % msize[m] == 0 and cap >= msize[m]:
                take.append(m)
                cap //= msize[m]
                used.add(m)
        if take:
            out[i] = tuple(take) if len(take) > 1 else take[0]

    # pass 1: direct rules
    for i, ax in enumerate(axes):
        try_assign(i, rules.get(ax, ()))
    # pass 2: fallbacks for unused mesh axes
    for m, fb_axes in FALLBACKS.items():
        if m in used or m not in msize:
            continue
        for ax in fb_axes:
            i = next((j for j, a in enumerate(axes)
                      if a == ax and out[j] is None), None)
            if i is not None:
                cap = shape[i]
                if cap % msize[m] == 0 and cap >= msize[m]:
                    out[i] = m
                    used.add(m)
                    break
    return tuple(out)


def param_shardings(spec_tree, mesh: Mesh, rules: Mapping | None = None):
    """ParamSpec tree -> Sharding tree (same structure)."""
    return tree_map_specs(
        lambda s: Sharding(mesh, spec_to_pspec(s, mesh, rules)), spec_tree)


def param_pspecs(spec_tree, mesh: Mesh, rules: Mapping | None = None):
    return tree_map_specs(lambda s: spec_to_pspec(s, mesh, rules), spec_tree)


def array_sharding(axes: Sequence, shape: Sequence[int], mesh: Mesh,
                   rules: Mapping | None = None) -> Sharding:
    return Sharding(mesh, axes_to_pspec(axes, shape, mesh, rules))


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of a tree of dicts (sorted keys, as ``jax.tree_util``),
    lists, tuples and NamedTuples; ``None`` is an empty subtree."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str)
                for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v, is_leaf)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same places of
    ``rest``), keeping ``tree``'s structure; leaves are tensors and
    Shardings."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return fn(tree, *rest)


def like_tree(shardings, abstract):
    """Re-associate a sharding tree with an identically-structured value
    tree (e.g. optimizer moments mirroring params)."""
    return tree_map(lambda _, s: s, abstract, shardings)


def bytes_per_device(tree, shardings) -> int:
    """Per-device bytes of a tree of tensors (``meta`` ones allocate
    nothing) under a Sharding tree of the same structure: each leaf's
    bytes divided (floor) by the number of pieces its spec cuts it into."""
    flat_v = tree_leaves(tree)
    flat_s = tree_leaves(shardings, is_leaf=lambda x: isinstance(x,
                                                                 Sharding))
    if len(flat_v) != len(flat_s):
        raise ValueError(f"{len(flat_v)} arrays against {len(flat_s)} "
                         f"shardings")
    total = 0
    for v, s in zip(flat_v, flat_s):
        if isinstance(v, torch.Tensor):
            n = v.numel() * v.element_size()
        else:                    # a Python scalar: 4 bytes, as a 0-d int32
            n = 4
        total += n // max(s.shards(), 1)
    return total


def check_layout(tree, shardings) -> None:
    """Raise ``ValueError`` where the reference's ``device_put`` of
    ``tree`` onto ``shardings`` would: a spec longer than its array, or a
    dimension its mesh axes do not divide.  Nothing is moved."""
    flat_v = tree_leaves(tree)
    flat_s = tree_leaves(shardings,
                         is_leaf=lambda x: isinstance(x, Sharding))
    if len(flat_v) != len(flat_s):
        raise ValueError(f"{len(flat_v)} arrays against {len(flat_s)} "
                         f"shardings")
    for v, s in zip(flat_v, flat_s):
        shape = tuple(v.shape)
        if len(s.spec) > len(shape):
            raise ValueError(f"spec {s.spec} has more entries than shape "
                             f"{shape}")
        for dim, entry in zip(shape, s.spec):
            n = s.mesh.axis_size(entry)
            if dim % n:
                raise ValueError(f"shape {shape}: dimension {dim} does not "
                                 f"divide into {n} shards ({entry}) on mesh "
                                 f"{s.mesh}")
