"""The benchmark runs the port alone: no JAX and nothing of the JAX
package or of its CPU benchmarks may be loaded in the process that prints
the result.  Names are compared by their top-level part, whole, since the
port's package name begins with the JAX package's."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)
