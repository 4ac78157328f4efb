"""Kernel F, the credited torus's admission replay (``csrc/admission.cu``),
one launch per window over the ``n_shards``^2 (source, destination) rows
and the torus's 2 x ``len(torus)`` egress links a shard, routes of up to
the torus's diameter in hops.

Each input read once: the offered counts and the three transit tables
(4 B a row each), the credits and held units (4 B a link), the epoch, the
default routes (4 B a hop a row) and their lengths; each output written
once: nine int32 and three bool tables over the rows, three per-link
arrays.  Its work is a chain of dependent steps, not operations a peak
rate bounds, so no operations are counted."""

# the device function's name in a profiler trace
PATTERN = r"\badmission_kernel\b"


def count(z: dict) -> tuple[float, float]:
    rows, k = z["n_shards"] ** 2, z["n_shards"] * 2 * len(z["torus"])
    h = max(sum(d - 1 for d in z["torus"]), 1)
    read = 4 * rows * 4 + 4 * k * 2 + 4 + 4 * rows * h + 4 * rows
    write = 4 * rows * 9 + rows * 3 + 4 * k * 3
    return read + write, 0
