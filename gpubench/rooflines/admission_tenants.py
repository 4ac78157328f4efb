"""Kernel F's tenant form (``csrc/admission.cu``, ``admission_tenants``):
one launch per served window over ``n_tenants`` x ``n_shards``^2 rows and
``(n_tenants + 1)`` x the torus's 2 x ``len(torus)`` links a shard of
credit slots (each tenant's slice of a link and the link's shared pool).

Each input read once: the offered counts and four transit tables (4 B a
row each), the credits and held units (4 B a slot), the epoch, the
default routes (4 B a hop a pair) and their lengths (4 B a pair); each
output written once: ten int32 and three bool tables over the rows, three
per-slot arrays.  A chain of dependent steps: no operations counted."""

# the device function's name in a profiler trace
PATTERN = r"\badmission_tenants_kernel\b"


def count(z: dict) -> tuple[float, float]:
    pairs = z["n_shards"] ** 2
    rows = z["n_tenants"] * pairs
    slots = (z["n_tenants"] + 1) * z["n_shards"] * 2 * len(z["torus"])
    hops = max(sum(d - 1 for d in z["torus"]), 1)
    read = 4 * rows * 5 + 4 * slots * 2 + 4 + 4 * pairs * hops + 4 * pairs
    write = 4 * rows * 10 + rows * 3 + 4 * slots * 3
    return read + write, 0
