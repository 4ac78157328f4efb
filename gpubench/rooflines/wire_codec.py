"""Kernel B (``csrc/wire_codec.cu``), encode or decode: one launch over
every slot of every (tenant, source, destination) row, ``n_shards``^2 x
``capacity`` words (x ``n_tenants`` where tenants share the fabric), each
8 B read and 8 B written (event and meta <-> two lanes), about 10 integer
operations a word."""

# the device function's name in a profiler trace
PATTERN = r"\b(en|de)code_kernel\b"


def count(z: dict) -> tuple[float, float]:
    words = z.get("n_tenants", 1) * z["n_shards"] ** 2 * z["capacity"]
    return 16 * words, 10 * words
