"""Kernel B's decode (``csrc/wire_codec.cu``): one launch over every slot
of every (tenant, source, destination) row, ``n_shards``^2 x ``capacity``
words (x ``n_tenants`` where tenants share the fabric), each read as two
4-byte lanes and written back as an event word and its meta (16 B a
word, about 10 integer operations)."""

# the device function's name in a profiler trace
PATTERN = r"\bdecode_kernel\b"


def count(z: dict) -> tuple[float, float]:
    words = z.get("n_tenants", 1) * z["n_shards"] ** 2 * z["capacity"]
    return 16 * words, 10 * words
