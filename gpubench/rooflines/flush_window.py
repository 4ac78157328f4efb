"""Kernel A, the flush window (``csrc/flush_window.cu``): one launch per
window over the ``n_shards`` shards, each ranking and placing its input
words into ``capacity`` slots a destination shard.

A shard's input is the re-offered residue (``residue``), the compacted
spikes times their fan-out (``e_max`` x ``max_fan``) and, on a credited
fabric, the rows the exchange sent back (``n_shards`` x ``capacity``).
Each input read once: the words and their meta (8 B an event), the
destination-table entries the valid words address (``offered_per_window``,
4 B each); each output written once: every slot of every destination's
row as event, meta and two wire lanes (16 B), the counts, the residue and
its meta, four scalars a shard.  About 30 integer operations an input
word (route, rank, place, encode)."""

# the device function's name in a profiler trace
PATTERN = r"\bflush_window_kernel\b"


def count(z: dict) -> tuple[float, float]:
    b, c, r = z["n_shards"], z["capacity"], z["residue"]
    n = (b * c if z["credited"] else 0) + r + z["e_max"] * z["max_fan"]
    n_bytes = (8 * b * n + 4 * z["offered_per_window"] + 16 * b * b * c
               + 4 * b * b + 8 * b * r + 16 * b)
    return n_bytes, 30 * b * n
