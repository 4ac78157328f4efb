"""Delivery through the sparse synapse store
(``csrc/synapse_deliver.cu``): one launch per window over every
destination shard.  What must move: each synapse delivered read once,
target and weight (8 B, ``synapses_per_window``), and each received event
word read once (4 B, ``delivered_per_window``); both from the traced
segments.  The ring rows it updates are left out, as are the list bounds
it searches; no operation count (one add a synapse)."""

# the device function's name in a profiler trace
PATTERN = r"\bsynapse_deliver_kernel\b"


def count(z: dict) -> tuple[float, float]:
    return 8 * z["synapses_per_window"] + 4 * z["delivered_per_window"], 0
