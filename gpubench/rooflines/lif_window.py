"""Kernel C, the LIF window (``csrc/lif_step.cu``): ``window`` dt steps of
the ``n_shards`` x ``per_shard`` neurons in one launch.

The state (v, two currents, refractory count) read once and written once,
16 + 16 B; per step two ring slots read (8 B), the drive read (4 B), the
two slots cleared (8 B) and a spike written (1 B).  About 15 float
operations a neuron and step."""

# the device function's name in a profiler trace
PATTERN = r"\blif_window_kernel\b"


def count(z: dict) -> tuple[float, float]:
    n, w = z["n_shards"] * z["per_shard"], z["window"]
    return n * (16 + 16 + w * (12 + 8 + 1)), n * 15 * w
