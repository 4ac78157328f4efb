"""Kernel C's alpha form (``csrc/lif_step.cu``, ``lif_alpha_window_kernel``):
``window`` dt steps of the ``n_shards`` x ``per_shard`` neurons in one
launch, with the post-spike archive.

The state (v, two currents and their derivatives, refractory count) read
once and written once, 24 + 24 B; the archive's count read and written
and its newest entry read, 16 B; per step two ring slots read (8 B), the
drive read (4 B), the two slots cleared (8 B) and a spike written (1 B);
per spike an archive entry written (8 B, ``spikes_per_window``).  About
25 float operations a neuron and step."""

# the device function's name in a profiler trace
PATTERN = r"\blif_alpha_window_kernel\b"


def count(z: dict) -> tuple[float, float]:
    n, w = z["n_shards"] * z["per_shard"], z["window"]
    return (n * (24 + 24 + 16 + w * (12 + 8 + 1))
            + 8 * z["spikes_per_window"], n * 25 * w)
