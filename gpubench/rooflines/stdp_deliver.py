"""A window's delivery in a network with plastic synapses
(``csrc/synapse_deliver.cu``): the static walk, then the plastic form's
plan, update and walk, four launches a window over every destination
shard.  What must move, from the traced segments' counters: per plastic
update its target (4 B) and its weight read and written (8 B), and 8 B
for each archive entry the update read (``plastic_updates_per_window``,
``archive_reads_per_window``); per static synapse its target and weight
(8 B, ``synapses_per_window``); each received event word once (4 B,
``delivered_per_window``).  The ring rows, the list bounds and the
scratch row of pairs are left out; no operation count.  Each launch is
given a quarter of the window's bytes, so the share is the window's."""

# the device functions' names in a profiler trace
PATTERN = (r"\b(synapse_deliver_kernel|stdp_plan_kernel|stdp_update_kernel|"
           r"stdp_deliver_kernel)\b")
LAUNCHES = 4


def count(z: dict) -> tuple[float, float]:
    window = (12 * z["plastic_updates_per_window"]
              + 8 * z["archive_reads_per_window"]
              + 8 * z["synapses_per_window"]
              + 4 * z["delivered_per_window"])
    return window / LAUNCHES, 0
