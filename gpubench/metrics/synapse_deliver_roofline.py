"""Kernel synapse_deliver's share of its roofline: the least time of one
launch (the synapses and event words it must read at the HBM rate;
``gpubench/rooflines/synapse_deliver.py``) over its measured device time
per launch (profiler)."""


def read(ctx):
    return ctx.roofline_pct("synapse_deliver")
