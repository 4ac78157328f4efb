"""Kernel wire_codec's share of its roofline while serving: the least time of one
launch (``gpubench/rooflines/wire_codec.py``) over its measured device time per
launch (profiler)."""


def read(ctx):
    return ctx.roofline_pct("wire_codec")
