"""Kernel flush_window's share of its roofline: the least time of one launch (its
bytes at the HBM rate, or its operations at the f32 rate;
``gpubench/rooflines/flush_window.py``) over its measured device time per launch
(profiler)."""


def read(ctx):
    return ctx.roofline_pct("flush_window")
