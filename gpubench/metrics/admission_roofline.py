"""Kernel admission's share of its roofline: the least time of one launch (its
bytes at the HBM rate, or its operations at the f32 rate;
``gpubench/rooflines/admission.py``) over its measured device time per launch
(profiler)."""


def read(ctx):
    return ctx.roofline_pct("admission")
