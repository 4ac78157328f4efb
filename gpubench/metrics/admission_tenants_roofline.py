"""Kernel admission_tenants's share of its roofline while serving: the least time of one
launch (``gpubench/rooflines/admission_tenants.py``) over its measured device time per
launch (profiler)."""


def read(ctx):
    return ctx.roofline_pct("admission_tenants")
