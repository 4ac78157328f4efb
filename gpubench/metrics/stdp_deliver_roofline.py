"""Delivery through the static store and the plastic lists (kernel S's
walk and its plastic form: plan, update, plastic walk;
``gpubench/rooflines/stdp_deliver.py``): the least time of the window's
delivery (its bytes at the HBM rate) over its measured device time
(profiler), as a share."""


def read(ctx):
    return ctx.roofline_pct("stdp_deliver")
