"""Share of the traced stretch (wall time, host clock, ending in a
synchronize) in which no kernel, copy or set ran on the device: the
profiler's timeline."""


def read(ctx):
    return ctx.idle_pct()
