"""Share of the traced stretch of serving (wall time) in which no kernel,
copy or set ran on the device: the profiler's timeline."""


def read(ctx):
    return ctx.idle_pct()
