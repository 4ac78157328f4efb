"""Device functions (kernels, copies, sets) the window loop issues per
simulated window: the profiler's count over the traced stretch."""


def read(ctx):
    return ctx.fns_per_window()
