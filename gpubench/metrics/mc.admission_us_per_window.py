"""Device microseconds of kernel F, the torus admission replay, per
simulated window (profiler); nothing where no credited torus runs."""


def read(ctx):
    return ctx.kernel_us_per_window("admission")
