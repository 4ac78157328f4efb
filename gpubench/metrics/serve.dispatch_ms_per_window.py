"""Host milliseconds the engine's device thread spends issuing a served
window: its own ``device/dispatch`` spans (each one segment) over the
windows they dispatched, across the whole traced run."""


def read(ctx):
    secs, n = ctx.span_total_s("device/dispatch")
    return secs * 1e3 / (n * ctx.seg_windows) if n else None
