"""Host milliseconds the window loop spends issuing delivery through the
sparse synapse store: the program's ``window/deliver`` spans in the
profiled segments over the traced windows; nothing where delivery records
no span (the dense kind)."""


def read(ctx):
    secs, n = ctx.span_total_s("window/deliver")
    return secs * 1e3 / ctx.trace.windows if n else None
