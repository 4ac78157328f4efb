"""Host milliseconds the engine's device thread spends issuing a served
window's latency attribution (the receiver's decode and latency summary):
its ``window/attribute`` spans inside ``device/dispatch``, over the served
windows."""
from gpubench.harness import engine_spans


def read(ctx):
    return engine_spans.served_stage_ms(ctx, "window/attribute")
