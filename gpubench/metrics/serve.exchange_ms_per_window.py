"""Host milliseconds the engine's device thread spends issuing a served
window's tenant torus exchange (F's tenant form, the ring phases, the
``LinkStats`` build): its ``window/exchange`` spans inside
``device/dispatch``, over the served windows."""
from gpubench.harness import engine_spans


def read(ctx):
    return engine_spans.served_stage_ms(ctx, "window/exchange")
