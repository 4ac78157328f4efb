"""Share of the engine device thread's time spent waiting for a staged
segment (its ``device/staged_wait`` spans) between its first and last
span, across the whole traced run: how often ingest starves the card."""


def read(ctx):
    spans = [e for e in ctx.spans or () if e.get("ph") == "X"
             and e.get("track") == "spike-device"]
    if not spans:
        return None
    total = max(e["ts"] + e["dur"] for e in spans) - min(
        e["ts"] for e in spans)
    wait, _ = ctx.span_total_s("device/staged_wait")
    return 100.0 * wait * 1e6 / total
