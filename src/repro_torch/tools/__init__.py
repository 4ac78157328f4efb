"""Operational scripts of the port (counterparts of the reference's
``tools/``): ``trace_smoke``, the observability stack's end-to-end check."""
