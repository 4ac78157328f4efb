"""Data: the synthetic LM pipeline behind a ring-buffer prefetcher (port
of ``src/repro/data``)."""
