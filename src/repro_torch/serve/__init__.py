"""Serving (port of ``src/repro/serve``): the batched LM engine and the
seeded open-loop load generator (``loadgen``).  The spike-stream engine
and tenancy come with ROADMAP queue 1, item 9."""
