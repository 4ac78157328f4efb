"""Serving (port of ``src/repro/serve``): so far the batched LM engine.
The spike-stream engine, tenancy and load generation come with ROADMAP
queue 1, item 9."""
