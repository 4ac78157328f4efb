"""Distributed layouts and collectives (port of ``src/repro/distributed``):
the logical-axis sharding rules, the split-KV decode and the chunked
all-to-all, and the int8 error-feedback all-reduce.  On one card a mesh
axis is a leading tensor dimension (``launch.mesh``)."""
