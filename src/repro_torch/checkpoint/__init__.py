"""Atomic checkpoints in the reference's on-disk format (port of
``src/repro/checkpoint``)."""
