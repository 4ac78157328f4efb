"""Launchers (port of ``src/repro/launch``): so far the serving CLI."""
