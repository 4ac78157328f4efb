"""Spiking network: LIF dynamics, the microcircuit, its partition and the
windowed multi-shard simulator."""
