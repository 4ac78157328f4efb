"""The benchmark's plain reference: plain PyTorch, frozen from the port's
plain versions at the time the benchmark was defined, importing nothing of
the program.  ``simulator`` is the microcircuit's window, ``engine`` the
spike server's window; the rest are their parts (events, wire codec and
framing, latency digest, credit bank, torus topology and transports, the
admission replays)."""
