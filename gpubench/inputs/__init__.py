"""Input generators the benchmark owns: what it hands the program and the
reference alike, made from ``--seed``."""
