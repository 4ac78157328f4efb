"""The port's benchmark: ``python3 gpubench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once
on the card and prints one JSON result line."""
