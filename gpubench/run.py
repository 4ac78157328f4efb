"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints, as its last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` (and with
``--trace 1`` a ``breakdown``), and last ``compared``: each number the
check compared with its limit, which also close standard error.  Exits
non-zero, printing no result, without enough CUDA devices, when the
program cannot be imported, or when JAX or the JAX package was loaded.

``--control`` judges the control instead of the program (the reference in
the next lower precision put in the program's place): its ``correct``
must come out false.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def setup_process() -> None:
    """Every cache inside the checkout, at fixed paths; no JAX through
    libraries that would load it; the benchmark and the port importable."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    setup_process()

    import torch
    from gpubench.harness import guard, manifest, runner
    cell = manifest.load(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    line = runner.run_cell(ROOT, args.workload, seed=args.seed,
                           seconds=args.seconds, trace=bool(args.trace),
                           device="cuda", t_start=T_START,
                           control=args.control)
    found = guard.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    for name, c in line["compared"].items():
        if not math.isfinite(c["value"]):
            c["value"] = 1e300
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
