"""Render the dry-run document from the port's own report JSONs (port of
``src/repro/launch/experiments_md.py``).

Reads ``dryrun_single_pod.json`` and ``dryrun_multi_pod.json`` from the
port's report directory (``--reports``, default ``build/dryrun`` under
the repository; never the reference's ``reports/``), as written by

  python -m repro_torch.launch.dryrun --all --out build/dryrun/dryrun_single_pod.json
  python -m repro_torch.launch.dryrun --all --multi-pod \\
      --out build/dryrun/dryrun_multi_pod.json

and prints the document to stdout.  The reference's static hill-climb
log (its paper-claims table and the three cells it optimised) quotes
TPU measurements and is left out: no number of it is the port's.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch import roofline as rf
from repro_torch.launch.report import dryrun_table, roofline_table

RDIR = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                    "../../..", "build", "dryrun"))

HEADER = f"""# Dry run of the PyTorch port on the production meshes

Every number in this document regenerates from the port's dry-run
reports (`python -m repro_torch.launch.dryrun`).  Hardware model: NVIDIA
H100 SXM (700 W), datasheet figures: {rf.PEAK_FLOPS / 1e12:.0f} TFLOP/s
dense bf16, {rf.HBM_BW / 1e12:.2f} TB/s HBM3, {rf.HBM_BYTES / 1e9:.0f} GB
per device; meshes 16x16 (256 devices) and 2x16x16 (512), virtual.  No
time below is measured: each is a count over a datasheet rate.
"""

DRYRUN_INTRO = """## Dry run

Every (architecture x shape) cell is built at the full published widths
on `meta` tensors (nothing allocated): `train_4k` runs the train step
(forward, backward, optimizer), `prefill_32k` the cache-filling prefill,
`decode_*` one decode step against a seq_len KV cache.  `long_500k` runs
for the two sub-quadratic architectures (mamba2, recurrentgemma) and is
skipped for the eight full-attention ones.

Columns: per-device resident state from the sharding plan (parameters,
optimizer state, caches, inputs) against the 80 GB of one H100.  The
reference's compile time and collective bytes come from XLA's compiled
program, which the port has no counterpart of (`—`).
"""

ROOFLINE_INTRO = f"""## Roofline

Terms per device per step: compute = FLOPs / {rf.PEAK_FLOPS:.3g},
memory = state bytes / {rf.HBM_BW:.3g} (the resident state read once).
FLOPs are the larger of `FlopCounterMode`'s count over the step and the
analytic MODEL_FLOPS (6 N D for training, 2 N D for inference, N the
active parameters); `useful` is MODEL_FLOPS over that.  The collective
term is not available (`—`), so the bottleneck is compute or memory.
"""


def load(rdir: str, name: str):
    with open(os.path.join(rdir, name)) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reports", default=RDIR)
    args = ap.parse_args(argv)
    single = load(args.reports, "dryrun_single_pod.json")
    multi = load(args.reports, "dryrun_multi_pod.json")
    print(HEADER)
    print(DRYRUN_INTRO)
    print("### Single pod 16x16\n")
    print(dryrun_table(single))
    print("\n### Multi-pod 2x16x16\n")
    print(dryrun_table(multi))
    print()
    print(ROOFLINE_INTRO)
    print("### Single pod\n")
    print(roofline_table(single))
    print("\n### Multi-pod 2x16x16\n")
    print(roofline_table(multi))
    print("\n¹ long_500k needs a sub-quadratic path; the eight "
          "full-attention architectures are excluded, as in the reference "
          "- mamba2 (SSM state) and recurrentgemma (RG-LRU + ring cache) "
          "run it.\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
