"""Serve a small LM with batched requests through the port's slot engine
(counterpart of ``examples/serve_lm.py``): prefill + decode with KV caches,
greedy sampling, EOS handling, on one device.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import examples
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import dispatch
from repro_torch.models import build
from repro_torch.serve.engine import Engine, Request, ServeConfig

N_REQUESTS = 10
SERVE = dict(slots=4, max_len=128, max_new_tokens=24, eos_id=2)


def config():
    """Reduced gemma2-9b at 4 layers (alternating local / global
    attention, softcaps active)."""
    return reduced(get_config("gemma2_9b"), layers=4)


def requests(vocab: int) -> list[Request]:
    """10 prompts of 4-11 tokens from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(3, vocab,
                                               size=rng.integers(4, 12))
                    .astype(np.int32))
            for i in range(N_REQUESTS)]


def main(params=None, *, device=None) -> dict:
    """Serve the 10 requests (with ``params``, else a draw from seed 0)
    and print them and tokens/s; returns {rid: generated tokens}."""
    device = dispatch.resolve_device(device)
    cfg = config()
    model = build(cfg)
    if params is None:
        params = model.init(torch.Generator().manual_seed(0), device=device)
    print(f"serving reduced {cfg.name}: {cfg.n_layers}L d{cfg.d_model} "
          f"(alternating local/global attention, softcaps active)")

    eng = Engine(model, ServeConfig(**SERVE))
    reqs = requests(cfg.vocab)
    t0 = time.perf_counter()
    out = eng.generate_batch(params, reqs)
    examples.synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in out.values())
    for rid in sorted(out):
        print(f"  req {rid}: prompt {len(reqs[rid].prompt):2d} tok "
              f"-> {len(out[rid]):2d} new: {list(out[rid][:8])}...")
    print(f"{len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {examples.device_label(device)})")
    return out


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    main(device=ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
