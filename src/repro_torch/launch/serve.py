"""Serving launcher CLI: batched generation through the engine (port of
``src/repro/launch/serve.py``).

Architectures: all ten of ``repro_torch.configs.ARCHS`` (dense, MoE,
vision, Mamba-2, RecurrentGemma, Whisper).  Parameters are random, drawn
from seed 0 and materialised in bf16, the dtype every block computes in;
prompts are 4-11 random tokens from seed 0, and each Whisper request
carries its own (1, enc_ctx, d_model) ``enc_frames``, as in the reference
(so Whisper serves at ``--slots 1``: a wider wave refuses batch-1 extras).
Examples:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
      --reduced --device cpu --requests 8 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch whisper-large-v3 --slots 1
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    from repro_torch.obs import log as obs_log
    obs_log.add_log_args(ap)
    args = ap.parse_args(argv)
    obs_log.setup_logging("INFO", quiet=args.quiet, verbose=args.verbose)

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced as reduce_cfg
    from repro_torch.kernels import dispatch
    from repro_torch.models import build
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    device = dispatch.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0),
                        param_dtype=torch.bfloat16, device=device)
    eng = Engine(model, ServeConfig(slots=args.slots, max_len=args.max_len,
                                    max_new_tokens=args.max_new,
                                    temperature=args.temperature))
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        extras = {}
        if cfg.family == "audio":
            extras["enc_frames"] = rng.normal(
                size=(1, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
        reqs.append(Request(rid=i, prompt=rng.integers(
            3, cfg.vocab, size=int(rng.integers(4, 12))).astype(np.int32),
            extras=extras or None))
    out = eng.generate_batch(params, reqs)
    for rid in sorted(out):
        print(f"req {rid}: {len(out[rid])} tokens -> "
              f"{out[rid][:10].tolist()}")
    for i, w in enumerate(eng.waves):
        print(f"wave {i}: {w.batch} requests, prompt {w.prompt_len}, "
              f"prefill {w.prefill_s * 1e3:.1f} ms, {w.decode_steps} decode "
              f"steps in {w.decode_s * 1e3:.1f} ms ({device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
