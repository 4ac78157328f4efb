"""End-to-end training run of the port (counterpart of
``examples/train_100m.py``): a ~100M-parameter MiniCPM-family model for a
few hundred steps with the full production stack -- ring-buffer data
pipeline, WSD schedule, gradient clipping, atomic checkpointing, restart.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_100m \\
          [--steps 200] [--batch 8] [--seq 256] [--ckpt-dir DIR] \\
          [--device cpu]

Checkpoints go to ``--ckpt-dir`` every ``max(steps // 4, 10)`` steps, and
re-running the same command resumes from the latest one.  The default
directory is the port's own (``repro_torch_100m_ckpt`` in the temporary
directory): the checkpoint format is the reference's, so sharing its
directory would resume the other package's run.  On a card it also prints
the peak device memory.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import examples
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import dispatch
from repro_torch.models import build
from repro_torch.models.modules import param_count
from repro_torch.train.optimizer import OptimizerConfig, ScheduleConfig
from repro_torch.train.step import TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(),
                                "repro_torch_100m_ckpt")


def config_100m():
    """MiniCPM-style ~100M: 12L x 512d x 8H, vocab 32k, muP scalings."""
    base = get_config("minicpm_2b")
    return dataclasses.replace(
        base, n_layers=12, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=1536, vocab=32000, logit_scale=1.0 / (512 / 256),
    )


def main(argv=None) -> list[dict]:
    """Train as the arguments say; returns the trainer's history (the
    logged steps)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = dispatch.resolve_device(args.device)

    cfg = config_100m()
    model = build(cfg)
    n = param_count(model.specs())
    print(f"model: {cfg.name}-100m  {n / 1e6:.1f}M params "
          f"({cfg.n_layers}L x {cfg.d_model}d)")

    tcfg = TrainConfig(
        optimizer=OptimizerConfig(
            schedule=ScheduleConfig(kind="wsd", peak_lr=6e-4,
                                    warmup_steps=20,
                                    total_steps=args.steps,
                                    decay_frac=0.2)),
        microbatch=0,
    )
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    trainer = Trainer(model, tcfg, dcfg, TrainerConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=max(args.steps // 4, 10), log_every=10), device=device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state, history = trainer.run(seed=0)
    examples.synchronize(device)
    dt = time.perf_counter() - t0
    tok = args.steps * args.batch * args.seq
    print(f"\n{args.steps} steps / {tok} tokens in {dt:.1f}s "
          f"({tok / dt:.0f} tok/s, {dt * 1e3 / args.steps:.1f} ms a step, "
          f"checkpoints included, on {examples.device_label(device)})")
    if device.type == "cuda":
        print(f"peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    print("loss curve:",
          " -> ".join(f"{h['loss']:.2f}"
                      for h in history[:: max(len(history) // 6, 1)]))
    first, last = history[0]["loss"], history[-1]["loss"]
    assert last < first, "loss should decrease"
    print(f"checkpoints in {args.ckpt_dir} "
          f"(resume by re-running the same command)")
    return history


if __name__ == "__main__":
    main()
