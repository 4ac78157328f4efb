"""Training launcher CLI (port of ``src/repro/launch/train.py``).

One process, one device: the trainer runs on the card (``cuda``) unless
``--device`` names another.  Parameters are random (f32, from seed 0); the
data is ``data.pipeline.synthetic_batch`` behind the prefetcher.

``--mesh DxM`` trains under a (data, model) mesh, as the reference builds
it: ``Runtime(mesh, batch_axes, moe_impl)``, with the per-layer recompute
on (``TrainConfig.remat``, set by the train step).  On one card the mesh
is virtual (``launch.mesh``): each batch is checked to divide over the
data axis and placed whole on the device, and only a path that reads a
mesh axis changes what runs.  Of the launcher's runtime that is
``--moe-impl bucket``: the sharded bucket dispatch over the model axis,
each EP rank holding all of the batch's tokens.  A dense model reads no
axis and trains as without a mesh.  ``--fake-devices N`` (the reference's
forced host device count) must equal the mesh's size; on one card it
forces nothing.
Examples:

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \\
      --reduced --steps 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_32b \\
      --reduced --steps 4 --mesh 2x4 --fake-devices 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_moe_16b \
      --reduced --steps 4 --mesh 1x4 --moe-impl bucket --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --steps 8 --batch 2 --seq 4096 --lr 1e-3
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


def parse_mesh(spec: str | None, fake_devices: int = 0):
    """``"DxM"`` -> a virtual (data, model) Mesh (None for None).
    ``fake_devices`` (the reference's forced host device count), when
    given with a mesh, must equal its size; without one it changes
    nothing, as in the reference."""
    from repro_torch.launch.mesh import Mesh
    if not spec:
        return None
    d, m = (int(x) for x in spec.split("x"))
    mesh = Mesh((d, m), ("data", "model"))
    if fake_devices and fake_devices != mesh.size:
        raise ValueError(f"--fake-devices {fake_devices} != the size "
                         f"{mesh.size} of mesh {spec}")
    return mesh


def build_trainer(cfg, *, steps: int, batch: int, seq: int,
                  lr: float = 1e-3, schedule: str = "wsd",
                  microbatch: int = 0, ckpt_dir: str, ckpt_every: int,
                  mesh=None, moe_impl: str = "local", device=None):
    """The launcher's trainer for model config ``cfg``: AdamW with a
    warmup of a tenth of the steps (at least 1) into ``schedule``,
    ``synthetic_batch`` data of ``batch`` x ``seq`` tokens, a log line
    every tenth of the steps, on ``device`` (``None`` is CUDA); with a
    ``mesh``, the reference's ``Runtime(mesh, batch_axes, moe_impl)``
    (its ``remat`` is the train step's, from ``TrainConfig.remat``)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.models import build
    from repro_torch.models.transformer import Runtime
    from repro_torch.train.optimizer import OptimizerConfig, ScheduleConfig
    from repro_torch.train.step import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    tcfg = TrainConfig(
        optimizer=OptimizerConfig(schedule=ScheduleConfig(
            kind=schedule, peak_lr=lr, warmup_steps=max(steps // 10, 1),
            total_steps=steps)),
        microbatch=microbatch,
    )
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    rt = Runtime() if mesh is None else Runtime(
        mesh=mesh, batch_axes=batch_axes(mesh), moe_impl=moe_impl)
    return Trainer(build(cfg), tcfg, dcfg,
                   TrainerConfig(steps=steps, ckpt_dir=ckpt_dir,
                                 ckpt_every=ckpt_every,
                                 log_every=max(steps // 10, 1)),
                   rt=rt, mesh=mesh, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="wsd",
                    choices=["wsd", "cosine", "constant"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--moe-impl", default="local",
                    choices=["local", "bucket"],
                    help="the MoE dispatch under --mesh (bucket: the "
                         "sharded expert-parallel dispatch); without a mesh "
                         "always local")
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x4 (data x model); on one card the mesh is "
                         "virtual: its axes become tensor dimensions")
    ap.add_argument("--fake-devices", type=int, default=0,
                    help="the reference's forced device count; must equal "
                         "the mesh's size (on one card nothing is forced)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    from repro_torch.obs import log as obs_log
    obs_log.add_log_args(ap)
    args = ap.parse_args(argv)
    mesh = parse_mesh(args.mesh, args.fake_devices)
    # progress defaults to INFO on stderr (a launcher's progress is not a
    # machine protocol; --quiet silences it)
    log = obs_log.setup_logging("INFO", quiet=args.quiet,
                                verbose=args.verbose)

    from repro_torch.configs import get_config, reduced as reduce_cfg

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    trainer = build_trainer(cfg, steps=args.steps, batch=args.batch,
                            seq=args.seq, lr=args.lr,
                            schedule=args.schedule,
                            microbatch=args.microbatch,
                            ckpt_dir=args.ckpt_dir,
                            ckpt_every=args.ckpt_every, mesh=mesh,
                            moe_impl=args.moe_impl, device=args.device)
    state, history = trainer.run(seed=0)
    for h in history:
        log.info("step %5d loss %.4f lr %.2e dt %.0fms stalls %d",
                 h["step"], h["loss"], h["lr"], h["dt"] * 1e3,
                 h["producer_stalls"])
    log.info("done: %d steps; straggler events: %d",
             args.steps, trainer.straggler_events)
    return 0


if __name__ == "__main__":
    sys.exit(main())
