"""Fault-tolerant training loop (port of ``src/repro/train/trainer.py``).

* **checkpoint / restart** -- periodic atomic checkpoints of the whole
  train state (params, moments, step; the data cursor is the step);
  ``Trainer.run`` resumes from the latest committed checkpoint if there is
  one.  The restore template is the state's shapes on the ``meta`` device,
  so no copy of the state is built on the host to restore into.
* **straggler mitigation** -- a step slower than ``straggler_margin`` x the
  median of the recent steps is counted (``straggler_events``).
* **crash injection** -- ``fail_at_step`` raises inside step ``i``, so the
  restart path is tested, not just written.

The state stays on the device between steps: only logged steps read their
metrics (and so wait for the device), and a checkpoint copies the state to
the host.

``rt`` is the model's mesh context (``models.transformer.Runtime``);
``mesh`` (a virtual ``launch.mesh.Mesh``) checks that each batch divides
over its data axis and places it whole on the device
(``data.pipeline.shard_batch``; the reference splits it there);
``state_shardings`` (a Sharding tree like the state) is the
layout a fresh or restored state is placed in (the reference's elastic
restore onto another mesh).  On one card neither changes a value.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import DataConfig, RingPrefetcher, shard_batch
from repro_torch.distributed.sharding import check_layout
from repro_torch.kernels import dispatch
from repro_torch.models.model import Model
from repro_torch.models.transformer import Runtime
from repro_torch.obs import spans as obs_spans
from repro_torch.train import step as step_lib


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    log_every: int = 10
    straggler_margin: float = 3.0      # x median step time
    fail_at_step: int | None = None    # crash injection for tests


class Trainer:
    def __init__(self, model: Model, tcfg: step_lib.TrainConfig,
                 dcfg: DataConfig, run_cfg: TrainerConfig,
                 rt: Runtime | None = None, mesh=None,
                 state_shardings=None,
                 tracer: obs_spans.Tracer | None = None, device=None):
        self.model = model
        # a disabled (NULL) tracer still times the step for the straggler
        # check
        self.tracer = tracer if tracer is not None else obs_spans.NULL
        self.tcfg = tcfg
        self.dcfg = dcfg
        self.cfg = run_cfg
        self.device = dispatch.resolve_device(device)
        self.rt = rt or Runtime(mesh=mesh)
        self.mesh = mesh
        self.state_shardings = state_shardings
        self.ckpt = Checkpointer(run_cfg.ckpt_dir)
        self.train_step = step_lib.make_train_step(model, tcfg, self.rt)
        self.step_times: list = []
        self.straggler_events = 0

    # -- state ------------------------------------------------------------
    def init_or_restore(self, seed: int = 0):
        """(state, first step): the latest checkpoint's state, or a fresh
        one from ``seed``."""
        latest = self.ckpt.latest_step()
        if latest is not None:
            template = step_lib.abstract_train_state(self.model, self.tcfg)
            state = self.ckpt.restore(template, latest, device=self.device,
                                      shardings=self.state_shardings)
            return state, int(state["step"])
        state = step_lib.init_train_state(
            self.model, torch.Generator().manual_seed(seed), self.tcfg,
            self.device)
        if self.state_shardings is not None:
            check_layout(state, self.state_shardings)
        return state, 0

    # -- loop ---------------------------------------------------------------
    def run(self, seed: int = 0, extra_batch: Callable | None = None):
        """Train from the latest checkpoint (or ``seed``) to
        ``steps``; returns (state, history of the logged steps)."""
        state, start = self.init_or_restore(seed)
        data = RingPrefetcher(self.dcfg, start_step=start)
        history = []
        try:
            for i in range(start, self.cfg.steps):
                with self.tracer.span("train/step", track="train",
                                      step=i) as sp:
                    _, batch = data.next()
                    if extra_batch is not None:
                        batch.update(extra_batch(self.model.cfg, batch))
                    if self.mesh is not None:
                        batch = shard_batch(batch, self.mesh,
                                            device=self.device)
                    else:
                        batch = {k: v.to(self.device, non_blocking=True)
                                 for k, v in batch.items()}
                    if (self.cfg.fail_at_step is not None
                            and i == self.cfg.fail_at_step):
                        raise RuntimeError("injected node failure")
                    state, metrics = self.train_step(state, batch)
                dt = sp.dur_s
                self._straggler_check(dt)
                if (i + 1) % self.cfg.log_every == 0 or i == start:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(step=i + 1, dt=dt, **data.stats())
                    history.append(m)
                if (i + 1) % self.cfg.ckpt_every == 0:
                    self.ckpt.save(i + 1, state)
        finally:
            data.close()
        return state, history

    def _straggler_check(self, dt: float):
        self.step_times.append(dt)
        if len(self.step_times) >= 8:
            med = float(np.median(self.step_times[-32:]))
            if dt > self.cfg.straggler_margin * med:
                self.straggler_events += 1
