"""Optimizers and LR schedules (port of ``src/repro/train/optimizer.py``).

* AdamW -- the default for every architecture that fits.
* Adafactor -- factored second moment and an optional bf16 momentum (the
  reference's choice for arctic-480b, whose f32 Adam moments do not fit).
* Schedules -- linear warmup into cosine or WSD (MiniCPM's
  warmup-stable-decay), or constant; computed in f32 as in the reference.

Parameters, gradients and moments are nested dicts of tensors; the
optimizer states are NamedTuples of such dicts, so they checkpoint like
anything else.  Unlike the reference's pure functions, the updates write
the parameters and moments in place (under ``torch.no_grad()``) and return
them: the reference's ``jax.jit(..., donate_argnums=(0,))`` lets XLA reuse
the old state's buffers, and at full width (minicpm-2b: 2.7 B f32
parameters) a second copy of parameters and moments would not fit the card
beside the gradients.  Callers that compare the state before and after a
step clone it first.

Weight decay applies to every leaf of rank >= 2, decided on the stored
tensor as the reference does: the per-layer norm weights are stacked into
``(n_layers, d)`` leaves and are decayed; only 1-D leaves (the final norm)
are not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "cosine"            # cosine | wsd | constant
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1         # WSD: final fraction spent decaying
    min_ratio: float = 0.1


def learning_rate(cfg: ScheduleConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (int or tensor), an f32 tensor on the
    step's device (the CPU for an int)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.kind == "constant":
        return cfg.peak_lr * warm
    if cfg.kind == "cosine":
        t = torch.clamp((s - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return cfg.peak_lr * warm * (cfg.min_ratio
                                     + (1 - cfg.min_ratio) * cos)
    if cfg.kind == "wsd":
        decay_start = cfg.total_steps * (1 - cfg.decay_frac)
        t = torch.clamp((s - decay_start)
                        / max(cfg.total_steps - decay_start, 1), 0, 1)
        # MiniCPM anneals exponentially; the reference's linear-in-log form
        stable = torch.where(s < decay_start, 1.0,
                             torch.pow(cfg.min_ratio, t))
        return cfg.peak_lr * warm * stable
    raise ValueError(cfg.kind)


# ---------------------------------------------------------------------------
# Shared
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"             # adamw | adafactor
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: ScheduleConfig = ScheduleConfig()
    momentum_dtype: str = "float32"     # adafactor: "bfloat16" to halve it


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: torch.Tensor


class AdafactorState(NamedTuple):
    m: dict            # momentum (possibly bf16)
    vr: dict           # row stats  (reduced over the last dim)
    vc: dict           # col stats  (reduced over the second-to-last dim)
    v: dict            # full stats for < 2-D params
    count: torch.Tensor


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in the reference's order (sorted keys,
    as ``jax.tree_util.tree_leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm):
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns (grads, the norm before)."""
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    with torch.no_grad():
        for leaf in tree_leaves(grads):
            leaf.mul_(scale)
    return grads, g


def _write(p: torch.Tensor, new: torch.Tensor) -> None:
    """``p = new.astype(p.dtype)``, in place."""
    if p.dtype == new.dtype:
        p.copy_(new)
    else:
        p.copy_(new.to(p.dtype))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params) -> AdamWState:
    zeros = lambda: tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    device = tree_leaves(params)[0].device
    return AdamWState(m=zeros(), v=zeros(),
                      count=torch.zeros((), dtype=torch.int32,
                                        device=device))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: OptimizerConfig):
    """One AdamW step, params and moments updated in place.  Returns
    (params, the new state, {"lr", "grad_norm"})."""
    c = state.count + 1
    cf = c.float()
    b1, b2 = cfg.b1, cfg.b2
    lr = learning_rate(cfg.schedule, c)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    bc1 = 1 - torch.pow(b1, cf)
    bc2 = 1 - torch.pow(b2, cf)

    def upd(g, m, v, p):
        g = g.float()
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 2:                       # no decay on 1-D leaves
            step += cfg.weight_decay * p.float()
        _write(p, p.float() - lr * step)

    tree_map(upd, grads, state.m, state.v, params)
    return params, AdamWState(state.m, state.v, c), {"lr": lr,
                                                    "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment)
# ---------------------------------------------------------------------------

def adafactor_init(params, cfg: OptimizerConfig) -> AdafactorState:
    mdt = torch.bfloat16 if cfg.momentum_dtype == "bfloat16" \
        else torch.float32
    f32 = lambda shape, p: torch.zeros(shape, dtype=torch.float32,
                                       device=p.device)
    factored = lambda p: p.dim() >= 2
    vr = tree_map(lambda p: f32(p.shape[:-1] if factored(p) else (1,), p),
                  params)
    vc = tree_map(lambda p: f32(p.shape[:-2] + p.shape[-1:]
                                if factored(p) else (1,), p), params)
    v = tree_map(lambda p: f32((1,) if factored(p) else p.shape, p), params)
    m = tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params)
    device = tree_leaves(params)[0].device
    return AdafactorState(m=m, vr=vr, vc=vc, v=v,
                          count=torch.zeros((), dtype=torch.int32,
                                            device=device))


@torch.no_grad()
def adafactor_update(grads, state: AdafactorState, params,
                     cfg: OptimizerConfig):
    """One Adafactor step (factored second moment, the RMS update clip,
    momentum 0.9 in the momentum's dtype), in place.  Returns (params, the
    new state, {"lr", "grad_norm"})."""
    c = state.count + 1
    lr = learning_rate(cfg.schedule, c)
    beta2 = 1.0 - torch.pow(c.float(), -0.8)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)

    def upd(g, m, vr, vc, v, p):
        g = g.float()
        g2 = g * g + 1e-30
        if p.dim() >= 2:
            vr.copy_(beta2 * vr + (1 - beta2) * g2.mean(dim=-1))
            vc.copy_(beta2 * vc + (1 - beta2) * g2.mean(dim=-2))
            r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
            denom = torch.sqrt(r[..., None] * vc[..., None, :])
        else:
            v.copy_(beta2 * v + (1 - beta2) * g2)
            denom = torch.sqrt(v)
        u = g / torch.clamp(denom, min=1e-30)
        # the update clip (Adafactor's RMS rule)
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        mu = 0.9 * m.float() + 0.1 * u
        step = mu + cfg.weight_decay * p.float() * (p.dim() >= 2)
        _write(p, p.float() - lr * step)
        _write(m, mu)

    tree_map(upd, grads, state.m, state.vr, state.vc, state.v, params)
    return params, AdafactorState(state.m, state.vr, state.vc, state.v,
                                  c), {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------

def init_opt(params, cfg: OptimizerConfig):
    if cfg.kind == "adafactor":
        return adafactor_init(params, cfg)
    return adamw_init(params)


def apply_opt(grads, state, params, cfg: OptimizerConfig):
    """One optimizer step, params and state updated in place; returns
    (params, state, {"lr", "grad_norm"})."""
    if cfg.kind == "adafactor":
        return adafactor_update(grads, state, params, cfg)
    return adamw_update(grads, state, params, cfg)
