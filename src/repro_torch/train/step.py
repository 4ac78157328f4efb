"""Loss and train-step factory (port of ``src/repro/train/step.py``).

The cross-entropy is computed in sequence chunks, each checkpointed under
autograd (the reference's ``jax.checkpoint``), so the (B, S, vocab) logits
never exist in memory: at minicpm-2b's 122,753-token vocabulary one 512-
token chunk of two sequences is already 0.5 GB of f32 logits.

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``: the gradients of the loss (summed over ``microbatch`` slices
of the batch and averaged, as the reference's gradient accumulation), then
the optimizer, which updates the state in place.  The gradient computation
stands on its own as ``make_compute_grads`` (the reference's inner
``compute_grads``), so gradients can be held against the reference's
before any optimizer step.

Each factory takes the model's ``Runtime`` (``rt``, the mesh context;
None is the single-device default).  Its ``logits_chunk`` is the loss's
sequence chunk; its ``remat`` (the per-layer checkpoint of the forward)
is set from ``TrainConfig.remat`` (default True), the one switch of the
train step; it changes no value.  ``rt.grad_specs`` (a parameter-sharding
tree) constrains the gradients to the parameters' layout, which on one
card changes no value.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.models.transformer import DEFAULT, Runtime
from repro_torch.train import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: opt.OptimizerConfig = opt.OptimizerConfig()
    aux_weight: float = 0.01        # MoE load-balance loss weight
    z_weight: float = 1e-4          # logit z-loss
    microbatch: int = 0             # 0 = no gradient accumulation
    remat: bool = True


def chunked_xent(params, hidden: torch.Tensor, labels: torch.Tensor,
                 cfg: ModelConfig, chunk: int | None = None,
                 rt: Runtime | None = None):
    """(mean NLL, mean squared logsumexp) over the unmasked tokens, never
    materialising the full logits.

    hidden: (B, S, d) bf16; labels: (B, S) integer (-1 = masked).  Each
    chunk: the head in the hidden's dtype, times ``logit_scale``, then f32
    and the softcap, as ``models.transformer.logits_fn``; ``chunk``
    defaults to ``rt.logits_chunk`` (512).
    """
    rt = rt or DEFAULT
    B, S, d = hidden.shape
    chunk = chunk or min(rt.logits_chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    # the loss chunks along S: back to a batch-only layout, once, here
    hidden = rt.wsc(hidden, (rt.batch_axes, None, None))
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]

    def one(h_c, y_c):
        # the head is cast inside the chunk: its gradient is taken back to
        # the f32 weight per chunk and summed there, as in the reference
        logits = h_c @ w.to(h_c.dtype)                   # (B, c, V)
        logits = L.softcap((logits * cfg.logit_scale).float(),
                           cfg.logit_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            torch.clamp(y_c, min=0).long()[..., None])[..., 0]
        mask = (y_c >= 0).float()
        return (((lse - gold) * mask).sum(), (lse * lse * mask).sum(),
                mask.sum())

    nll = zsq = n = torch.zeros((), dtype=torch.float32,
                                device=hidden.device)
    for j in range(0, S, chunk):
        a, b, c = L.checkpointed(one, hidden[:, j:j + chunk],
                                 labels[:, j:j + chunk])
        nll, zsq, n = nll + a, zsq + b, n + c
    n = torch.clamp(n, min=1.0)
    return nll / n, zsq / n


def make_loss_fn(model: Model, tcfg: TrainConfig, rt: Runtime | None = None):
    cfg = model.cfg
    rt = dataclasses.replace(rt or DEFAULT, remat=tcfg.remat)

    def loss_fn(params, batch):
        hidden, aux = model.hidden(params, batch, rt)
        nll, zsq = chunked_xent(params, hidden, batch["labels"], cfg, rt=rt)
        loss = nll + tcfg.aux_weight * aux + tcfg.z_weight * zsq
        return loss, {"loss": loss, "nll": nll, "aux": aux, "z": zsq}

    return loss_fn


def make_compute_grads(model: Model, tcfg: TrainConfig,
                       rt: Runtime | None = None):
    """Returns ``compute_grads(params, batch) -> (grads, metrics)``: the
    loss's gradients (f32 for f32 parameters, a tree like ``params``) and
    its metrics, as detached 0-d tensors.  With ``microbatch > 1`` the batch
    is split on its leading axis, and gradients and metrics are the mean
    over the slices (summed in f32, then divided)."""
    loss_fn = make_loss_fn(model, tcfg, rt)

    def grad_fn(params, batch):
        live = []           # the leaves, in tree_map's order

        def track(p):
            live.append(p.detach().requires_grad_())
            return live[-1]

        loss, metrics = loss_fn(opt.tree_map(track, params), batch)
        # unused leaves (RecurrentGemma's attention `ln2`) get zeros, as
        # in the reference
        grads = iter(torch.autograd.grad(loss, live, allow_unused=True,
                                         materialize_grads=True))
        return (opt.tree_map(lambda _: next(grads), params),
                {k: v.detach() for k, v in metrics.items()})

    def compute_grads(params, batch):
        mb = tcfg.microbatch
        if not mb or mb <= 1:
            return grad_fn(params, batch)
        split = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])
                 for k, v in batch.items()}
        g_sum = opt.tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        m_sum: dict = {}
        for i in range(mb):
            g, m = grad_fn(params, {k: v[i] for k, v in split.items()})
            opt.tree_map(lambda acc, t: acc.add_(t), g_sum, g)
            del g
            m_sum = {k: m_sum.get(k, 0.0) + v for k, v in m.items()}
        g = opt.tree_map(lambda t: t.div_(mb), g_sum)
        return g, {k: v / mb for k, v in m_sum.items()}

    return compute_grads


def make_train_step(model: Model, tcfg: TrainConfig,
                    rt: Runtime | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state`` = ``{"params", "opt", "step"}``; the parameters and moments
    are updated in place and the returned state holds the same tensors
    (the counterpart of the reference's donated buffers).  ``metrics``:
    loss, nll, aux, z, lr and grad_norm, as 0-d device tensors (reading
    them syncs with the device).
    """
    rt = rt or DEFAULT
    compute_grads = make_compute_grads(model, tcfg, rt)

    def train_step(state, batch):
        params = state["params"]
        grads, metrics = compute_grads(params, batch)
        if rt.grad_specs is not None:
            # the gradients pinned to the parameters' layout (the
            # reference's reduce-scatter hint): no value changes
            grads = opt.tree_map(lambda g, sh: rt.wsc(g, sh.spec), grads,
                                 rt.grad_specs)
        params, opt_state, om = opt.apply_opt(grads, state["opt"], params,
                                              tcfg.optimizer)
        metrics.update(om)
        return {"params": params, "opt": opt_state,
                "step": state["step"] + 1}, metrics

    return train_step


def init_train_state(model: Model, generator: torch.Generator,
                     tcfg: TrainConfig, device=None,
                     param_dtype=None) -> dict:
    """Parameters from ``generator``'s seed, a fresh optimizer state and
    step 0 (int32), all on ``device`` (``None`` is CUDA)."""
    device = dispatch.resolve_device(device)
    params = model.init(generator, param_dtype, device)
    return {"params": params, "opt": opt.init_opt(params, tcfg.optimizer),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_train_state(model: Model, tcfg: TrainConfig,
                         param_dtype=None) -> dict:
    """The train state's tree on the ``meta`` device: shapes and dtypes,
    nothing allocated (a restore template at any width)."""
    params = model.abstract(param_dtype)
    return {"params": params, "opt": opt.init_opt(params, tcfg.optimizer),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}
