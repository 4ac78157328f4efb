"""Mixture-of-Experts with the paper's bucket dispatch (port of
``src/repro/models/moe.py``).

Token -> expert dispatch is the Extoll event-aggregation problem: many
small payloads (tokens) addressed to sparse destinations (experts) are
binned into capacity-bounded buckets and shipped in one exchange.

* :func:`moe_layer_local` -- one device: every expert's bucket in one
  (E, C, d) buffer, the experts applied as batched GEMMs.
* :func:`moe_layer_bucket` -- expert parallelism over ``ep`` ranks, the
  rank a leading tensor dimension (the reference runs it inside
  ``shard_map`` over the EP mesh axis): each rank buckets its own tokens,
  one exchange ships rank ``src``'s buckets for the experts of rank
  ``dst`` (the reference's ``all_to_all``: here a transpose of the (src,
  dst) axes), each rank applies its local experts to ``ep * C`` rows, and
  the inverse exchange brings the outputs home.

Both share the router and the capacity / overflow semantics: an
assignment's slot is its rank among the window's assignments to the same
expert (token-major order), and assignments past the capacity are
dropped.  Top-k breaks ties as ``jax.lax.top_k`` does, towards the lower
expert index (the first k of a stable descending sort; ``torch.topk``
orders ties otherwise).  The router's jitter is taken as an optional
tensor (the reference draws it with ``jax.random``); with none given
nothing is drawn.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers as L


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor     # load-balance loss
    router_z: torch.Tensor     # router z-loss
    dropped: torch.Tensor      # fraction of (token, k) assignments dropped


def router_probs(x: torch.Tensor, w_router: torch.Tensor,
                 noise: torch.Tensor | None = None):
    """x: (T, d) -> (probs (T, E), logits f32).  ``noise``: an optional
    (T, E) jitter draw added to the f32 logits (the reference's
    ``uniform(-jitter, jitter)``)."""
    logits = (x @ w_router).float()
    if noise is not None:
        logits = logits + noise
    return torch.softmax(logits, dim=-1), logits


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, ties to the
    lower index as ``jax.lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _positions(dest: torch.Tensor, n_dest: int):
    """Slot of each assignment within its destination (window order), and
    each destination's count."""
    oh = F.one_hot(dest, n_dest).to(torch.int32)
    pos = torch.cumsum(oh, dim=0, dtype=torch.int32) - oh
    return (pos * oh).sum(dim=1, dtype=torch.int32), oh.sum(dim=0,
                                                            dtype=torch.int32)


def _capacity(n_tokens: int, top_k: int, n_experts: int, factor: float,
              multiple: int = 4) -> int:
    c = int(n_tokens * top_k / n_experts * factor) + 1
    return max(-(-c // multiple) * multiple, multiple)


def expert_glu(xe, wg, wu, wd, act: str = "silu"):
    """xe: (E, C, d); weights (E, d, f) / (E, f, d)."""
    wg, wu, wd = (w.to(xe.dtype) for w in (wg, wu, wd))
    h = L.act_fn(act)(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    return torch.bmm(h, wd)


def _route(x, w_router, moe: MoEConfig, noise=None):
    probs, logits = router_probs(
        x, w_router, noise if moe.router_jitter > 0 else None)
    gate, experts = top_k(probs, moe.top_k)                  # (T, k)
    # load-balance aux (Switch / GShard): E * mean(frac_tokens) . mean(prob)
    me = probs.mean(dim=0)
    ce = F.one_hot(experts[:, 0], moe.n_experts).float().mean(dim=0)
    aux = moe.n_experts * (me * ce).sum()
    zl = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return gate, experts, aux, zl


class _Slots(NamedTuple):
    """Where each of the T * k assignments goes: expert (``n_experts`` if
    dropped), slot (0 if dropped), kept, and its token."""
    e_idx: torch.Tensor
    p_idx: torch.Tensor
    keep: torch.Tensor
    tok: torch.Tensor


def _slots(experts: torch.Tensor, n_experts: int, capacity: int) -> _Slots:
    T, k = experts.shape
    flat_e = experts.reshape(-1)                             # (T*k,)
    pos, _counts = _positions(flat_e, n_experts)
    keep = pos < capacity
    return _Slots(torch.where(keep, flat_e, n_experts),
                  torch.where(keep, pos, 0), keep,
                  torch.arange(T, device=experts.device).repeat_interleave(k))


def _bucket(x: torch.Tensor, s: _Slots, n_experts: int,
            capacity: int) -> torch.Tensor:
    """The (E, C, d) buckets: each kept assignment's token at its slot,
    zeros elsewhere (dropped ones land in a spare expert row, cut off)."""
    d = x.shape[1]
    buf = x.new_zeros(((n_experts + 1) * capacity, d))
    buf.index_copy_(0, s.e_idx * capacity + s.p_idx, x[s.tok])
    return buf[:n_experts * capacity].view(n_experts, capacity, d)


def _combine(y_buf: torch.Tensor, s: _Slots, gate: torch.Tensor,
             top: int) -> torch.Tensor:
    """Each token's kept expert outputs, weighted by its gates, summed."""
    E, C, d = y_buf.shape
    y = y_buf.reshape(E * C, d)[torch.clamp(s.e_idx, max=E - 1) * C
                                + s.p_idx]
    y = torch.where(s.keep[:, None], y, 0.0)
    return (y.view(-1, top, d) * gate[..., None].to(y.dtype)).sum(dim=1)


def _stats(aux, zl, keep) -> MoEStats:
    # the dropped count over the assignments: exactly 0 when none is
    # dropped (on CUDA, mean and division by a number multiply by its
    # reciprocal, so the reference's 1 - mean(keep) can end a rounding
    # above 0)
    return MoEStats(aux, zl,
                    (~keep).sum(dtype=torch.float32) / keep.numel())


def moe_layer_local(x: torch.Tensor, params: dict, moe: MoEConfig, *,
                    act: str = "silu", noise: torch.Tensor | None = None,
                    capacity: int | None = None):
    """One device.  x: (T, d); params ``router`` (d, E), ``w_gate`` /
    ``w_up`` (E, d, f), ``w_down`` (E, f, d).  Returns (y (T, d),
    MoEStats)."""
    T = x.shape[0]
    gate, experts, aux, zl = _route(x, params["router"], moe, noise)
    C = capacity or _capacity(T, moe.top_k, moe.n_experts,
                              moe.capacity_factor)
    s = _slots(experts, moe.n_experts, C)
    buf = _bucket(x, s, moe.n_experts, C)
    y_e = expert_glu(buf, params["w_gate"], params["w_up"],
                     params["w_down"], act)
    return _combine(y_e, s, gate, moe.top_k), _stats(aux, zl, s.keep)


def moe_layer_bucket(x: torch.Tensor, params: dict, moe: MoEConfig, *,
                     act: str = "silu", noise: torch.Tensor | None = None,
                     capacity: int | None = None):
    """Expert parallelism over ``ep`` ranks, the rank a leading dimension.

    x: (ep, T_loc, d), rank r's tokens; ``router`` (d, E), replicated;
    ``w_gate`` / ``w_up`` (ep, e_loc, d, f) and ``w_down`` (ep, e_loc, f,
    d), rank r holding experts ``r * e_loc ... (r + 1) * e_loc - 1``.
    ``noise``: optional (ep, T_loc, E).  Returns (y (ep, T_loc, d),
    MoEStats of (ep,) tensors, one per rank, as each rank's call in the
    reference returns its own)."""
    ep, T, d = x.shape
    E = moe.n_experts
    e_loc = params["w_gate"].shape[1]
    if ep * e_loc != E:
        raise ValueError(f"moe_layer_bucket: {ep} ranks x {e_loc} local "
                         f"experts != {E} experts")
    C = capacity or _capacity(T, moe.top_k, E, moe.capacity_factor)
    routed = [_route(x[r], params["router"], moe,
                     None if noise is None else noise[r])
              for r in range(ep)]
    slots = [_slots(experts, E, C) for _, experts, _, _ in routed]
    # bucket aggregation by destination expert (paper §3.1, tokens as
    # events), then one exchange: (src, dst, e_loc, C, d) -> (dst, src, ...)
    buf = torch.stack([_bucket(x[r], slots[r], E, C) for r in range(ep)])
    recv = buf.view(ep, ep, e_loc, C, d).transpose(0, 1)
    # each rank's local experts on ep * C rows: (dst, e_loc, src * C, d)
    xe = recv.permute(0, 2, 1, 3, 4).reshape(E, ep * C, d)
    wg, wu, wd = (params[n].reshape(E, *params[n].shape[2:])
                  for n in ("w_gate", "w_up", "w_down"))
    y_e = expert_glu(xe, wg, wu, wd, act)
    # the inverse exchange: (dst, e_loc, src, C, d) -> (src, dst, e_loc, ..)
    y_buf = y_e.view(ep, e_loc, ep, C, d).permute(2, 0, 1, 3, 4) \
        .reshape(ep, E, C, d)
    y = torch.stack([_combine(y_buf[r], slots[r], routed[r][0], moe.top_k)
                     for r in range(ep)])
    stats = [_stats(aux, zl, s.keep)
             for (_, _, aux, zl), s in zip(routed, slots)]
    return y, MoEStats(*(torch.stack(v) for v in zip(*stats)))
