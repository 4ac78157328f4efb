"""Hybrid recurrent / attention models (RecurrentGemma, 2:1 pattern) and
the pure-SSM Mamba-2 stack (port of ``src/repro/models/hybrid.py``):
parameter specs, the forward pass with and without caches, and the decode
caches.

RecurrentGemma's repeating pattern (rglru, rglru, local attention) is
stacked as *super-blocks* of three layers; the ``n_layers mod 3``
remaining recurrent layers (the ``tail``) follow them, as in the
reference.  Its attention is windowed in every layer, so its KV caches
are rings of the window's length.  Parameters keep the reference's
layout: block parameters are stacked along a leading axis, and the
forward takes each layer's views from one ``unbind`` per stack
(``layers.unstack``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.modules import ParamSpec


# ---------------------------------------------------------------------------
# RecurrentGemma
# ---------------------------------------------------------------------------

def _rglru_specs(cfg: ModelConfig, n: int) -> dict:
    d = cfg.d_model
    w = cfg.recurrent.lru_width or d
    k = cfg.recurrent.conv_width
    return {
        "w_in": ParamSpec((n, d, w), ("layers", "embed", "mlp")),
        "w_gate": ParamSpec((n, d, w), ("layers", "embed", "mlp")),
        "w_out": ParamSpec((n, w, d), ("layers", "mlp", "embed")),
        "conv_w": ParamSpec((n, k, w), ("layers", None, "mlp"), init="small"),
        "conv_b": ParamSpec((n, w), ("layers", "mlp"), init="zeros"),
        "w_a": ParamSpec((n, w, w), ("layers", "mlp", None), init="small"),
        "b_a": ParamSpec((n, w), ("layers", "mlp"), init="zeros"),
        "w_x": ParamSpec((n, w, w), ("layers", "mlp", None), init="small"),
        "b_x": ParamSpec((n, w), ("layers", "mlp"), init="zeros"),
        "lam": ParamSpec((n, w), ("layers", "mlp"), init="ones"),
        "ln": ParamSpec((n, d), ("layers", "embed"), init="ones"),
    }


def rg_param_specs(cfg: ModelConfig) -> dict:
    ns = cfg.n_layers // 3            # super-blocks (r, r, attn)
    rem = cfg.n_layers % 3            # trailing extra recurrent layers
    norm = lambda n: ParamSpec((n, cfg.d_model), ("layers", "embed"),
                               init="ones")
    specs = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           init="embed"),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "super": {
            "r0": _rglru_specs(cfg, ns),
            "r1": _rglru_specs(cfg, ns),
            "attn": {**T._attn_specs(cfg, ns), **T._norm_specs(cfg, ns)},
            **{f"mlp{i}": T._mlp_specs(cfg, ns, cfg.d_ff) for i in range(3)},
            **{f"mln{i}": norm(ns) for i in range(3)},
        },
    }
    if rem:
        specs["tail"] = {
            **{f"r{i}": _rglru_specs(cfg, 1) for i in range(rem)},
            **{f"mlp{i}": T._mlp_specs(cfg, 1, cfg.d_ff) for i in range(rem)},
            **{f"mln{i}": norm(1) for i in range(rem)},
        }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab),
                                     ("embed", "vocab"))
    return specs


class RGCaches(NamedTuple):
    r0: R.RGLRUCache         # stacked over super-blocks
    r1: R.RGLRUCache
    attn: A.KVCache          # ring caches of the window's length
    tail: tuple              # one RGLRUCache per tail layer


def _recurrent_residual(p, x, cfg, cache):
    p = T.cast_params(p)
    h = L.rms_norm(x, p["ln"], cfg.rms_eps)
    o, cache = R.recurrent_block(p, h, cfg, cache)
    return x + o, cache


def _mlp_residual(p, ln, x, cfg):
    p = T.cast_params(p)
    h = L.rms_norm(x, ln, cfg.rms_eps)      # ln uncast, as in the reference
    return x + L.glu_mlp(h, p["wg"].to(h.dtype), p["wu"].to(h.dtype),
                         p["wd"].to(h.dtype), cfg.act)


def _rg_cache(c, i: int):
    """Super-block ``i``'s view of a stacked cache (NamedTuple)."""
    return type(c)(*(t[i] for t in c))


def _rg_stack(caches: list):
    return type(caches[0])(*(torch.stack(t) for t in zip(*caches)))


def rg_forward(params, tokens: torch.Tensor, cfg: ModelConfig,
               caches: RGCaches | None = None, rt: T.Runtime | None = None):
    """RecurrentGemma forward: stateless (full sequence) without
    ``caches``, else prefill (S > 1) or decode (S == 1) against them.
    Positions continue from the first attention cache's length.
    ``rt.remat``: under autograd each super-block and tail layer is
    recomputed in the backward.  Returns (hidden, aux (= 0), new caches or
    None; the old ones are left as they were)."""
    rt = rt or T.DEFAULT
    B, Sq = tokens.shape
    off = caches.attn.length[0] if caches is not None else 0
    positions = (off + torch.arange(Sq, device=tokens.device)).expand(B, Sq)
    x = T.embed_tokens(params, tokens, cfg, rt=rt)
    x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                         device=x.device)
    win = cfg.sliding_window

    def super_block(x, p, c):
        x, c0 = _recurrent_residual(p["r0"], x, cfg, c[0])
        x = _mlp_residual(p["mlp0"], p["mln0"], x, cfg)
        x, c1 = _recurrent_residual(p["r1"], x, cfg, c[1])
        x = _mlp_residual(p["mlp1"], p["mln1"], x, cfg)
        x, kv = T.attn_block(p["attn"], x, cfg, rt, window=win,
                             positions=positions, cache=c[2],
                             ring=caches is not None)
        return _mlp_residual(p["mlp2"], p["mln2"], x, cfg), (c0, c1, kv)

    def tail_layer(x, p, c):
        x, c = _recurrent_residual(p["r"], x, cfg, c)
        return _mlp_residual(p["mlp"], p["mln"], x, cfg), c

    new_r0, new_r1, new_kv = [], [], []
    for i, p in enumerate(L.unstack(params["super"])):
        c = (None, None, None) if caches is None else (
            _rg_cache(caches.r0, i), _rg_cache(caches.r1, i),
            _rg_cache(caches.attn, i))
        x, (c0, c1, kv) = L.checkpointed(super_block, x, p, c, on=rt.remat)
        new_r0.append(c0)
        new_r1.append(c1)
        new_kv.append(kv)
    new_tail = []
    tail = params.get("tail", {})
    for i in range(cfg.n_layers % 3):
        p = {"r": L.unstack(tail[f"r{i}"])[0],
             "mlp": L.unstack(tail[f"mlp{i}"])[0],
             "mln": tail[f"mln{i}"][0]}
        x, ci = L.checkpointed(tail_layer, x, p,
                               None if caches is None else caches.tail[i],
                               on=rt.remat)
        new_tail.append(ci)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if caches is None:
        return x, aux, None
    return x, aux, RGCaches(_rg_stack(new_r0), _rg_stack(new_r1),
                            _rg_stack(new_kv), tuple(new_tail))


def rg_init_caches(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                   device=None) -> RGCaches:
    """Zero caches (``device=None`` is CUDA): the RG-LRU's conv context and
    f32 state per recurrent layer, and a ring KV cache of the window's
    length per attention layer."""
    device = dispatch.resolve_device(device)
    ns, rem = cfg.n_layers // 3, cfg.n_layers % 3
    w = cfg.recurrent.lru_width or cfg.d_model
    k = cfg.recurrent.conv_width
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt,
                                                 device=device)
    mk_r = lambda *lead: R.RGLRUCache(
        conv=zeros(*lead, batch, k - 1, w),
        h=zeros(*lead, batch, w, dt=torch.float32))
    kv_shape = (ns, batch, cfg.sliding_window, cfg.n_kv_heads, cfg.head_dim)
    kv = A.KVCache(k=zeros(*kv_shape), v=zeros(*kv_shape),
                   length=zeros(ns, dt=torch.int32))
    return RGCaches(mk_r(ns), mk_r(ns), kv, tuple(mk_r() for _ in range(rem)))


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------


def mamba2_param_specs(cfg: ModelConfig) -> dict:
    n = cfg.n_layers
    d = cfg.d_model
    d_inner, H, conv_dim = S.dims(cfg)
    g, ns = cfg.ssm.n_groups, cfg.ssm.d_state
    in_dim = 2 * d_inner + 2 * g * ns + H
    specs = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), init="embed"),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "blocks": {
            "in_proj": ParamSpec((n, d, in_dim), ("layers", "embed", "mlp")),
            "conv_w": ParamSpec((n, cfg.ssm.d_conv, conv_dim),
                                ("layers", None, "mlp"), init="small"),
            "conv_b": ParamSpec((n, conv_dim), ("layers", "mlp"), init="zeros"),
            "dt_bias": ParamSpec((n, H), ("layers", "heads"), init="zeros"),
            "A_log": ParamSpec((n, H), ("layers", "heads"), init="zeros"),
            "D": ParamSpec((n, H), ("layers", "heads"), init="ones"),
            "norm_w": ParamSpec((n, d_inner), ("layers", "mlp"), init="ones"),
            "out_proj": ParamSpec((n, d_inner, d), ("layers", "mlp", "embed")),
            "ln": ParamSpec((n, d), ("layers", "embed"), init="ones"),
        },
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"))
    return specs


def mamba2_forward(params, tokens: torch.Tensor, cfg: ModelConfig,
                   caches: S.SSMCache | None = None,
                   rt: T.Runtime | None = None):
    """Returns (hidden, aux (= 0), new_caches).  ``caches``: an
    ``SSMCache`` of tensors stacked over layers; the new caches are new
    tensors (the old ones are left as they were).  ``rt.remat``: under
    autograd each layer is recomputed in the backward (its SSD chunks
    launched again)."""
    rt = rt or T.DEFAULT
    x = T.embed_tokens(params, tokens, cfg, rt=rt)

    def layer(x, p, cache):
        p = T.cast_params(p)
        h = L.rms_norm(x, p["ln"], cfg.rms_eps)
        o, c_new = S.mamba2_block(p, h, cfg, cache)
        return x + o, c_new

    convs, states = [], []
    for i, p in enumerate(L.unstack(params["blocks"])):
        cache = None if caches is None else \
            S.SSMCache(caches.conv[i], caches.state[i])
        x, c_new = L.checkpointed(layer, x, p, cache, on=rt.remat)
        if c_new is not None:
            convs.append(c_new.conv)
            states.append(c_new.state)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    new = S.SSMCache(torch.stack(convs), torch.stack(states)) \
        if caches is not None else None
    return x, torch.zeros((), dtype=torch.float32, device=x.device), new


def mamba2_init_caches(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                       device=None) -> S.SSMCache:
    """Zero caches stacked over layers (``device=None`` is CUDA)."""
    device = dispatch.resolve_device(device)
    d_inner, H, conv_dim = S.dims(cfg)
    n = cfg.n_layers
    return S.SSMCache(
        conv=torch.zeros((n, batch, cfg.ssm.d_conv - 1, conv_dim),
                         dtype=dtype, device=device),
        state=torch.zeros((n, batch, H, cfg.ssm.head_dim, cfg.ssm.d_state),
                          dtype=torch.float32, device=device),
    )
