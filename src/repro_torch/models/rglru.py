"""RG-LRU recurrent block of RecurrentGemma / Griffin (port of
``src/repro/models/rglru.py``).

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_a x_t + b_a)                      (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                      (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)            (per-channel decay)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill scans the length axis in f32 (:func:`rglru_scan`); decode is the
one-step update.  The residual block is Griffin's: linear in, temporal
conv, RG-LRU, a multiplicative GELU gate (the tanh form, which is
``jax.nn.gelu``'s default), linear out.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

C_RGLRU = 8.0


class RGLRUCache(NamedTuple):
    conv: torch.Tensor       # (B, K-1, W) conv left-context
    h: torch.Tensor          # (B, W) recurrent state (f32)


def _gates(params, x):
    """Per-step decay ``a`` and gated input ``b`` of the recurrence, both
    f32: h_t = a_t * h_{t-1} + b_t."""
    r = torch.sigmoid(x @ params["w_a"].to(x.dtype)
                      + params["b_a"].to(x.dtype))
    i = torch.sigmoid(x @ params["w_x"].to(x.dtype)
                      + params["b_x"].to(x.dtype))
    log_a = -C_RGLRU * F.softplus(params["lam"]) * r.float()
    a = torch.exp(log_a)
    gated = (i * x).float() * torch.sqrt(
        torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, gated


def rglru_scan(params, x, h0=None):
    """x: (B, L, W).  Returns (y in x's dtype, h_final f32).

    A log-depth doubling scan over L in f32: after the pass with offset
    ``o`` each step holds the composition of the ``2 o`` steps ending at
    it, pairs composing as (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2).
    It sums in another order than XLA's ``associative_scan``, so it
    agrees with the reference within a tolerance, not bit for bit.
    """
    a, b = _gates(params, x)                     # (B, L, W) f32
    if h0 is not None:
        # fold the initial state in as a virtual step 0
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0[:, None, :].float(), b], dim=1)
    n = a.shape[1]
    o = 1
    while o < n:
        b = torch.cat([b[:, :o], a[:, o:] * b[:, :-o] + b[:, o:]], dim=1)
        a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], dim=1)
        o *= 2
    if h0 is not None:
        b = b[:, 1:]
    return b.to(x.dtype), b[:, -1]


def rglru_step(params, x_t, h):
    """x_t: (B, W); h: (B, W) f32.  Returns (y in x_t's dtype, new h)."""
    a, b = _gates(params, x_t[:, None, :])
    h = a[:, 0] * h + b[:, 0]
    return h.to(x_t.dtype), h


def recurrent_block(params, x, cfg: ModelConfig,
                    cache: RGLRUCache | None = None):
    """Griffin recurrent residual branch.  x: (B, L, d_model).  Returns
    (out, new cache or None)."""
    gate = L.act_fn("gelu")(x @ params["w_gate"].to(x.dtype))   # (B, L, W)
    xr = x @ params["w_in"].to(x.dtype)
    conv_prev = cache.conv if cache is not None else None
    xr, conv_new = L.causal_conv1d(xr, params["conv_w"].to(x.dtype),
                                   conv_prev)
    xr = xr + params["conv_b"].to(x.dtype)
    if cache is None or x.shape[1] > 1:
        y, h_last = rglru_scan(params, xr,
                               cache.h if cache is not None else None)
    else:
        y, h_last = rglru_step(params, xr[:, 0], cache.h)
        y = y[:, None]
    out = ((y * gate) @ params["w_out"].to(gate.dtype)).to(x.dtype)
    new_cache = RGLRUCache(conv=conv_new, h=h_last) \
        if cache is not None else None
    return out, new_cache
