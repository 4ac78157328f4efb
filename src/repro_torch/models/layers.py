"""Shared building blocks of the LM stack (port of the parts of
``src/repro/models/layers.py`` that the ported family reads)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, cast back to ``x``'s dtype (gemma's ``unit_offset``
    comes with that family)."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  prev: torch.Tensor | None = None):
    """Depthwise causal conv along time. x: (B, L, C); w: (K, C).

    prev: optional (B, K-1, C) left context (decode / chunked prefill).
    Returns (y, new_prev) where new_prev is the trailing K-1 inputs (a
    copy, so a cache does not keep the whole padded input alive).  The
    taps are summed in the reference's order, in ``x``'s dtype.
    """
    k = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)
    n = x.shape[1]
    y = xp[:, 0:n, :] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + n, :] * w[i]
    new_prev = xp[:, -(k - 1):, :].clone() if k > 1 else \
        torch.zeros_like(prev)
    return y, new_prev
