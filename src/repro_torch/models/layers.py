"""Shared building blocks of the LM stack (port of the parts of
``src/repro/models/layers.py`` that the ported families read; M-RoPE,
``layer_norm``, ``mlp`` and the sinusoidal table come with the vision and
audio families)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
             unit_offset: bool = False) -> torch.Tensor:
    """RMSNorm in f32, cast back to ``x``'s dtype; ``unit_offset``: the
    weight is stored as w - 1 (gemma)."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    w = w.float()
    return (x * ((1.0 + w) if unit_offset else w)).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def act_fn(name: str):
    """The reference's activations: ``jax.nn.gelu`` is the tanh
    approximation by default, so ``gelu`` and ``gelu_tanh`` both are."""
    gelu = lambda x: F.gelu(x, approximate="tanh")
    return {"silu": F.silu, "gelu": gelu, "gelu_tanh": gelu}[name]


# --------------------------------------------------------------------------
# Rotary embeddings (standard; M-RoPE comes with the vision family)
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int.  Rotates the two halves of
    the head dim (not interleaved) in f32."""
    d = x.shape[-1]
    inv = torch.tensor(rope_freqs(d, theta), dtype=torch.float32,
                       device=x.device)                          # (D/2,)
    ang = positions[..., None].float() * inv                     # (B,S,D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# GLU MLP
# --------------------------------------------------------------------------

def glu_mlp(x, wg, wu, wd, act: str = "silu"):
    h = act_fn(act)(x @ wg) * (x @ wu)
    return h @ wd


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
