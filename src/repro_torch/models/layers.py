"""Shared building blocks of the LM stack (port of
``src/repro/models/layers.py``): the norms, activations, rotary embeddings
(standard and Qwen2-VL's M-RoPE), Whisper's sinusoidal table, the MLPs and
the causal depthwise conv, and :func:`checkpointed`, the counterpart of
``jax.checkpoint``."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
             unit_offset: bool = False) -> torch.Tensor:
    """RMSNorm in f32, cast back to ``x``'s dtype; ``unit_offset``: the
    weight is stored as w - 1 (gemma)."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    w = w.float()
    return (x * ((1.0 + w) if unit_offset else w)).to(dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (population variance), cast back to ``x``'s
    dtype."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return ((x - mu) * torch.rsqrt(var + eps) * w + b).to(dtype)


def checkpointed(fn, *args, on: bool = True):
    """``fn(*args)``; with ``on`` and grad enabled, its intermediates are
    not kept but recomputed in the backward (``jax.checkpoint``; PyTorch's
    non-reentrant checkpoint, which nests).  Values are unchanged."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def unstack(tree) -> list:
    """Each layer's parameters of a stacked tree (nested dicts of ``(n,
    ...)`` tensors), from one ``torch.unbind`` per leaf: its backward
    stacks the layers' gradients once, where indexing layer by layer would
    add a zero tensor the size of the whole stack per layer."""
    if isinstance(tree, dict):
        per = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(torch.unbind(tree))


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
# Rotary embeddings (standard + M-RoPE)
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
    return _rotate(x, ang)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of the head dim of x (B, S, H, D) by the
    angles ang (B, S, D/2), in f32."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections,
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  positions3: (3, B, S) temporal / height /
    width position ids; sections: each axis's share of the D/2 frequency
    slots (summing to D/2).  Slot j rotates by the position id of the axis
    that owns it."""
    d = x.shape[-1]
    inv = torch.tensor(rope_freqs(d, theta), dtype=torch.float32,
                       device=x.device)                          # (D/2,)
    owner = torch.from_numpy(np.repeat(np.arange(len(sections)),
                                       np.asarray(sections))).to(x.device)
    pos = positions3.index_select(0, owner)                      # (D/2,B,S)
    return _rotate(x, pos.permute(1, 2, 0).float() * inv)


def sinusoidal_positions(n: int, d: int) -> torch.Tensor:
    """Whisper-style fixed sinusoidal table (n, d), f32 on the CPU (computed
    in float64 with numpy, as the reference does)."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (dim / max(d // 2 - 1, 1)))
    return torch.from_numpy(
        np.concatenate([np.sin(ang), np.cos(ang)], -1).astype(np.float32))


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def glu_mlp(x, wg, wu, wd, act: str = "silu"):
    h = act_fn(act)(x @ wg) * (x @ wu)
    return h @ wd


def mlp(x, w1, w2, b1=None, b2=None, act: str = "gelu"):
    h = x @ w1
    if b1 is not None:
        h = h + b1
    h = act_fn(act)(h)
    h = h @ w2
    if b2 is not None:
        h = h + b2
    return h


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
