"""Mamba-2 SSD blocks: chunked prefill scan and O(1)-state decode (port of
``src/repro/models/ssm.py``).

Shapes: B batch, Lq length, H heads, Pd head_dim, N d_state, G groups.
Block layout follows mamba2: in_proj -> [z | x | B | C | dt], causal
depthwise conv over [x|B|C], SSD, gated RMSNorm, out_proj.

The chunked scan loops over chunks on the host; each chunk is one call of
``kernels.ssd_chunk.ssd_chunk_grad`` for all B*H pairs (one kernel launch
on the card; under autograd its backward is the plain version's vjp, the
reference having no backward kernel).  It computes in f32 throughout, as the reference's kernel and
``ssd_chunk_ref`` do; the reference's jnp scan instead rounds its scores
and carried state to the inputs' dtype, so on bf16 inputs the two agree
only to bf16 precision.  Decode stays plain PyTorch, as the reference has
no kernel for it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_chunk import ssd_chunk_grad
from repro_torch.models import layers as L


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, K-1, conv_dim) conv left context
    state: torch.Tensor   # (B, H, Pd, N) SSD recurrent state, f32


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim


def ssd_chunked(x, dt, A, B_, C_, chunk: int):
    """Chunked SSD scan from a zero state.

    x:  (B, Lq, H, Pd)   inputs (already conv'd / activated)
    dt: (B, Lq, H)       positive step sizes
    A:  (H,)             negative decay rates
    B_, C_: (B, Lq, G, N)
    Lq must be a multiple of ``chunk``.
    Returns y (B, Lq, H, Pd) and the final state (B, H, Pd, N), both f32,
    differentiable in every input (the state carries the gradient from
    chunk to chunk).
    """
    Bb, Lq, H, Pd = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if Lq % chunk:
        raise ValueError(f"sequence {Lq} is not a multiple of chunk {chunk}")
    nc = Lq // chunk
    # chunk-major, pair-major layout: every chunk a contiguous
    # (B*H, chunk, ·) block, pairs ordered batch-major, head-minor
    xc = x.reshape(Bb, nc, chunk, H, Pd).permute(1, 0, 3, 2, 4).contiguous()
    dtc = dt.float().reshape(Bb, nc, chunk, H).permute(1, 0, 3, 2) \
        .contiguous()
    Bc = B_.reshape(Bb, nc, chunk, G, N).permute(1, 0, 3, 2, 4).contiguous()
    Cc = C_.reshape(Bb, nc, chunk, G, N).permute(1, 0, 3, 2, 4).contiguous()
    A_pairs = A.float().repeat(Bb)                      # pair b*H + h -> A[h]
    S = torch.zeros((Bb * H, Pd, N), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(nc):
        y, S = ssd_chunk_grad(xc[i].view(Bb * H, chunk, Pd),
                         dtc[i].view(Bb * H, chunk), A_pairs,
                         Bc[i].view(Bb * G, chunk, N),
                         Cc[i].view(Bb * G, chunk, N), S)
        ys.append(y)
    y = torch.stack(ys).view(nc, Bb, H, chunk, Pd).permute(1, 0, 3, 2, 4)
    return y.reshape(Bb, Lq, H, Pd), S.view(Bb, H, Pd, N)


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One-token SSD update, in f32.

    state: (B,H,Pd,N); x_t: (B,H,Pd); dt_t: (B,H); B_t, C_t: (B,G,N).
    """
    H = x_t.shape[1]
    G = B_t.shape[1]
    rep = H // G
    Bh, Ch = B_t.float(), C_t.float()                     # (B,H,N)
    if rep > 1:
        Bh = Bh.repeat_interleave(rep, dim=1)
        Ch = Ch.repeat_interleave(rep, dim=1)
    dt_t = dt_t.float()
    decay = torch.exp(dt_t * A[None, :])[..., None, None]  # (B,H,1,1)
    upd = dt_t[..., None, None] * x_t.float()[..., None] * Bh[:, :, None, :]
    state = state * decay + upd
    y = (state @ Ch[..., None])[..., 0]                    # (B,H,Pd)
    return state, y


def mamba2_block(params, x, cfg: ModelConfig, cache: SSMCache | None = None):
    """Full block. x: (B, Lq, d_model). Returns (y, new_cache).

    With a cache and Lq > 1 (prefill) the scan starts from a zero state
    and only the conv takes the cache's left context, as in the reference.
    """
    s = cfg.ssm
    d_inner, H, conv_dim = dims(cfg)
    G, N, Pd = s.n_groups, s.d_state, s.head_dim
    Bb, Lq, _ = x.shape

    zxbcdt = x @ params["in_proj"].to(x.dtype)              # (B,L,·)
    z, xbc, dt = torch.split(zxbcdt, [d_inner, conv_dim, H], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])         # (B,L,H) f32

    conv_prev = cache.conv if cache is not None else None
    xbc, conv_new = L.causal_conv1d(xbc, params["conv_w"].to(xbc.dtype),
                                    conv_prev)
    xbc = F.silu(xbc + params["conv_b"].to(xbc.dtype))
    xs, B_, C_ = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(Bb, Lq, H, Pd)
    B_ = B_.reshape(Bb, Lq, G, N)
    C_ = C_.reshape(Bb, Lq, G, N)
    A = -torch.exp(params["A_log"].float())                 # (H,)

    if cache is None or Lq > 1:
        pad = (-Lq) % s.chunk
        if pad:     # dt = 0 on the padding: it neither decays nor feeds
            padded = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
            y, st = ssd_chunked(padded(xs), padded(dt), A, padded(B_),
                                padded(C_), s.chunk)
            y = y[:, :Lq]
        else:
            y, st = ssd_chunked(xs, dt, A, B_, C_, s.chunk)
    else:
        st, y = ssd_decode_step(cache.state, xs[:, 0], dt[:, 0], A,
                                B_[:, 0], C_[:, 0])
        y = y[:, None]
    y = y.float() + xs.float() * params["D"][None, None, :, None]
    y = y.reshape(Bb, Lq, d_inner).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), params["norm_w"], cfg.rms_eps)
    out = y @ params["out_proj"].to(y.dtype)
    new_cache = SSMCache(conv=conv_new, state=st.float()) \
        if cache is not None else None
    return out, new_cache
