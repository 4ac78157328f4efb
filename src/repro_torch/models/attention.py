"""Attention: GQA / MQA / MHA with the zoo's variants, memory-bounded (port
of ``src/repro/models/attention.py``).

Prefill attention is flash-style: an online softmax over KV chunks in f32,
so the (S, S) score matrix is never materialised.  Masking (causal and
sliding window) is computed from absolute indices inside each chunk.
Grouped KV heads are expanded to the query heads (query head ``h`` reads
KV head ``h // G``), chunk by chunk (``gqa="expand"``), or the queries
are viewed as (Hkv, G) groups and K/V never expand (``gqa="group"``, the
reference's route for context-parallel training, where each KV head's
gradient stays Hkv-sized).  The split-KV decode is
``distributed.collectives``.

Variants: grouped KV heads, the attention-logit softcap (applied to the f32
scores before the mask) and query-scale override (gemma2), sliding-window
local attention, and decode against a KV cache, linear or ring.  The mask
value is ``NEG_INF`` and the output divides by ``max(l, 1e-37)``, as in the
reference.  The reference pads the last KV chunk to the chunk size; here it
is shorter, which only drops masked entries whose probability is 0.

The reference computes attention in plain ``jnp`` (no Pallas kernel), and
so does this module in plain PyTorch.  Caches are functional, as in the
reference: :func:`cache_update` returns new tensors and never syncs with
the host (cache lengths stay device tensors).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import dispatch
from repro_torch.models import layers as L

NEG_INF = -2.3819763e38     # flash-attention convention


def _kv_head_map(hq: int, hkv: int, device) -> torch.Tensor:
    """Gather indices expanding kv heads to query heads."""
    return torch.arange(hq, device=device) // (hq // hkv)


def _expand_heads(t: torch.Tensor, hq: int) -> torch.Tensor:
    """(B, C, Hkv, D) -> (B, C, hq, D), query head ``h`` reading KV head
    ``h // (hq // Hkv)``: the same copy as gathering by
    :func:`_kv_head_map`, but its backward is a sum over each group, where
    a gather's backward adds with atomics (on the card, in bf16 and in
    another order every run)."""
    B, C, hkv, D = t.shape
    if hkv == hq:
        return t
    return t[:, :, :, None, :].expand(B, C, hkv, hq // hkv, D) \
        .reshape(B, C, hq, D)


def _scores(q, k, scale, cap):
    # q: (B, Sq, H, D) k: (B, Ck, H, D) -> (B, Sq, H, Ck), f32
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
    if cap:
        s = cap * torch.tanh(s / cap)
    return s


def _chunk_step(q, kj, vj, mask, m, l, acc, scale, cap):
    """One KV chunk of the online softmax: (m, l, acc) -> updated."""
    s = _scores(q, kj, scale, cap)                          # (B, Sq, Hq, C)
    s = torch.where(mask[None, :, None, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bqhk,bkhd->bqhd", p,
                                               vj.float())
    return m_new, l, acc


def _group_step(qg, kj, vj, mask, m, l, acc, scale, cap):
    """:func:`_chunk_step` with the queries in (Hkv, G) groups: qg (B, Sq,
    Hkv, G, D), kj / vj (B, C, Hkv, D) unexpanded."""
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(), kj.float()) * scale
    if cap:
        s = cap * torch.tanh(s / cap)
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p,
                                               vj.float())
    return m_new, l, acc


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None,
                    q_offset=0, kv_len=None, chunk: int = 1024,
                    gqa: str = "expand"):
    """Online-softmax attention.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); Hq % Hkv == 0.
    window: keys with ``q - kv < window`` (0 = no window).
    q_offset: absolute index of q[0].  kv_len: optional () tensor or int,
    the valid KV prefix length (the rest masked).  gqa: ``"expand"`` (K/V
    copied to the Hq query heads, chunk by chunk) or ``"group"`` (Q viewed
    as (B, Sq, Hkv, G, D); K/V never expand).  Under autograd each chunk
    step is checkpointed, as in the reference: the backward recomputes a
    chunk's (.., chunk) scores and probabilities instead of keeping them
    for every chunk.
    """
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if gqa not in ("expand", "group"):
        raise ValueError(f"gqa {gqa!r}: expand or group")
    scale = (1.0 / D ** 0.5) if scale is None else scale
    chunk = min(chunk, Skv)
    q_idx = q_offset + torch.arange(Sq, device=q.device)
    heads = (B, Sq, Hkv, Hq // Hkv) if gqa == "group" else (B, Sq, Hq)
    m = torch.full(heads, NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(heads, dtype=torch.float32, device=q.device)
    acc = torch.zeros(heads + (D,), dtype=torch.float32, device=q.device)
    if gqa == "group":
        qg = q.view(B, Sq, Hkv, Hq // Hkv, D)
        step = lambda kj, vj, mask, m, l, acc: _group_step(
            qg, kj, vj, mask, m, l, acc, scale, softcap)
    else:
        step = lambda kj, vj, mask, m, l, acc: _chunk_step(
            q, _expand_heads(kj, Hq), _expand_heads(vj, Hq), mask, m, l,
            acc, scale, softcap)
    for j0 in range(0, Skv, chunk):
        kv_idx = torch.arange(j0, min(j0 + chunk, Skv), device=q.device)
        mask = torch.ones((Sq, kv_idx.numel()), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_idx[:, None] >= kv_idx[None, :]
        if window > 0:
            mask &= (q_idx[:, None] - kv_idx[None, :]) < window
        if kv_len is not None:
            mask &= (kv_idx < kv_len)[None, :]
        m, l, acc = L.checkpointed(step, k[:, j0:j0 + chunk],
                                   v[:, j0:j0 + chunk], mask, m, l, acc)
    out = acc / torch.clamp(l[..., None], min=1e-37)
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


# --------------------------------------------------------------------------
# Decode path with KV cache
# --------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor          # (B, T, Hkv, D)  (T = window for ring layers)
    v: torch.Tensor          # (B, T, Hkv, D)
    length: torch.Tensor     # () int32 tokens already in the cache


def init_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
               dtype=torch.bfloat16, *, device=None) -> KVCache:
    """Zero cache (``device=None`` is CUDA)."""
    device = dispatch.resolve_device(device)
    shape = (batch, max_len, n_kv, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))


def cache_update(cache: KVCache, k_new, v_new, *,
                 ring: bool = False) -> KVCache:
    """Append S_new tokens; ``ring=True`` wraps (sliding-window layers).

    Linear: written at ``length``, the start clamped so that the update
    fits (``lax.dynamic_update_slice``'s rule).  Ring: slot ``p % T`` of
    absolute position ``p``; a long prefill (``S_new >= T``) keeps only the
    trailing window, each slot written once.
    """
    T = cache.k.shape[1]
    s = k_new.shape[1]
    if ring:
        if s >= T:
            k_new, v_new = k_new[:, -T:], v_new[:, -T:]
            start = cache.length + (s - T)
        else:
            start = cache.length
        idx = torch.remainder(
            start + torch.arange(k_new.shape[1], device=k_new.device), T)
    else:
        start = torch.clamp(cache.length, 0, T - s)
        idx = start + torch.arange(s, device=k_new.device)
    k = cache.k.index_copy(1, idx, k_new.to(cache.k.dtype))
    v = cache.v.index_copy(1, idx, v_new.to(cache.v.dtype))
    return KVCache(k, v, cache.length + s)


def decode_attention(q, cache: KVCache, *, window: int = 0,
                     softcap: float = 0.0, scale: float | None = None,
                     ring: bool = False, chunk: int = 4096):
    """Single-step attention against the cache (after its update), over
    cache chunks.  q: (B, 1, Hq, D).  Linear caches keep ``pos < cur`` and,
    windowed, ``pos >= cur - window``; ring caches keep the slots younger
    than the window (or than ``min(cur, T)``)."""
    B, _, Hq, D = q.shape
    T, Hkv = cache.k.shape[1], cache.k.shape[2]
    scale = (1.0 / D ** 0.5) if scale is None else scale
    hmap = _kv_head_map(Hq, Hkv, q.device)
    cur = cache.length          # tokens in the cache, the new one included
    pos = torch.arange(T, device=q.device)
    if ring:
        age = torch.remainder(cur - 1 - pos, T)
        ok = age < window if window > 0 else age < torch.clamp(cur, max=T)
    else:
        ok = pos < cur
        if window > 0:
            ok &= pos >= cur - window
    m = torch.full((B, Hq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hq, D), dtype=torch.float32, device=q.device)
    for j0 in range(0, T, chunk):
        kj = cache.k[:, j0:j0 + chunk].index_select(2, hmap)
        vj = cache.v[:, j0:j0 + chunk].index_select(2, hmap)
        s = _scores(q, kj, scale, softcap)[:, 0]           # (B, Hq, C)
        s = torch.where(ok[j0:j0 + chunk], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhk,bkhd->bhd", p, vj.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-37)
    return out[:, None].to(q.dtype)
