"""Explicit collective patterns of the sharded paths (port of
``src/repro/distributed/collectives.py``), with the mesh axis a leading
tensor dimension: a ``pmax`` / ``psum`` over the axis is a max / sum over
dimension 0, and an ``all_to_all`` is a transpose of the (source,
destination) dimensions.

* :func:`split_kv_decode_attention` -- flash-decoding over a KV cache
  split on its sequence: each shard computes partial attention with its
  local max and sum, and one logsumexp merge combines the partials.
* :func:`pipelined_all_to_all` -- the all-to-all in chunks of the
  capacity dimension (the reference scans them, so that chunk i + 1's
  exchange can overlap chunk i's use).

A shard with no valid slot gives ``m = NEG_INF``, ``p = 1`` everywhere
and ``l = T_loc``; only the combine's ``exp(m - m_max) = 0`` removes it.
``NEG_INF`` is therefore the reference's finite -2.3819763e38: with
``-inf`` that correction would be ``exp(nan)``.
"""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38


def split_kv_partial(q, k_shard, v_shard, *, scale, valid,
                     softcap: float = 0.0):
    """Per-shard partial attention.

    q: (B, 1, Hkv, G, D), every shard's; k_shard / v_shard: (n, B, T_loc,
    Hkv, D); valid: (n, B, T_loc).  Returns (m, l, acc): (n, B, 1, Hkv,
    G) twice and (n, B, 1, Hkv, G, D), all f32.
    """
    s = torch.einsum("bqhgd,nbkhd->nbqhgk", q.float(),
                     k_shard.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid[:, :, None, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)                                    # (n,B,1,Hkv,G)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("nbqhgk,nbkhd->nbqhgd", p, v_shard.float())
    return m, l, acc


def split_kv_combine(m, l, acc):
    """LogSumExp-combine the partials over the shards (dimension 0)."""
    m_max = m.amax(dim=0)
    corr = torch.exp(m - m_max)
    l_sum = (l * corr).sum(dim=0)
    acc_sum = (acc * corr[..., None]).sum(dim=0)
    return acc_sum / torch.clamp(l_sum[..., None], min=1e-37)


def split_kv_decode_attention(q, k, v, cache_len, *, scale=None, window=0,
                              softcap: float = 0.0):
    """q: (B, 1, Hq, D); k, v: (n, B, T_loc, Hkv, D), shard ``i`` holding
    global positions ``i * T_loc ... (i + 1) * T_loc - 1`` of a cache of
    ``n * T_loc`` slots; cache_len: () valid global prefix; window: the
    sliding window (0 or less = full).  Returns (B, 1, Hq, D) in q's
    dtype."""
    B, _, Hq, D = q.shape
    n, _, t_loc, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = (1.0 / D ** 0.5) if scale is None else scale
    pos = torch.arange(n * t_loc, device=q.device).view(n, t_loc)
    ok = pos < cache_len
    if not (isinstance(window, int) and window == 0):
        w = torch.as_tensor(window, device=q.device)
        ok &= (pos >= cache_len - w) | (w <= 0)
    valid = ok[:, None, :].expand(n, B, t_loc)
    qg = q.reshape(B, 1, Hkv, G, D)
    m, l, acc = split_kv_partial(qg, k, v, scale=scale, valid=valid,
                                 softcap=softcap)
    out = split_kv_combine(m, l, acc)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def pipelined_all_to_all(x, n_chunks: int):
    """x: (n, n, C, ...), source shard ``s``'s block for destination ``d``
    at ``x[s, d]``.  Returns (n, n, C, ...) with ``out[d, s] = x[s, d]``,
    exchanged in ``n_chunks`` chunks of the C dimension."""
    C = x.shape[2]
    if C % n_chunks:
        raise ValueError(f"capacity {C} is not a multiple of {n_chunks} "
                         f"chunks")
    c = C // n_chunks
    return torch.cat([x[:, :, j * c:(j + 1) * c].transpose(0, 1)
                      for j in range(n_chunks)], dim=2)
