"""Whisper-style encoder-decoder backbone (port of
``src/repro/models/encdec.py``).  The conv frontend is a stub: the
encoder takes precomputed frame embeddings.

Encoder: bidirectional self-attention blocks over ``enc_ctx`` frames with
fixed sinusoidal positions.  Decoder: causal self-attention, then cross
attention into the encoder output.  LayerNorm (not RMS), GELU MLPs with
biases, learned decoder positions, as in the Whisper family.  Decoding
keeps two caches per layer: the self-attention's, linear, and the cross
attention's, filled once from the encoder output
(:func:`fill_cross_cache`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.modules import ParamSpec


def _attn_ln_specs(cfg: ModelConfig, n: int, pre: str) -> dict:
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        pre + "wq": ParamSpec((n, d, H, Dh), ("layers", "embed", "heads", "head_dim")),
        pre + "wk": ParamSpec((n, d, Hkv, Dh), ("layers", "embed", "kv_heads", "head_dim")),
        pre + "wv": ParamSpec((n, d, Hkv, Dh), ("layers", "embed", "kv_heads", "head_dim")),
        pre + "wo": ParamSpec((n, H, Dh, d), ("layers", "heads", "head_dim", "embed")),
        pre + "ln_w": ParamSpec((n, d), ("layers", "embed"), init="ones"),
        pre + "ln_b": ParamSpec((n, d), ("layers", "embed"), init="zeros"),
    }


def _mlp_ln_specs(cfg: ModelConfig, n: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "m_w1": ParamSpec((n, d, f), ("layers", "embed", "mlp")),
        "m_b1": ParamSpec((n, f), ("layers", "mlp"), init="zeros"),
        "m_w2": ParamSpec((n, f, d), ("layers", "mlp", "embed")),
        "m_b2": ParamSpec((n, d), ("layers", "embed"), init="zeros"),
        "m_ln_w": ParamSpec((n, d), ("layers", "embed"), init="ones"),
        "m_ln_b": ParamSpec((n, d), ("layers", "embed"), init="zeros"),
    }


def whisper_param_specs(cfg: ModelConfig, max_dec_pos: int = 4096) -> dict:
    ne, nd = cfg.enc_layers, cfg.n_layers
    d = cfg.d_model
    return {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), init="embed"),
        "dec_pos": ParamSpec((max_dec_pos, d), (None, "embed"), init="small"),
        "enc": {**_attn_ln_specs(cfg, ne, "sa_"), **_mlp_ln_specs(cfg, ne)},
        "enc_ln_w": ParamSpec((d,), ("embed",), init="ones"),
        "enc_ln_b": ParamSpec((d,), ("embed",), init="zeros"),
        "dec": {**_attn_ln_specs(cfg, nd, "sa_"),
                **_attn_ln_specs(cfg, nd, "xa_"), **_mlp_ln_specs(cfg, nd)},
        "dec_ln_w": ParamSpec((d,), ("embed",), init="ones"),
        "dec_ln_b": ParamSpec((d,), ("embed",), init="zeros"),
    }


def _mha(p, pre, xq, xkv, cfg, rt, *, causal, cache=None):
    """LayerNorm attention residual (no RoPE: Whisper's positions are
    absolute).  ``xkv`` None: self-attention on the normed ``xq``; else
    keys and values from ``xkv`` as given.  Returns (x, new cache)."""
    h = L.layer_norm(xq, p[pre + "ln_w"], p[pre + "ln_b"])
    hk = xkv if xkv is not None else h
    q = T._proj(h, p[pre + "wq"])
    k = T._proj(hk, p[pre + "wk"])
    v = T._proj(hk, p[pre + "wv"])
    if cache is not None:
        cache = A.cache_update(cache, k, v)
        if xq.shape[1] == 1:
            o = A.decode_attention(q, cache)
        else:
            o = A.flash_attention(q, cache.k, cache.v, causal=causal,
                                  kv_len=cache.length, chunk=rt.attn_chunk)
    else:
        o = A.flash_attention(q, k, v, causal=causal, chunk=rt.attn_chunk)
    return xq + T._out(o, p[pre + "wo"]), cache


def _mlp_res(p, x, cfg):
    h = L.layer_norm(x, p["m_ln_w"], p["m_ln_b"])
    return x + L.mlp(h, p["m_w1"].to(h.dtype), p["m_w2"].to(h.dtype),
                     p["m_b1"].to(h.dtype), p["m_b2"].to(h.dtype),
                     act="gelu")


def encode(params, frames: torch.Tensor, cfg: ModelConfig,
           rt: T.Runtime | None = None) -> torch.Tensor:
    """frames: (B, enc_ctx, d_model), precomputed conv-frontend
    embeddings.  Returns the encoder's hidden states (bf16).
    ``rt.remat``: under autograd each layer is recomputed in the
    backward."""
    rt = rt or T.DEFAULT
    x = frames.to(torch.bfloat16)
    x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model).to(
        device=x.device, dtype=x.dtype)

    def layer(x, p):
        p = T.cast_params(p)
        x, _ = _mha(p, "sa_", x, None, cfg, rt, causal=False)
        return _mlp_res(p, x, cfg)

    for p in L.unstack(params["enc"]):
        x = L.checkpointed(layer, x, p, on=rt.remat)
    return L.layer_norm(x, params["enc_ln_w"], params["enc_ln_b"])


def _kv(c: A.KVCache, layer: int) -> A.KVCache:
    return A.KVCache(c.k[layer], c.v[layer], c.length[layer])


class WhisperCaches(NamedTuple):
    self_kv: A.KVCache       # stacked (L, ...)
    cross_kv: A.KVCache      # stacked; length set once at prefill


def decode(params, tokens: torch.Tensor, enc_out, cfg: ModelConfig,
           caches: WhisperCaches | None = None,
           rt: T.Runtime | None = None):
    """Decoder forward: stateless over ``enc_out`` without ``caches``, else
    against them (the cross caches already filled).  Positions continue
    from the first self-attention cache's length.  ``rt.remat``: under
    autograd each layer is recomputed in the backward.  Returns (hidden,
    new caches or None; the old ones are left as they were)."""
    rt = rt or T.DEFAULT
    Sq = tokens.shape[1]
    off = caches.self_kv.length[0] if caches is not None else 0
    positions = off + torch.arange(Sq, device=tokens.device)
    x = params["embed"].to(torch.bfloat16)[tokens]
    x = x + params["dec_pos"][positions].to(x.dtype)

    def stateless(x, p):
        p = T.cast_params(p)
        x, _ = _mha(p, "sa_", x, None, cfg, rt, causal=True)
        x, _ = _mha(p, "xa_", x, enc_out, cfg, rt, causal=False)
        return _mlp_res(p, x, cfg)

    sk, sv, sl = [], [], []
    for layer, p in enumerate(L.unstack(params["dec"])):
        if caches is None:
            x = L.checkpointed(stateless, x, p, on=rt.remat)
            continue
        p = T.cast_params(p)
        s_kv = _kv(caches.self_kv, layer)
        x_kv = _kv(caches.cross_kv, layer)
        x, s_kv = _mha(p, "sa_", x, None, cfg, rt, causal=True, cache=s_kv)
        # cross attention reads the (already filled) encoder cache
        h = L.layer_norm(x, p["xa_ln_w"], p["xa_ln_b"])
        q = T._proj(h, p["xa_wq"])
        if Sq == 1:
            o = A.decode_attention(q, x_kv)
        else:
            o = A.flash_attention(q, x_kv.k, x_kv.v, causal=False,
                                  kv_len=x_kv.length, chunk=rt.attn_chunk)
        x = x + T._out(o, p["xa_wo"])
        sk.append(s_kv.k)
        sv.append(s_kv.v)
        sl.append(s_kv.length)
        x = _mlp_res(p, x, cfg)
    x = L.layer_norm(x, params["dec_ln_w"], params["dec_ln_b"])
    if caches is None:
        return x, None
    return x, WhisperCaches(A.KVCache(torch.stack(sk), torch.stack(sv),
                                      torch.stack(sl)), caches.cross_kv)


def whisper_init_caches(cfg: ModelConfig, batch: int, max_len: int,
                        dtype=torch.bfloat16, device=None) -> WhisperCaches:
    """Zero caches (``device=None`` is CUDA): self-attention ``max_len``
    long, cross attention ``enc_ctx`` long."""
    device = dispatch.resolve_device(device)
    nl = cfg.n_layers

    def mk(n):
        shape = (nl, batch, n, cfg.n_kv_heads, cfg.head_dim)
        return A.KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=torch.zeros((nl,), dtype=torch.int32, device=device))

    return WhisperCaches(self_kv=mk(max_len), cross_kv=mk(cfg.enc_ctx))


def fill_cross_cache(params, enc_out: torch.Tensor, caches: WhisperCaches,
                     cfg: ModelConfig) -> WhisperCaches:
    """Project the encoder output into every decoder layer's cross KV
    cache (in the encoder output's dtype, stored in the cache's)."""
    dec = params["dec"]
    k = torch.stack([T._proj(enc_out, w) for w in dec["xa_wk"]])
    v = torch.stack([T._proj(enc_out, w) for w in dec["xa_wv"]])
    length = torch.full((cfg.n_layers,), enc_out.shape[1],
                        dtype=torch.int32, device=enc_out.device)
    return WhisperCaches(
        self_kv=caches.self_kv,
        cross_kv=A.KVCache(k.to(caches.cross_kv.k.dtype),
                           v.to(caches.cross_kv.v.dtype), length))
