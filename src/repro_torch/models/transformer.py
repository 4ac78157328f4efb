"""Decoder-only transformer, the dense family (port of the dense parts of
``src/repro/models/transformer.py``): parameter specs, the attention and
FFN blocks, the full-sequence forward, the LM head, and decoding against
stacked KV caches.  The Mamba-2 family reads ``embed_tokens``,
``logits_fn`` and ``cast_params`` from here too.

Block parameters are stacked along a leading layer axis, as in the
reference; layer ``l`` is their ``[l]`` views, applied in a Python loop
(the reference's ``lax.scan``).  The reference's ``Runtime`` (mesh
sharding hooks, the context-parallel attention branch, the MoE dispatch)
has no counterpart on one card; it returns with the distributed and MoE
slices (ROADMAP queue 1, item 12), as do M-RoPE and the vision embeds.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.modules import ParamSpec

ATTN_CHUNK = 1024          # KV chunk of prefill attention (Runtime.attn_chunk)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _attn_specs(cfg: ModelConfig, n: int) -> dict:
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s: dict = {
        "wq": ParamSpec((n, d, H, Dh), ("layers", "embed", "heads", "head_dim")),
        "wk": ParamSpec((n, d, Hkv, Dh), ("layers", "embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((n, d, Hkv, Dh), ("layers", "embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((n, H, Dh, d), ("layers", "heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((n, H, Dh), ("layers", "heads", "head_dim"), init="zeros")
        s["bk"] = ParamSpec((n, Hkv, Dh), ("layers", "kv_heads", "head_dim"), init="zeros")
        s["bv"] = ParamSpec((n, Hkv, Dh), ("layers", "kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((n, Dh), ("layers", "head_dim"), init="ones")
        s["k_norm"] = ParamSpec((n, Dh), ("layers", "head_dim"), init="ones")
    return s


def _mlp_specs(cfg: ModelConfig, n: int, ff: int, prefix: str = "") -> dict:
    d = cfg.d_model
    return {
        prefix + "wg": ParamSpec((n, d, ff), ("layers", "embed", "mlp")),
        prefix + "wu": ParamSpec((n, d, ff), ("layers", "embed", "mlp")),
        prefix + "wd": ParamSpec((n, ff, d), ("layers", "mlp", "embed")),
    }


def _norm_specs(cfg: ModelConfig, n: int) -> dict:
    d = cfg.d_model
    init = "zeros" if cfg.post_norm else "ones"   # gemma stores w-1
    s = {
        "ln1": ParamSpec((n, d), ("layers", "embed"), init=init),
        "ln2": ParamSpec((n, d), ("layers", "embed"), init=init),
    }
    if cfg.post_norm:
        s["ln1b"] = ParamSpec((n, d), ("layers", "embed"), init=init)
        s["ln2b"] = ParamSpec((n, d), ("layers", "embed"), init=init)
    return s


def param_specs(cfg: ModelConfig) -> dict:
    """The dense family's parameter tree (MoE comes with its slice)."""
    nl = cfg.n_layers
    specs: dict = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           init="embed"),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",),
                                init="zeros" if cfg.post_norm else "ones"),
        "blocks": {**_attn_specs(cfg, nl), **_mlp_specs(cfg, nl, cfg.d_ff),
                   **_norm_specs(cfg, nl)},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab),
                                     ("embed", "vocab"))
    return specs


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def cast_params(p: dict, dtype=torch.bfloat16) -> dict:
    """Cast a block's f32 parameters to the compute dtype (every f32 leaf,
    norm weights and SSM rates included, as the reference does)."""
    return {k: v.to(dtype) if v.dtype == torch.float32 else v
            for k, v in p.items()}


def _res_scale(cfg: ModelConfig) -> float:
    return float(cfg.scale_depth / np.sqrt(cfg.n_layers)) \
        if cfg.scale_depth else 1.0


def _scaled(o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """minicpm's residual scale, rounded to the output's dtype first."""
    s = _res_scale(cfg)
    return o if s == 1.0 else o * torch.tensor(s, dtype=o.dtype,
                                               device=o.device)


def _norm(cfg: ModelConfig):
    return lambda x, w: L.rms_norm(x, w, cfg.rms_eps,
                                   unit_offset=cfg.post_norm)


def _project_qkv(p, h, cfg: ModelConfig):
    B, S, d = h.shape
    proj = lambda w: (h @ w.to(h.dtype).reshape(d, -1)).view(
        B, S, w.shape[1], w.shape[2])
    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(h.dtype)
        k = k + p["bk"].to(h.dtype)
        v = v + p["bv"].to(h.dtype)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.rms_eps)
    return q, k, v


def _rope(cfg: ModelConfig, x, positions):
    return L.apply_rope(x, positions, cfg.rope_theta)


def attn_block(p, x, cfg: ModelConfig, *, window: int, positions,
               cache: A.KVCache | None = None, ring: bool = False):
    """Pre/post-norm attention residual.  Returns (x, new_cache)."""
    p = cast_params(p)
    norm = _norm(cfg)
    h = norm(x, p["ln1"])
    q, k, v = _project_qkv(p, h, cfg)
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    scale = cfg.query_scale if cfg.query_scale else None
    if cache is not None:
        cache = A.cache_update(cache, k, v, ring=ring)
        if x.shape[1] == 1:
            o = A.decode_attention(q, cache, window=window,
                                   softcap=cfg.attn_softcap, scale=scale,
                                   ring=ring)
        else:
            o = A.flash_attention(q, cache.k, cache.v, causal=True,
                                  window=window, softcap=cfg.attn_softcap,
                                  scale=scale, kv_len=cache.length,
                                  chunk=ATTN_CHUNK)
    else:
        o = A.flash_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_softcap, scale=scale,
                              chunk=ATTN_CHUNK)
    B, S, H, Dh = o.shape
    o = o.reshape(B, S, H * Dh) @ p["wo"].to(o.dtype).reshape(H * Dh, -1)
    if cfg.post_norm:
        o = norm(o, p["ln1b"])
    return x + _scaled(o, cfg), cache


def ffn_block(p, x, cfg: ModelConfig):
    p = cast_params(p)
    norm = _norm(cfg)
    h = norm(x, p["ln2"])
    o = L.glu_mlp(h, p["wg"].to(h.dtype), p["wu"].to(h.dtype),
                  p["wd"].to(h.dtype), cfg.act)
    if cfg.post_norm:
        o = norm(o, p["ln2b"])
    return x + _scaled(o, cfg)


# ---------------------------------------------------------------------------
# Model: forward / logits / decode
# ---------------------------------------------------------------------------

def _layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer sliding window (0 = global)."""
    if cfg.alt_local_global and cfg.sliding_window:
        w = np.zeros(cfg.n_layers, np.int32)
        w[0::2] = cfg.sliding_window          # even layers local (gemma2)
        return w
    if cfg.sliding_window:
        return np.full(cfg.n_layers, cfg.sliding_window, np.int32)
    return np.zeros(cfg.n_layers, np.int32)


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig):
    """Embedding rows in bf16, times ``scale_emb`` (minicpm) or, for gemma
    (post-norms), ``sqrt(d_model)`` rounded to bf16 first."""
    x = params["embed"].to(torch.bfloat16)[tokens]
    if cfg.scale_emb != 1.0:
        x = x * cfg.scale_emb
    elif cfg.post_norm:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _layer(blocks: dict, layer: int) -> dict:
    return {k: v[layer] for k, v in blocks.items()}


def forward(params, tokens: torch.Tensor, cfg: ModelConfig):
    """Full-sequence forward -> (final hidden states (B, S, d) bf16, aux
    loss 0)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = embed_tokens(params, tokens, cfg)
    for layer, win in enumerate(_layer_windows(cfg)):
        p = _layer(params["blocks"], layer)
        x, _ = attn_block(p, x, cfg, window=int(win), positions=positions)
        x = ffn_block(p, x, cfg)
    x = _norm(cfg)(x, params["final_norm"])
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(params, hidden: torch.Tensor, cfg: ModelConfig):
    """LM head in the hidden dtype, times ``logit_scale`` there, then f32
    and the final softcap."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = hidden @ w.to(hidden.dtype)
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    return L.softcap(logits.float(), cfg.logit_softcap)


def ring_caches(cfg: ModelConfig) -> bool:
    """Ring-buffer caches iff every layer is windowed."""
    return bool(_layer_windows(cfg).min() > 0)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> dict:
    """Stacked per-layer KV caches (``device=None`` is CUDA): every layer
    ``max_len`` long, or the window long when every layer is windowed."""
    device = dispatch.resolve_device(device)
    windows = _layer_windows(cfg)
    T = int(windows.max()) if ring_caches(cfg) else max_len
    shape = (cfg.n_layers, batch, T, cfg.n_kv_heads, cfg.head_dim)
    return {"blocks": A.KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((cfg.n_layers,), dtype=torch.int32,
                           device=device))}


def cached_layers(params, x: torch.Tensor, caches: dict, cfg: ModelConfig,
                  positions: torch.Tensor):
    """Every block on ``x`` against its cache (prefill for S > 1 tokens,
    decode for one), then the final norm.  Returns (hidden, new caches);
    the old caches are left as they were."""
    ring = ring_caches(cfg)
    c = caches["blocks"]
    ks, vs, lens = [], [], []
    for layer, win in enumerate(_layer_windows(cfg)):
        p = _layer(params["blocks"], layer)
        cache = A.KVCache(c.k[layer], c.v[layer], c.length[layer])
        x, cache = attn_block(p, x, cfg, window=int(win),
                              positions=positions, cache=cache, ring=ring)
        x = ffn_block(p, x, cfg)
        ks.append(cache.k)
        vs.append(cache.v)
        lens.append(cache.length)
    new = dict(caches)
    new["blocks"] = A.KVCache(torch.stack(ks), torch.stack(vs),
                              torch.stack(lens))
    return _norm(cfg)(x, params["final_norm"]), new


def decode_step(params, caches: dict, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One token for every sequence.  tokens: (B, 1).  Positions are the
    caches' length (the engine's left padding counts from 0).  Returns
    (logits, new caches)."""
    positions = caches["blocks"].length[0].expand(tokens.shape[0], 1)
    x = embed_tokens(params, tokens, cfg)
    x, new = cached_layers(params, x, caches, cfg, positions)
    return logits_fn(params, x, cfg), new
