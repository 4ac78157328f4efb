"""Decoder-only transformer for the dense, MoE and vision families (port
of ``src/repro/models/transformer.py``): parameter specs, the attention,
FFN and MoE blocks, the full-sequence forward, the LM head, and decoding
against stacked KV caches.  The other families read ``embed_tokens``,
``logits_fn``, ``cast_params`` and the blocks from here too.

Block parameters are stacked along a leading layer axis, as in the
reference; the forward takes each layer's views from one ``unbind`` per
stack (``layers.unstack``) and applies them in a Python loop (the
reference's ``lax.scan``), optionally checkpointed per layer.  deepseek's leading dense layers are a
stack of their own (``dense_blocks``, caches ``"dense"``) before the MoE
stack (``blocks``).  Qwen2-VL's M-RoPE positions (``positions3``) and
vision embeddings (``vision_embeds``) are threaded through the forward,
prefill and decode.

A :class:`Runtime` carries the mesh context, as in the reference: the
sharding-constraint hook (``wsc``, which changes no value on one card),
the MoE dispatch, the per-layer recompute (``remat``), the attention and
loss chunks, and the sequence axes.  Its mesh is a virtual
``launch.mesh.Mesh``; each mesh axis a path reads becomes a leading
tensor dimension.  With a mesh and a ``seq_axis`` the stateless attention
takes the group-GQA route (the reference's context-parallel branch); a
``split_kv_axis`` decodes linear caches split on their sequence
(``distributed.collectives.split_kv_decode_attention``); ``moe_impl=
"bucket"`` with a mesh runs the sharded bucket dispatch
(:func:`_moe_bucket_sharded`).  The default ``Runtime()`` is the
single-device path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.kernels import dispatch
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.modules import ParamSpec


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Mesh-dependent hooks; the default is the single-device path."""

    mesh: Any = None                    # launch.mesh.Mesh (virtual)
    batch_axes: tuple = ("data",)       # mesh axes the batch is split over
    model_axis: str = "model"
    moe_impl: str = "local"             # local | bucket
    remat: bool = False                 # per-layer recompute under autograd;
                                        # the train step sets it from
                                        # TrainConfig.remat
    attn_chunk: int = 1024              # KV chunk of prefill attention
    logits_chunk: int = 512             # sequence chunk of the loss
    seq_axis: Any = None                # sequence parallelism: the residual
                                        # stream split over this mesh axis
    split_kv_axis: Any = None           # decode: KV caches split on their
                                        # sequence over this axis
    grad_specs: Any = None              # parameter shardings the gradients
                                        # are constrained to

    def wsc(self, t, spec):
        """The reference's ``with_sharding_constraint``: on one card a
        layout changes no value, so ``t`` is returned as it is."""
        return t

    def aspec(self) -> tuple:
        """Residual-activation partition spec (B, S, d)."""
        return (self.batch_axes, self.seq_axis, None)


DEFAULT = Runtime()


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


def _moe_specs(cfg: ModelConfig, n: int) -> dict:
    m = cfg.moe
    d, f = cfg.d_model, m.expert_ff
    s = {
        "router": ParamSpec((n, d, m.n_experts), ("layers", "embed", None),
                            init="small"),
        "w_gate": ParamSpec((n, m.n_experts, d, f),
                            ("layers", "expert", "embed", "mlp")),
        "w_up": ParamSpec((n, m.n_experts, d, f),
                          ("layers", "expert", "embed", "mlp")),
        "w_down": ParamSpec((n, m.n_experts, f, d),
                            ("layers", "expert", "mlp", "embed")),
    }
    if m.n_shared:
        s.update(_mlp_specs(cfg, n, m.n_shared * f, prefix="sh_"))
    if m.parallel_dense_ff:
        s.update(_mlp_specs(cfg, n, m.parallel_dense_ff, prefix="pd_"))
    return s


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
    """The parameter tree: the embedding, the final norm, the LM head
    unless tied, and the stacked blocks (for MoE: ``first_dense`` dense
    ``dense_blocks``, then the MoE ``blocks``)."""
    nl = cfg.n_layers
    specs: dict = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           init="embed"),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",),
                                init="zeros" if cfg.post_norm else "ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab),
                                     ("embed", "vocab"))
    if cfg.moe:
        n_dense = cfg.moe.first_dense
        n_moe = nl - n_dense
        specs["blocks"] = {**_attn_specs(cfg, n_moe), **_moe_specs(cfg, n_moe),
                           **_norm_specs(cfg, n_moe)}
        if n_dense:
            specs["dense_blocks"] = {
                **_attn_specs(cfg, n_dense),
                **_mlp_specs(cfg, n_dense, cfg.moe.dense_ff or cfg.d_ff),
                **_norm_specs(cfg, n_dense)}
    else:
        specs["blocks"] = {**_attn_specs(cfg, nl),
                           **_mlp_specs(cfg, nl, cfg.d_ff),
                           **_norm_specs(cfg, nl)}
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


def _proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (d, H, Dh) -> (B, S, H, Dh) in h's dtype."""
    B, S, d = h.shape
    return (h @ w.to(h.dtype).reshape(d, -1)).view(B, S, *w.shape[1:])


def _out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, H, Dh) @ (H, Dh, d) -> (B, S, d) in o's dtype."""
    B, S, H, Dh = o.shape
    return o.reshape(B, S, H * Dh) @ w.to(o.dtype).reshape(H * Dh, -1)


def _project_qkv(p, h, cfg: ModelConfig):
    q, k, v = _proj(h, p["wq"]), _proj(h, p["wk"]), _proj(h, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(h.dtype)
        k = k + p["bk"].to(h.dtype)
        v = v + p["bv"].to(h.dtype)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.rms_eps)
    return q, k, v


def _rope(cfg: ModelConfig, x, positions, positions3=None):
    if cfg.mrope_sections and positions3 is not None:
        return L.apply_mrope(x, positions3, cfg.mrope_sections,
                             cfg.rope_theta)
    return L.apply_rope(x, positions, cfg.rope_theta)


def attn_block(p, x, cfg: ModelConfig, rt: Runtime | None = None, *,
               window: int, positions, positions3=None,
               cache: A.KVCache | None = None, ring: bool = False):
    """Pre/post-norm attention residual.  Returns (x, new_cache).

    With a mesh and a ``seq_axis`` and no cache (the reference's
    context-parallel training): queries stay split on the sequence, K/V
    replicate, and the attention takes the group-GQA route.  Decode of a
    linear cache with a ``split_kv_axis`` runs split-KV."""
    rt = rt or DEFAULT
    p = cast_params(p)
    norm = _norm(cfg)
    h = norm(x, p["ln1"])
    q, k, v = _project_qkv(p, h, cfg)
    q = _rope(cfg, q, positions, positions3)
    k = _rope(cfg, k, positions, positions3)
    # context-parallel (the reference constrains q to stay split on the
    # sequence and K/V to replicate; on one card no layout changes)
    cp = rt.mesh is not None and rt.seq_axis is not None and cache is None
    scale = cfg.query_scale if cfg.query_scale else None
    if cache is not None:
        cache = A.cache_update(cache, k, v, ring=ring)
        if x.shape[1] == 1:
            if rt.split_kv_axis is not None and not ring:
                o = _split_kv_decode(q, cache, rt, scale, window,
                                     cfg.attn_softcap)
            else:
                o = A.decode_attention(q, cache, window=window,
                                       softcap=cfg.attn_softcap, scale=scale,
                                       ring=ring)
        else:
            o = A.flash_attention(q, cache.k, cache.v, causal=True,
                                  window=window, softcap=cfg.attn_softcap,
                                  scale=scale, kv_len=cache.length,
                                  chunk=rt.attn_chunk)
    else:
        o = A.flash_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_softcap, scale=scale,
                              chunk=rt.attn_chunk,
                              gqa="group" if cp else "expand")
    o = _out(o, p["wo"])
    if cfg.post_norm:
        o = norm(o, p["ln1b"])
    return x + _scaled(o, cfg), cache


def _divides(n: int, parts: int, what: str) -> None:
    """Raise where the reference's shard_map would: ``n`` not split
    evenly into ``parts``."""
    if n % parts:
        raise ValueError(f"{what} {n} does not divide into {parts} shards")


def _split_kv_decode(q, cache: A.KVCache, rt: Runtime, scale, window,
                     softcap):
    """Flash-decoding over the cache split on its sequence over
    ``rt.split_kv_axis``: shard ``i`` holds slots ``i * T_loc ...``."""
    if rt.mesh is None:
        raise ValueError("split-KV decode needs a mesh")
    n = rt.mesh.axis_size(rt.split_kv_axis)
    B, T = cache.k.shape[:2]
    _divides(B, rt.mesh.axis_size(rt.batch_axes), "batch")
    _divides(T, n, "cache length")
    k, v = (t.unflatten(1, (n, T // n)).movedim(1, 0)
            for t in (cache.k, cache.v))
    return C.split_kv_decode_attention(
        q, k, v, cache.length, scale=scale if scale else None,
        softcap=softcap, window=window)


def ffn_block(p, x, cfg: ModelConfig, rt: Runtime | None = None):
    p = cast_params(p)
    norm = _norm(cfg)
    h = norm(x, p["ln2"])
    o = L.glu_mlp(h, p["wg"].to(h.dtype), p["wu"].to(h.dtype),
                  p["wd"].to(h.dtype), cfg.act)
    if cfg.post_norm:
        o = norm(o, p["ln2b"])
    return x + _scaled(o, cfg)


def moe_block(p, x, cfg: ModelConfig, rt: Runtime | None = None):
    """MoE residual (+ the shared experts / the parallel dense MLP).
    Returns (x, MoEStats).  ``moe_impl="bucket"`` with a mesh: the
    sharded bucket dispatch; else ``moe_layer_local``."""
    rt = rt or DEFAULT
    p = cast_params(p)
    h = _norm(cfg)(x, p["ln2"])
    B, S, d = h.shape
    flat = h.reshape(-1, d)
    mp = {k: p[k] for k in ("router", "w_gate", "w_up", "w_down")}
    if rt.moe_impl == "bucket" and rt.mesh is not None:
        o, stats = _moe_bucket_sharded(flat, mp, cfg, rt, B, S)
    else:
        o, stats = M.moe_layer_local(flat, mp, cfg.moe, act=cfg.act)
    o = o.view(B, S, d)
    for prefix, on in (("sh_", cfg.moe.n_shared),
                       ("pd_", cfg.moe.parallel_dense_ff)):
        if on:
            o = o + L.glu_mlp(h, p[prefix + "wg"].to(h.dtype),
                              p[prefix + "wu"].to(h.dtype),
                              p[prefix + "wd"].to(h.dtype), cfg.act)
    return x + _scaled(o, cfg), stats


def _moe_bucket_sharded(flat, mp, cfg: ModelConfig, rt: Runtime, B: int,
                        S: int):
    """The expert-parallel bucket dispatch over the mesh (the reference's
    ``shard_map`` of ``moe_layer_bucket``).

    Tokens enter laid out as ``(batch_axes, seq_axis, None)``: split over
    the data ranks by batch and, with ``seq_axis`` the model axis, over
    the EP (model) ranks by sequence, so each EP rank buckets only its
    slice.  With ``seq_axis=None`` every EP rank holds all of its data
    slice's tokens (the reference's replication: each rank routes them
    all, and the capacity counts all of them).  Each data rank runs
    ``moe_layer_bucket`` with its EP ranks as a leading dimension; the
    stats are averaged over the EP ranks (``pmean``), and, as the
    reference's ``out_specs=P()`` returns one data rank's, those of data
    rank 0 are returned."""
    d = flat.shape[-1]
    nd = rt.mesh.axis_size(rt.batch_axes)
    ep = rt.mesh.axis_size(rt.model_axis)
    if rt.seq_axis not in (None, rt.model_axis):
        raise ValueError(f"seq_axis {rt.seq_axis!r}: the sharded dispatch "
                         f"splits the sequence over the model axis or not "
                         f"at all")
    split = rt.seq_axis is not None
    _divides(B, nd, "batch")
    if split:
        _divides(S, ep, "sequence")
    E = cfg.moe.n_experts
    _divides(E, ep, "experts")
    w = {k: (_regather_t if k == "w_down" else _regather)(
        mp[k].view(ep, E // ep, *mp[k].shape[1:]), rt)
        for k in ("w_gate", "w_up", "w_down")}
    ys, stats = [], None
    for xl in flat.view(nd, B // nd, S, d):          # one data rank's tokens
        if split:       # EP rank j: its (B_loc, S / ep) slice, (b, s) order
            t = xl.view(B // nd, ep, S // ep, d).transpose(0, 1) \
                .reshape(ep, -1, d)
        else:
            t = xl.reshape(1, -1, d).expand(ep, -1, d)
        y, st = M.moe_layer_bucket(t, {"router": mp["router"], **w},
                                   cfg.moe, act=cfg.act)
        if split:
            y = y.view(ep, B // nd, S // ep, d).transpose(0, 1)
        else:
            y = y[0]
        ys.append(y.reshape(B // nd, S, d))
        if stats is None:
            stats = M.MoEStats(*(v.sum(dim=0) / ep for v in st))
    return torch.cat(ys).view(-1, d), stats


def _regather(w, rt: Runtime):
    """Hook for expert weights whose mlp dim is split over the batch axes
    (FSDP); the dispatch's weights arrive whole, so it returns ``w``."""
    return w


def _regather_t(w, rt: Runtime):
    return w


def _ffn(p, x, cfg: ModelConfig, rt: Runtime):
    """The block's second residual: MoE where the block has a router,
    else the FFN.  Returns (x, the MoE's aux loss or None)."""
    if "router" in p:
        x, stats = moe_block(p, x, cfg, rt)
        return x, stats.aux_loss
    return ffn_block(p, x, cfg, rt), None


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


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig,
                 vision_embeds: torch.Tensor | None = None,
                 rt: Runtime | None = None):
    """Embedding rows in bf16, times ``scale_emb`` (minicpm) or, for gemma
    (post-norms), ``sqrt(d_model)`` rounded to bf16 first.  A vision
    family's ``vision_embeds`` overwrite the leading block of the result
    that their shape covers (the reference's ``dynamic_update_slice`` at
    the origin)."""
    x = params["embed"].to(torch.bfloat16)[tokens]
    if cfg.scale_emb != 1.0:
        x = x * cfg.scale_emb
    elif cfg.post_norm:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if vision_embeds is not None and cfg.vision_tokens:
        b, n, d = vision_embeds.shape
        x[:b, :n, :d] = vision_embeds.to(x.dtype)
    rt = rt or DEFAULT
    return rt.wsc(x, rt.aspec())


def _layer(blocks: dict, layer: int) -> dict:
    return {k: v[layer] for k, v in blocks.items()}


def _stacks(cfg: ModelConfig):
    """(parameter stack, cache name, per-layer windows) of each layer
    stack, in order: deepseek's leading dense layers, then the rest."""
    windows = _layer_windows(cfg)
    nd = cfg.moe.first_dense if cfg.moe else 0
    if nd:
        return (("dense_blocks", "dense", windows[:nd]),
                ("blocks", "blocks", windows[nd:]))
    return (("blocks", "blocks", windows),)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            positions3=None, vision_embeds=None, rt: Runtime | None = None):
    """Full-sequence forward -> (final hidden states (B, S, d) bf16, the
    MoE layers' summed aux loss (0 without MoE)).  ``rt.remat``: under
    autograd each layer is recomputed in the backward; values are
    unchanged."""
    rt = rt or DEFAULT
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = embed_tokens(params, tokens, cfg, vision_embeds, rt)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(x, aux, p, win):
        x, _ = attn_block(p, x, cfg, rt, window=win, positions=positions,
                          positions3=positions3)
        x, layer_aux = _ffn(p, x, cfg, rt)
        x = rt.wsc(x, rt.aspec())
        return x, aux if layer_aux is None else aux + layer_aux

    for stack, _, windows in _stacks(cfg):
        for p, win in zip(L.unstack(params[stack]), windows):
            x, aux = L.checkpointed(layer, x, aux, p, int(win), on=rt.remat)
    x = _norm(cfg)(x, params["final_norm"])
    return x, aux


def logits_fn(params, hidden: torch.Tensor, cfg: ModelConfig,
              rt: Runtime | None = None):
    """LM head in the hidden dtype, times ``logit_scale`` there, then f32
    and the final softcap."""
    rt = rt or DEFAULT
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = hidden @ w.to(hidden.dtype)
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    logits = L.softcap(logits.float(), cfg.logit_softcap)
    return rt.wsc(logits, (rt.batch_axes, None, rt.model_axis))


def ring_caches(cfg: ModelConfig) -> bool:
    """Ring-buffer caches iff every layer is windowed."""
    return bool(_layer_windows(cfg).min() > 0)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> dict:
    """Stacked per-layer KV caches (``device=None`` is CUDA), one entry per
    layer stack (``"dense"`` and ``"blocks"`` for deepseek): every layer
    ``max_len`` long, or the window long when every layer is windowed."""
    device = dispatch.resolve_device(device)
    windows = _layer_windows(cfg)
    T = int(windows.max()) if ring_caches(cfg) else max_len

    def mk(n):
        shape = (n, batch, T, cfg.n_kv_heads, cfg.head_dim)
        return A.KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=torch.zeros((n,), dtype=torch.int32, device=device))

    return {name: mk(len(w)) for _, name, w in _stacks(cfg)}


def cached_layers(params, x: torch.Tensor, caches: dict, cfg: ModelConfig,
                  positions: torch.Tensor, positions3=None,
                  rt: Runtime | None = None):
    """Every block on ``x`` against its cache (prefill for S > 1 tokens,
    decode for one), then the final norm.  Returns (hidden, new caches);
    the old caches are left as they were."""
    rt = rt or DEFAULT
    ring = ring_caches(cfg)
    new = dict(caches)
    for stack, name, windows in _stacks(cfg):
        c = caches[name]
        ks, vs, lens = [], [], []
        for layer, win in enumerate(windows):
            p = _layer(params[stack], layer)
            cache = A.KVCache(c.k[layer], c.v[layer], c.length[layer])
            x, cache = attn_block(p, x, cfg, rt, window=int(win),
                                  positions=positions, positions3=positions3,
                                  cache=cache, ring=ring)
            x, _ = _ffn(p, x, cfg, rt)
            ks.append(cache.k)
            vs.append(cache.v)
            lens.append(cache.length)
        new[name] = A.KVCache(torch.stack(ks), torch.stack(vs),
                              torch.stack(lens))
    return _norm(cfg)(x, params["final_norm"]), new


def decode_step(params, caches: dict, tokens: torch.Tensor,
                cfg: ModelConfig, positions3=None, rt: Runtime | None = None):
    """One token for every sequence.  tokens: (B, 1).  Positions are the
    ``"blocks"`` caches' length (the engine's left padding counts from
    0); M-RoPE applies only where ``positions3`` is given.  Returns
    (logits, new caches)."""
    positions = caches["blocks"].length[0].expand(tokens.shape[0], 1)
    x = embed_tokens(params, tokens, cfg, rt=rt)
    x, new = cached_layers(params, x, caches, cfg, positions, positions3, rt)
    return logits_fn(params, x, cfg, rt), new
