"""The Mamba-2 half of ``src/repro/models/hybrid.py``: parameter specs, the
forward pass with and without caches, and the decode caches.  The
RecurrentGemma half comes with the other families (ROADMAP queue 1, item
12).

Parameters keep the reference's layout: block parameters are stacked
along a leading layer axis, and layer ``l`` is their ``[l]`` views.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.modules import ParamSpec


def mamba2_param_specs(cfg: ModelConfig) -> dict:
    n = cfg.n_layers
    d = cfg.d_model
    d_inner, H, conv_dim = S.dims(cfg)
    g, ns = cfg.ssm.n_groups, cfg.ssm.d_state
    in_dim = 2 * d_inner + 2 * g * ns + H
    specs = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), init="embed"),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "blocks": {
            "in_proj": ParamSpec((n, d, in_dim), ("layers", "embed", "mlp")),
            "conv_w": ParamSpec((n, cfg.ssm.d_conv, conv_dim),
                                ("layers", None, "mlp"), init="small"),
            "conv_b": ParamSpec((n, conv_dim), ("layers", "mlp"), init="zeros"),
            "dt_bias": ParamSpec((n, H), ("layers", "heads"), init="zeros"),
            "A_log": ParamSpec((n, H), ("layers", "heads"), init="zeros"),
            "D": ParamSpec((n, H), ("layers", "heads"), init="ones"),
            "norm_w": ParamSpec((n, d_inner), ("layers", "mlp"), init="ones"),
            "out_proj": ParamSpec((n, d_inner, d), ("layers", "mlp", "embed")),
            "ln": ParamSpec((n, d), ("layers", "embed"), init="ones"),
        },
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"))
    return specs


def mamba2_forward(params, tokens: torch.Tensor, cfg: ModelConfig,
                   caches: S.SSMCache | None = None):
    """Returns (hidden, aux (= 0), new_caches).  ``caches``: an
    ``SSMCache`` of tensors stacked over layers; the new caches are new
    tensors (the old ones are left as they were)."""
    x = T.embed_tokens(params, tokens, cfg)
    blocks = params["blocks"]
    convs, states = [], []
    for layer in range(cfg.n_layers):
        p = T.cast_params({k: v[layer] for k, v in blocks.items()})
        h = L.rms_norm(x, p["ln"], cfg.rms_eps)
        cache = None if caches is None else \
            S.SSMCache(caches.conv[layer], caches.state[layer])
        o, c_new = S.mamba2_block(p, h, cfg, cache)
        x = x + o
        if c_new is not None:
            convs.append(c_new.conv)
            states.append(c_new.state)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    new = S.SSMCache(torch.stack(convs), torch.stack(states)) \
        if caches is not None else None
    return x, torch.zeros((), dtype=torch.float32, device=x.device), new


def mamba2_init_caches(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                       device=None) -> S.SSMCache:
    """Zero caches stacked over layers (``device=None`` is CUDA)."""
    device = dispatch.resolve_device(device)
    d_inner, H, conv_dim = S.dims(cfg)
    n = cfg.n_layers
    return S.SSMCache(
        conv=torch.zeros((n, batch, cfg.ssm.d_conv - 1, conv_dim),
                         dtype=dtype, device=device),
        state=torch.zeros((n, batch, H, cfg.ssm.head_dim, cfg.ssm.d_state),
                          dtype=torch.float32, device=device),
    )
