"""The parts of ``src/repro/models/transformer.py`` that the ported family
reads: token embedding, the (tied) LM head and the bf16 cast of a block's
parameters.  The reference's ``Runtime`` (mesh sharding hooks) has no
counterpart on one card; it returns with the distributed slice (ROADMAP
queue 1, item 12)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def cast_params(p: dict, dtype=torch.bfloat16) -> dict:
    """Cast a block's f32 parameters to the compute dtype (every f32 leaf,
    norm weights and SSM rates included, as the reference does)."""
    return {k: v.to(dtype) if v.dtype == torch.float32 else v
            for k, v in p.items()}


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig):
    """Embedding rows in bf16 (the embedding and logit scales of other
    families come with them)."""
    return params["embed"].to(torch.bfloat16)[tokens]


def logits_fn(params, hidden: torch.Tensor, cfg: ModelConfig):
    """LM head in the hidden dtype, then f32 (and the softcap, if any)."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = hidden @ w.to(hidden.dtype)
    return L.softcap(logits.float(), cfg.logit_softcap)
