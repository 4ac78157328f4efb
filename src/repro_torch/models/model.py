"""Unified model interface: ``build(config) -> Model`` (port of
``src/repro/models/model.py``).

One object per architecture family exposing the same surface:

  specs()                              parameter ParamSpec tree
  init(generator, param_dtype, device) materialised params
  abstract(param_dtype)                the same tree on ``meta``
  hidden(params, batch, rt=None)       full-seq forward -> (hidden, aux)
  logits(params, hidden, rt=None)      LM head
  init_caches(batch, max_len, ...)     decode state
  prefill(params, batch, caches, rt)   fill caches, return the hidden
  decode(params, caches, tokens, rt)   one-token step -> (logits, caches)

``rt`` is the mesh context (``transformer.Runtime``; None is the
single-device default); ``rt.remat`` checkpoints each layer under
autograd (training).

``batch`` is a dict: ``tokens``, and per family the extras
``positions3`` and ``vision_embeds`` (vlm) or ``enc_frames`` (audio).
Every family of the reference is ported: ``dense``, ``moe`` and ``vlm``
(the transformer), ``ssm`` (Mamba-2), ``hybrid`` (RecurrentGemma) and
``audio`` (Whisper).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as E
from repro_torch.models import hybrid as H
from repro_torch.models import transformer as T
from repro_torch.models.modules import abstract_params, init_params


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    specs: Callable[[], dict]
    hidden: Callable
    init_caches: Callable
    decode: Callable
    prefill: Callable

    def init(self, generator: torch.Generator, param_dtype=None,
             device=None):
        return init_params(self.specs(), generator, param_dtype, device)

    def abstract(self, param_dtype=None):
        return abstract_params(self.specs(), param_dtype)

    def logits(self, params, hidden, rt=None):
        return T.logits_fn(params, hidden, self.cfg, rt)


def _build_mamba2(cfg: ModelConfig) -> Model:
    def hidden(params, batch, rt=None):
        h, aux, _ = H.mamba2_forward(params, batch["tokens"], cfg, rt=rt)
        return h, aux

    def init_caches(batch, max_len, dtype=torch.bfloat16, device=None):
        return H.mamba2_init_caches(cfg, batch, dtype, device)

    def prefill(params, batch, caches, rt=None):
        h, _, new = H.mamba2_forward(params, batch["tokens"], cfg, caches,
                                     rt)
        return h, new

    def decode(params, caches, tokens, rt=None):
        h, _, new = H.mamba2_forward(params, tokens, cfg, caches, rt)
        return T.logits_fn(params, h, cfg, rt), new

    return Model(cfg=cfg, specs=lambda: H.mamba2_param_specs(cfg),
                 hidden=hidden, init_caches=init_caches, decode=decode,
                 prefill=prefill)


def _build_transformer(cfg: ModelConfig) -> Model:
    """The dense, MoE and vision families (reference
    ``_build_transformer`` with its ``prefill_with_cache``)."""
    def hidden(params, batch, rt=None):
        return T.forward(params, batch["tokens"], cfg,
                         positions3=batch.get("positions3"),
                         vision_embeds=batch.get("vision_embeds"), rt=rt)

    def init_caches(batch, max_len, dtype=torch.bfloat16, device=None):
        return T.init_caches(cfg, batch, max_len, dtype, device)

    def prefill_with_cache(params, batch, caches, rt=None):
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        x = T.embed_tokens(params, tokens, cfg, batch.get("vision_embeds"),
                           rt)
        return T.cached_layers(params, x, caches, cfg, positions,
                               batch.get("positions3"), rt)

    def decode(params, caches, tokens, rt=None, positions3=None):
        return T.decode_step(params, caches, tokens, cfg, positions3, rt)

    return Model(cfg=cfg, specs=lambda: T.param_specs(cfg), hidden=hidden,
                 init_caches=init_caches, decode=decode,
                 prefill=prefill_with_cache)


def _build_recurrentgemma(cfg: ModelConfig) -> Model:
    def hidden(params, batch, rt=None):
        h, aux, _ = H.rg_forward(params, batch["tokens"], cfg, rt=rt)
        return h, aux

    def init_caches(batch, max_len, dtype=torch.bfloat16, device=None):
        return H.rg_init_caches(cfg, batch, dtype, device)

    def prefill(params, batch, caches, rt=None):
        h, _, new = H.rg_forward(params, batch["tokens"], cfg, caches, rt)
        return h, new

    def decode(params, caches, tokens, rt=None):
        h, _, new = H.rg_forward(params, tokens, cfg, caches, rt)
        return T.logits_fn(params, h, cfg, rt), new

    return Model(cfg=cfg, specs=lambda: H.rg_param_specs(cfg), hidden=hidden,
                 init_caches=init_caches, decode=decode, prefill=prefill)


def _build_whisper(cfg: ModelConfig) -> Model:
    def hidden(params, batch, rt=None):
        enc = E.encode(params, batch["enc_frames"], cfg, rt)
        h, _ = E.decode(params, batch["tokens"], enc, cfg, rt=rt)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)

    def init_caches(batch, max_len, dtype=torch.bfloat16, device=None):
        return E.whisper_init_caches(cfg, batch, max_len, dtype, device)

    def prefill(params, batch, caches, rt=None):
        enc = E.encode(params, batch["enc_frames"], cfg, rt)
        caches = E.fill_cross_cache(params, enc, caches, cfg)
        return E.decode(params, batch["tokens"], None, cfg, caches, rt)

    def decode(params, caches, tokens, rt=None):
        h, new = E.decode(params, tokens, None, cfg, caches, rt)
        return T.logits_fn(params, h, cfg, rt), new

    return Model(cfg=cfg, specs=lambda: E.whisper_param_specs(cfg),
                 hidden=hidden, init_caches=init_caches, decode=decode,
                 prefill=prefill)


def build(cfg: ModelConfig) -> Model:
    if cfg.family == "ssm":
        return _build_mamba2(cfg)
    if cfg.family == "hybrid":
        return _build_recurrentgemma(cfg)
    if cfg.family == "audio":
        return _build_whisper(cfg)
    return _build_transformer(cfg)     # dense | moe | vlm
