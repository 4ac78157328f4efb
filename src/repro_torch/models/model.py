"""Unified model interface: ``build(config) -> Model`` (port of
``src/repro/models/model.py``).

One object per architecture family exposing the same surface:

  specs()                              parameter ParamSpec tree
  init(generator, param_dtype, device) materialised params
  hidden(params, batch)                full-seq forward -> (hidden, aux)
  logits(params, hidden)               LM head
  init_caches(batch, max_len, ...)     decode state
  prefill(params, batch, caches)       fill caches, return the hidden
  decode(params, caches, tokens)       one-token step -> (logits, caches)

``batch`` is a dict holding ``tokens``.  Ported: the ``ssm`` family
(Mamba-2) and the ``dense`` transformers; ``moe``, ``vlm``, ``hybrid``
(RecurrentGemma) and ``audio`` (Whisper) raise until ROADMAP queue 1,
item 12.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid as H
from repro_torch.models import transformer as T
from repro_torch.models.modules import init_params


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

    def logits(self, params, hidden):
        return T.logits_fn(params, hidden, self.cfg)


def _build_mamba2(cfg: ModelConfig) -> Model:
    def hidden(params, batch):
        h, aux, _ = H.mamba2_forward(params, batch["tokens"], cfg)
        return h, aux

    def init_caches(batch, max_len, dtype=torch.bfloat16, device=None):
        return H.mamba2_init_caches(cfg, batch, dtype, device)

    def prefill(params, batch, caches):
        h, _, new = H.mamba2_forward(params, batch["tokens"], cfg, caches)
        return h, new

    def decode(params, caches, tokens):
        h, _, new = H.mamba2_forward(params, tokens, cfg, caches)
        return T.logits_fn(params, h, cfg), new

    return Model(cfg=cfg, specs=lambda: H.mamba2_param_specs(cfg),
                 hidden=hidden, init_caches=init_caches, decode=decode,
                 prefill=prefill)


def _build_transformer(cfg: ModelConfig) -> Model:
    """The dense family (reference ``_build_transformer`` with its
    ``prefill_with_cache``)."""
    def hidden(params, batch):
        return T.forward(params, batch["tokens"], cfg)

    def init_caches(batch, max_len, dtype=torch.bfloat16, device=None):
        return T.init_caches(cfg, batch, max_len, dtype, device)

    def prefill_with_cache(params, batch, caches):
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        x = T.embed_tokens(params, tokens, cfg)
        return T.cached_layers(params, x, caches, cfg, positions)

    def decode(params, caches, tokens):
        return T.decode_step(params, caches, tokens, cfg)

    return Model(cfg=cfg, specs=lambda: T.param_specs(cfg), hidden=hidden,
                 init_caches=init_caches, decode=decode,
                 prefill=prefill_with_cache)


def build(cfg: ModelConfig) -> Model:
    if cfg.family == "ssm":
        return _build_mamba2(cfg)
    if cfg.family == "dense":
        return _build_transformer(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
        f"item 12); ported: 'ssm', 'dense'")
