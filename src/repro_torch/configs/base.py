"""Model configuration dataclasses (port of ``src/repro/configs/base.py``).

The fields that the ported families read are kept: the Mamba-2 family
(``ssm``) and the dense transformers (attention heads, FFN width, RoPE,
the gemma2 softcaps, window and post-norms, the minicpm embedding, depth
and logit scales).  The MoE, recurrent, encoder-decoder and vision fields
come with their slices (ROADMAP queue 1, item 12).  ``reduced()`` shrinks
a config to a CPU-testable size exactly as the reference's does for the
fields kept here.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio", "snn"]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # attention variants
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    logit_softcap: float = 0.0          # gemma2 final-logit softcap
    attn_softcap: float = 0.0           # gemma2 attention softcap
    query_scale: float | None = None    # override 1/sqrt(head_dim)
    sliding_window: int = 0             # local attention window
    alt_local_global: bool = False      # gemma2: alternate local/global
    # residual/embedding scaling (minicpm muP-style scaling)
    scale_emb: float = 1.0
    scale_depth: float = 0.0            # residual scale = scale_depth/sqrt(L)
    logit_scale: float = 1.0
    tie_embeddings: bool = False
    ssm: SSMConfig | None = None
    # norms
    rms_eps: float = 1e-6
    post_norm: bool = False             # gemma2 post-attn/ffn extra norms
    act: str = "silu"                   # silu | gelu | gelu_tanh

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def reduced(cfg: ModelConfig, *, layers: int = 2) -> ModelConfig:
    """Shrink a config for CPU tests, preserving the family's structure
    (the reference's ``reduced`` restricted to the fields kept here)."""
    kw: dict = dict(
        n_layers=layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128,
        vocab=256,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window
        else 0,
    )
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=8, chunk=16)
    return dataclasses.replace(cfg, **kw)
