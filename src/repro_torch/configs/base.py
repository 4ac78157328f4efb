"""Model configuration dataclasses (port of ``src/repro/configs/base.py``).

Only the fields that the ported family (``ssm``, Mamba-2) reads are kept;
the other families' fields (attention heads, FFN width, embedding and
logit scales, ...) come with their slices (ROADMAP queue 1, item 12).
``reduced()`` shrinks a config to a CPU-testable size exactly as the
reference's does for the fields kept here.
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
    vocab: int
    logit_softcap: float = 0.0          # final-logit softcap (0 = off)
    tie_embeddings: bool = False
    ssm: SSMConfig | None = None
    rms_eps: float = 1e-6


def reduced(cfg: ModelConfig, *, layers: int = 2) -> ModelConfig:
    """Shrink a config for CPU tests, preserving the family's structure
    (the reference's ``reduced`` restricted to the fields kept here)."""
    kw: dict = dict(n_layers=layers, d_model=64, vocab=256)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=8, chunk=16)
    return dataclasses.replace(cfg, **kw)
