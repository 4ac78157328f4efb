"""Model configuration dataclasses (port of ``src/repro/configs/base.py``).

Every field of the reference is kept: the dense transformers (attention
heads, FFN width, RoPE, the gemma2 softcaps, window and post-norms, the
minicpm embedding, depth and logit scales), the MoE routing (``moe``), the
Mamba-2 SSM (``ssm``), RecurrentGemma's RG-LRU (``recurrent``), Whisper's
encoder (``enc_layers``, ``enc_ctx``) and Qwen2-VL's M-RoPE and vision
stub (``mrope_sections``, ``vision_tokens``).  ``reduced()`` shrinks a
config to a CPU-testable size exactly as the reference's does.
``SHAPES`` are the reference's four input shapes of the dry run.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

Family = Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio", "snn"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0              # shared (always-on) experts
    expert_ff: int = 0             # per-expert hidden dim
    first_dense: int = 0           # leading dense layers (deepseek-moe)
    dense_ff: int = 0              # hidden of those dense layers
    parallel_dense_ff: int = 0     # arctic: dense MLP residual in parallel
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    lru_width: int = 0             # RG-LRU width (0 -> d_model)
    conv_width: int = 4
    block_pattern: Sequence[str] = ()   # e.g. ("rglru","rglru","attn")


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
    mrope_sections: Sequence[int] = ()  # qwen2-vl M-RoPE (t, h, w)
    # residual/embedding scaling (minicpm muP-style scaling)
    scale_emb: float = 1.0
    scale_depth: float = 0.0            # residual scale = scale_depth/sqrt(L)
    logit_scale: float = 1.0
    tie_embeddings: bool = False
    # substructures
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    recurrent: RecurrentConfig | None = None
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_ctx: int = 0                    # encoder frames (conv-stub output)
    # vlm
    vision_tokens: int = 0              # patch-embedding stub length
    # norms
    rms_eps: float = 1e-6
    post_norm: bool = False             # gemma2 post-attn/ffn extra norms
    act: str = "silu"                   # silu | gelu | gelu_tanh
    # applicability of the paper's technique (bucketed sparse dispatch)
    uses_bucket_dispatch: bool = False
    # long-context admissibility (sub-quadratic path exists)
    subquadratic: bool = False

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, *, layers: int = 2) -> ModelConfig:
    """Shrink a config for CPU tests, preserving the family's structure
    (the reference's ``reduced``, field for field)."""
    if cfg.recurrent:
        layers = max(layers, 4)       # >= one (r, r, attn) super-block + tail
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
        enc_layers=min(cfg.enc_layers, layers),
        enc_ctx=min(cfg.enc_ctx, 24) if cfg.enc_ctx else 0,
        vision_tokens=min(cfg.vision_tokens, 8) if cfg.vision_tokens else 0,
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            expert_ff=32,
            dense_ff=64 if cfg.moe.dense_ff else 0,
            parallel_dense_ff=64 if cfg.moe.parallel_dense_ff else 0,
            first_dense=min(cfg.moe.first_dense, 1),
        )
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=8, chunk=16)
    if cfg.recurrent:
        pat = tuple(cfg.recurrent.block_pattern) or ("rglru", "rglru", "attn")
        kw["recurrent"] = dataclasses.replace(
            cfg.recurrent, lru_width=64, block_pattern=pat)
    out = dataclasses.replace(cfg, **kw)
    if out.mrope_sections:
        # sections must sum to head_dim // 2
        h = out.head_dim // 2
        a = h // 3
        out = dataclasses.replace(out, mrope_sections=(h - 2 * a, a, a))
    return out
