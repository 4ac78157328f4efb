"""Qwen2-VL-7B [arXiv:2409.12191; hf] -- dense GQA backbone with M-RoPE
(temporal / height / width sections 16 / 24 / 24); vision patch embeddings
arrive as a precomputed stub (dynamic resolution not modelled) (port of
``src/repro/configs/qwen2_vl_7b.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab=152064,
    rope_theta=1_000_000.0, qkv_bias=True, mrope_sections=(16, 24, 24),
    vision_tokens=256, rms_eps=1e-6, act="silu",
)
