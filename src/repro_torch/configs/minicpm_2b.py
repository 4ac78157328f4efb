"""MiniCPM-2B [arXiv:2404.06395; hf] -- llama-like with muP-style scaling
(scale_emb=12, scale_depth=1.4, logit scale d_model/256) (port of
``src/repro/configs/minicpm_2b.py``; its WSD schedule belongs to
training)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, head_dim=64,
    d_ff=5760, vocab=122753,
    rope_theta=10000.0, scale_emb=12.0, scale_depth=1.4,
    logit_scale=1.0 / (2304 / 256), tie_embeddings=True,
    rms_eps=1e-5, act="silu",
)
