"""Gemma2-9B [arXiv:2408.00118; hf] -- alternating local/global attention,
logit softcaps, post-norms, unit-offset RMSNorm (port of
``src/repro/configs/gemma2_9b.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000,
    rope_theta=10000.0, attn_softcap=50.0, logit_softcap=30.0,
    query_scale=256.0 ** -0.5, sliding_window=4096, alt_local_global=True,
    post_norm=True, tie_embeddings=True, act="gelu_tanh", rms_eps=1e-6,
)
