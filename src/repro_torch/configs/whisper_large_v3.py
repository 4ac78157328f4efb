"""Whisper large-v3 [arXiv:2212.04356; unverified] -- encoder-decoder,
32 + 32 layers, d_model 1280, MHA, GELU; the conv frontend is a stub
(precomputed frame embeddings, enc_ctx = 1500 frames) (port of
``src/repro/configs/whisper_large_v3.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab=51866,
    enc_layers=32, enc_ctx=1500, act="gelu", tie_embeddings=True,
)
