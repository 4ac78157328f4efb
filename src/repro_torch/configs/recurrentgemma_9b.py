"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427; unverified] -- RG-LRU
recurrent blocks + local attention, 2:1 pattern, window 2048, MQA (port of
``src/repro/configs/recurrentgemma_9b.py``).  Sub-quadratic: runs the
long_500k cell."""
from repro_torch.configs.base import ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000,
    rope_theta=10000.0, sliding_window=2048, tie_embeddings=True,
    rms_eps=1e-6, act="gelu_tanh",
    recurrent=RecurrentConfig(lru_width=4096, conv_width=4,
                              block_pattern=("rglru", "rglru", "attn")),
    subquadratic=True,
)
