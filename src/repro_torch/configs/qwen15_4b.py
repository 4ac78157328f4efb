"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B family; hf] -- dense MHA with QKV bias
(port of ``src/repro/configs/qwen15_4b.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab=151936,
    rope_theta=5_000_000.0, qkv_bias=True, rms_eps=1e-6, act="silu",
)
