"""Qwen3-32B [hf:Qwen/Qwen3-32B family; hf] -- dense GQA with qk-norm
(port of ``src/repro/configs/qwen3_32b.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab=151936,
    rope_theta=1_000_000.0, qk_norm=True, rms_eps=1e-6, act="silu",
)
