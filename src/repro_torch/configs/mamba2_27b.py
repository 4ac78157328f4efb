"""Mamba2-2.7B [arXiv:2405.21060; unverified] -- attention-free SSD
(port of ``src/repro/configs/mamba2_27b.py``).
d_inner = 2*d_model = 5120, 80 heads x 64, d_state 128.
Sub-quadratic: runs the long_500k cell."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=80, n_kv_heads=0, head_dim=64,
    d_ff=0, vocab=50280,
    rms_eps=1e-5, act="silu", tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256),
    subquadratic=True,
)
