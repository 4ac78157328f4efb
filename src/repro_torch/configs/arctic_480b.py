"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base; hf] --
dense-MoE hybrid: a dense residual MLP in parallel with a 128-expert top-2
MoE per layer (port of ``src/repro/configs/arctic_480b.py``).  Bucket
dispatch applies (128 destinations)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab=32000,
    rope_theta=10000.0, rms_eps=1e-5, act="silu",
    moe=MoEConfig(n_experts=128, top_k=2, expert_ff=4864,
                  parallel_dense_ff=4864, capacity_factor=1.25),
    uses_bucket_dispatch=True,
)
