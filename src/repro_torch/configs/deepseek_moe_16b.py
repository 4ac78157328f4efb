"""DeepSeekMoE-16B [arXiv:2401.06066; hf] -- fine-grained MoE: 64 routed
experts top-6 + 2 shared experts, first layer dense (d_ff 10944) (port of
``src/repro/configs/deepseek_moe_16b.py``).  The paper's bucket dispatch
applies directly here (experts = destinations)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=102400,
    rope_theta=10000.0, rms_eps=1e-6, act="silu",
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, expert_ff=1408,
                  first_dense=1, dense_ff=10944, capacity_factor=1.25),
    uses_bucket_dispatch=True,
)
