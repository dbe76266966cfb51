"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8
[arXiv:2501.kimi2; unverified, paper-table]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=2048,  # per-expert
        vocab_size=163840,
        n_experts=384,
        experts_per_token=8,
        activation="swiglu",
        norm="rmsnorm",
        pos="rope",
        rope_theta=50_000.0,
        source="arXiv:2501.kimi2 (paper-table)",
    )
)
