"""olmoe-1b-7b — 64-expert top-8 MoE [arXiv:2409.02060; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1024,  # per-expert
        vocab_size=50304,
        n_experts=64,
        experts_per_token=8,
        activation="swiglu",
        norm="rmsnorm",
        pos="rope",
        source="arXiv:2409.02060",
    )
)
