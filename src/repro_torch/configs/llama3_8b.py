"""llama3-8b — dense GQA transformer [arXiv:2407.21783; unverified]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama3-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        activation="swiglu",
        norm="rmsnorm",
        pos="rope",
        rope_theta=500_000.0,
        source="arXiv:2407.21783",
    )
)
