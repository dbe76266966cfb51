"""minitron-4b — pruned nemotron, squared-ReLU MLP [arXiv:2407.14679; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="minitron-4b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        vocab_size=256000,
        activation="relu2_mlp",  # nemotron uses squared ReLU, ungated
        norm="layernorm",
        pos="rope",
        source="arXiv:2407.14679",
    )
)
