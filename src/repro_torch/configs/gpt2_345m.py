"""gpt2-345m — the paper's own evaluation model (GPT-2 medium).

24L, d_model=1024, 16 heads, MHA, 4*d FFN, learned positions, LayerNorm,
plain GELU MLP, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gpt2-345m",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=50257,
        activation="gelu_mlp",
        norm="layernorm",
        pos="learned",
        tie_embeddings=True,
        source="paper §III-E (GPT-2 345M)",
    )
)
