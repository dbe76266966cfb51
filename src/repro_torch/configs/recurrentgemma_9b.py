"""recurrentgemma-9b — RG-LRU + local attention, pattern 2:1
[arXiv:2402.19427; unverified].

Griffin layout: (recurrent, recurrent, local_attn) repeated; MQA (kv=1),
local window 2048 — sub-quadratic, so the long_500k shape runs.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        activation="geglu",
        norm="rmsnorm",
        pos="rope",
        block_pattern=("rglru", "rglru", "local_attn"),
        window=2048,
        lru_width=4096,
        tie_embeddings=True,
        source="arXiv:2402.19427",
    )
)
