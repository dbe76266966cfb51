"""pixtral-12b — a ViT frontend (stub) before the mistral-nemo decoder
[hf:mistralai/Pixtral-12B-2409; unverified].

The caller supplies precomputed patch embeddings, which ``lm.forward``
and ``lm.batch_prefill`` put before the token embeddings; the model is
the decoder below.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="pixtral-12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,  # mistral-nemo's explicit head_dim (32*128 != d_model)
        d_ff=14336,
        vocab_size=131072,
        activation="swiglu",
        norm="rmsnorm",
        pos="rope",
        rope_theta=1_000_000.0,
        frontend="vision_patches",
        frontend_tokens=256,  # one 16x16-patch image tile
        source="hf:mistralai/Pixtral-12B-2409",
    )
)
