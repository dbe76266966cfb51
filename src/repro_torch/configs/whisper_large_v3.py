"""whisper-large-v3 — encoder-decoder; the conv audio frontend is a stub
[arXiv:2212.04356; unverified].

The caller supplies precomputed mel-frame embeddings of shape (batch,
encoder_seq, d_model); the model is the 32-layer encoder and the
32-layer decoder with cross-attention.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-large-v3",
        family="audio",
        n_layers=32,  # decoder layers
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=51866,
        activation="gelu_mlp",
        norm="layernorm",
        pos="learned",
        is_encoder_decoder=True,
        n_encoder_layers=32,
        encoder_seq=1500,
        frontend="audio_frames",
        tie_embeddings=True,
        source="arXiv:2212.04356",
    )
)
