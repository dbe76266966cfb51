"""xlstm-350m — sLSTM + mLSTM blocks, attention-free [arXiv:2405.04517;
unverified].

d_ff=0: xLSTM blocks carry their own up/down projections instead of a
separate FFN.  Constant-size matrix memory => sub-quadratic => long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        head_dim=256,
        d_ff=0,
        vocab_size=50304,
        activation="swiglu",  # used inside the mLSTM up-projection gate
        norm="layernorm",
        pos="none",
        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),  # 7:1-ish mix
        tie_embeddings=True,
        source="arXiv:2405.04517",
    )
)
