"""Model configuration: a frozen :class:`ModelConfig` per architecture,
a registry mapping ``--arch`` names to configs, and ``reduced()`` for a
tiny same-family config used by the CPU tests.

The fields, ``reduced()``, ``param_counts()`` and the benchmark shapes
(:data:`SHAPES`, :func:`applicable_shapes`) mirror the JAX package's
``repro/configs/base.py`` exactly, so a test can hold one config against
the other field by field.  Every configuration of the JAX package is
registered (:func:`get_config` imports each module).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    """One benchmark cell: (kind, seq_len, global_batch).

    ``kind`` selects the step a cell runs: ``train`` (forward, backward
    and optimizer), ``prefill`` (forward filling the KV cache) or
    ``decode`` (one new token against a ``seq_len`` cache).
    """

    name: str
    kind: str
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int  # 0 => no FFN
    vocab_size: int

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0

    # --- layer body ---
    activation: str = "swiglu"  # swiglu | geglu | gelu_mlp | relu2_mlp
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    pos: str = "rope"  # rope | learned | none
    rope_theta: float = 10_000.0

    # --- hybrid / ssm ---
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0  # local-attention window (0 => full/causal)
    lru_width: int = 0

    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500

    # --- modality frontend stub ---
    frontend: str = "none"
    frontend_tokens: int = 0

    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""  # provenance note

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"{self.name}: n_heads={self.n_heads} is not a multiple of "
                f"n_kv_heads={self.n_kv_heads}")

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def block_kind(self, layer_idx: int) -> str:
        return self.block_pattern[layer_idx % len(self.block_pattern)]

    @property
    def attention_free(self) -> bool:
        return not any(k in ("attn", "local_attn") for k in self.block_pattern)

    @property
    def subquadratic(self) -> bool:
        """True when no block attends over an unbounded full-cache span."""
        return all(k != "attn" for k in self.block_pattern)

    def param_counts(self) -> Dict[str, float]:
        """Total and active (per-token) parameter counts, as floats."""
        d = self.d_model
        qd, kvd = self.q_dim, self.kv_dim
        attn = d * qd + 2 * d * kvd + qd * d  # q, k, v, o
        if self.activation in ("swiglu", "geglu"):
            ffn_dense = 3 * d * self.d_ff
        else:
            ffn_dense = 2 * d * self.d_ff
        per_layer = {}
        for kind in set(self.block_pattern):
            if kind in ("attn", "local_attn"):
                per_layer[kind] = attn
            elif kind == "rglru":
                w = self.lru_width or d
                per_layer[kind] = 2 * d * w + 3 * w  # in/out proj + gates/decay
            elif kind == "mlstm":
                per_layer[kind] = (d * qd + 2 * d * kvd + qd * d
                                   + 3 * d * self.n_heads)
            elif kind == "slstm":
                per_layer[kind] = 4 * d * d + 4 * d
            else:
                raise ValueError(kind)
        mixer_total = sum(per_layer[self.block_kind(i)]
                          for i in range(self.n_layers))
        if self.n_experts:
            ffn_total = self.n_layers * (self.n_experts * ffn_dense
                                         + d * self.n_experts)
            ffn_active = self.n_layers * (self.experts_per_token * ffn_dense
                                          + d * self.n_experts)
        else:
            ffn_total = ffn_active = self.n_layers * ffn_dense
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.is_encoder_decoder:
            enc = self.n_encoder_layers * (attn + ffn_dense)
            mixer_total += self.n_layers * attn  # decoder cross-attention
        total = mixer_total + ffn_total + embed + enc
        active = mixer_total + ffn_active + embed + enc
        return {"total": float(total), "active": float(active)}

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests."""
        n_layers = max(2, len(self.block_pattern))
        n_kv = max(1, min(self.n_kv_heads, 2))
        group = self.n_heads // self.n_kv_heads
        n_heads = min(4, max(n_kv * min(group, 2), n_kv))
        return replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=64,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=512,
            n_experts=min(self.n_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            window=min(self.window, 32) if self.window else 0,
            lru_width=64 if self.lru_width else 0,
            n_encoder_layers=2 if self.is_encoder_decoder else 0,
            encoder_seq=16 if self.is_encoder_decoder else self.encoder_seq,
            frontend_tokens=8 if self.frontend_tokens else 0,
        )


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"config {cfg.name!r} registered twice")
    _REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded() -> None:
    from repro_torch.configs import (  # noqa: F401  (each registers)
        gemma_7b, gpt2_345m, kimi_k2, llama3_8b, minitron_4b, olmoe_1b_7b,
        pixtral_12b, recurrentgemma_9b, tinyllama_1_1b, whisper_large_v3,
        xlstm_350m)


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> Tuple[str, ...]:
    """The ``--arch`` names this package serves."""
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


ASSIGNED_ARCHS = (
    "pixtral-12b",
    "olmoe-1b-7b",
    "kimi-k2-1t-a32b",
    "minitron-4b",
    "tinyllama-1.1b",
    "gemma-7b",
    "llama3-8b",
    "recurrentgemma-9b",
    "whisper-large-v3",
    "xlstm-350m",
)


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """Which of the four shapes this arch runs (the others are skipped)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return tuple(out)
