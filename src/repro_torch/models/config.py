"""Model configuration schema (port of ``repro/models/config.py``).

A model is a token embedding, a stack of layers, a final norm and an LM
head. Each layer is a (mixer, ffn) pair described by a :class:`LayerSpec`;
a stack is ``pattern`` repeated ``n_layers // period`` times. The port
serves the dense pattern (``attn`` + ``mlp``) and the MoE FFN
(:class:`MoEConfig`); the SSM and xLSTM config blocks (``ssm``, ``xlstm``)
are kept as opaque fields so configs keep the reference's shape, and the
model raises on them.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    group_size: int = 1024  # dispatch group size (GShard-style)
    router_jitter: float = 0.0


@dataclass(frozen=True)
class LayerSpec:
    mixer: str  # attn | mamba | mlstm | slstm | none
    ffn: str  # mlp | moe | none


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: tuple[LayerSpec, ...] = (LayerSpec("attn", "mlp"),)
    d_head: int | None = None
    moe: MoEConfig | None = None
    ssm: object | None = None
    xlstm: object | None = None
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    rope_theta: float = 10_000.0
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    attn_logit_softcap: float | None = None
    frontend: str | None = None
    frontend_tokens: int = 0
    param_dtype: str = "float32"
    act_dtype: str = "float32"
    attn_chunk: int = 1024
    attn_chunk_threshold: int = 8192
    remat: str = "block"
    scan_layers: bool = True
    prefill_mode: str = "parallel"
    vocab_pad_multiple: int = 128

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern period {len(self.pattern)}"
            )
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(f"{self.name}: n_heads must be divisible by n_kv_heads")

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def repeats(self) -> int:
        return self.n_layers // self.period

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return ((self.vocab + m - 1) // m) * m

    def layer_spec(self, i: int) -> LayerSpec:
        """The pattern entry of layer ``i`` (layer ``r * period + s`` is
        repeat ``r`` of slot ``s``)."""
        return self.pattern[i % self.period]

    def scaled(self, **updates) -> "ModelConfig":
        return replace(self, **updates)


def uniform_pattern(mixer: str = "attn", ffn: str = "mlp") -> tuple[LayerSpec, ...]:
    return (LayerSpec(mixer, ffn),)
