"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048
(port of ``repro/configs/musicgen_medium.py``).

A decoder-only transformer over EnCodec tokens, LayerNorm + GELU. The
EnCodec frontend is a stub: inputs are precomputed codec token ids, taken
as plain tokens; text-conditioning cross-attention is omitted.
"""

from repro_torch.models.config import ModelConfig, uniform_pattern

ARCH_ID = "musicgen-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab=2048,
        pattern=uniform_pattern("attn", "mlp"),
        norm="layernorm",
        act="gelu",
        frontend="audio_stub",
        max_seq_len=32_768,
        param_dtype="bfloat16",
        act_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=128,
        max_seq_len=64,
        param_dtype="float32",
        act_dtype="float32",
    )
